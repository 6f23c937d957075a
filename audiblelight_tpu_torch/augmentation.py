"""Event augmentations (counterpart of audiblelight_tpu/augmentation.py).

The reference's 27 EventAugmentation classes, with their names, parameters,
default distributions (drawn from the same streams in the same order: scipy
`rvs()` and `np.random.choice` on numpy's global stream, Python's `random()`
in the TimeWarp classes) and `to_dict` / `from_dict` schema, so either
package loads the other's JSON. The FX are the port's: the biquad filters,
the compressor and limiter, the time stretch and the pitch shift run in
torch (`ops.fx_torch`) when the augmentation's device is a card, and on the
host (`ops.fx_dsp`, numpy/scipy) when it is the CPU, as the reference's
default policy picks its JAX FX on a low-latency accelerator and numpy on
the CPU; the other FX run on the host. `device` (default `cuda`; raises
without a card when one of those FX runs) is not serialised; an Event that
a Scene made sets it to the scene's device.
"""

from __future__ import annotations

import math
from random import random
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np
from scipy import stats

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.micarrays import _compare_dicts
from audiblelight_tpu_torch.ops import fx_dsp, fx_torch


def _identity(input_array: np.ndarray, *_, **__) -> np.ndarray:
    return input_array


def _on_card(device) -> bool:
    """True when FX on `device` (default `cuda`) run in torch on a card."""
    return utils.resolve_device(device).type == "cuda"


def _biquad(x, kind, sr, freq, q=0.7071, gain_db=0.0, device=None):
    if _on_card(device):
        b, a = fx_dsp._biquad_coeffs(kind, sr, freq, q, gain_db)
        return fx_torch.biquad(x, b, a, device=device)
    return fx_dsp.biquad(x, kind, sr, freq, q, gain_db)


def _compress(x, sr, threshold_db, ratio, attack_ms, release_ms, device=None):
    if _on_card(device):
        return fx_torch.compress(x, sr, threshold_db, ratio, attack_ms, release_ms, device=device)
    return fx_dsp.compress(x, sr, threshold_db, ratio, attack_ms, release_ms)


def _limit(x, sr, threshold_db, release_ms, device=None):
    """fx_dsp.limit with its compressor on `device`."""
    out = _compress(x, sr, threshold_db, 1000.0, 0.5, release_ms, device)
    ceiling = 10 ** (threshold_db / 20.0)
    return np.clip(out, -ceiling, ceiling)


def _time_stretch(x, rate, device=None):
    return fx_torch.time_stretch(x, rate, device=device) if _on_card(device) else fx_dsp.time_stretch(x, rate)


def _pitch_shift(x, sr, semitones, device=None):
    return (fx_torch.pitch_shift(x, sr, semitones, device=device) if _on_card(device)
            else fx_dsp.pitch_shift(x, sr, semitones))


class Augmentation:
    """Base class for all augmentation objects.

    Child classes set `self.fx` (a callable or list of callables taking
    (audio, sample_rate=..., buffer_size=..., reset=...)) and `self.params`
    (the serialisable argument dictionary). `device` is where the torch FX
    run (default `cuda`).
    """

    def __init__(self, sample_rate: Optional[utils.Numeric] = config.SAMPLE_RATE, device=None):
        self.sample_rate = utils.sanitise_positive_number(sample_rate, cast_to=int)
        self.device = device
        self.fx: Union[Callable, list[Callable]] = _identity
        self.params = dict()

    @staticmethod
    def sample_value(
        override: Any,
        default_dist: Any,
    ) -> utils.Numeric:
        """Override-or-distribution sampling.

        None -> sample the default distribution; numeric -> use as-is;
        distribution-like -> sample it.
        """
        if override is None:
            return utils.sanitise_distribution(default_dist).rvs()
        if isinstance(override, utils.NUMERIC_DTYPES):
            return override
        try:
            return utils.sanitise_distribution(override).rvs()
        except TypeError:
            raise TypeError(f"Cannot handle type {type(override)}")

    def process(self, input_array: np.ndarray) -> np.ndarray:
        """Run the FX chain, then wrap-pad/truncate back to the input length."""
        out = input_array.copy()
        for fx in self.fx if isinstance(self.fx, list) else [self.fx]:
            out = fx(out, sample_rate=self.sample_rate, buffer_size=config.BUFFER_SIZE, reset=True)

        if out.ndim == 1:
            out = np.expand_dims(out, 0)
        trunc = utils.pad_or_truncate_audio(out, max(input_array.shape), pad_mode="wrap")
        return trunc if input_array.ndim == 2 else trunc[0, :]

    def __call__(self, input_array: np.ndarray) -> np.ndarray:
        return self.process(input_array)

    def __repr__(self) -> str:
        return utils.repr_as_json(self)

    def __str__(self) -> str:
        combined = ", ".join(f"{k}: {v}" for k, v in self.params.items())
        return f"Augmentation '{self.name}' with parameters {combined}"

    def __len__(self) -> int:
        return 1 if not isinstance(self.fx, list) else len(self.fx)

    def __iter__(self) -> Iterator[Callable]:
        yield from (self.fx if isinstance(self.fx, list) else [self.fx])

    def to_dict(self) -> dict:
        """Parameters used by this augmentation, keyed for `from_dict`."""
        return dict(name=self.name, sample_rate=self.sample_rate, **self.params)

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any], device=None) -> "Augmentation":
        """Instantiate the named child class from a parameter dictionary, its
        FX on `device`."""
        if "name" not in input_dict:
            raise KeyError("Augmentation name must be specified in dictionary")
        augment_name = input_dict["name"]
        try:
            augment_cls = globals()[augment_name]
        except KeyError:
            raise KeyError(f"Augmentation class {augment_name} not found")
        input_dict = dict(input_dict)
        input_dict.pop("name")
        utils.validate_kwargs(augment_cls.__init__, **input_dict)
        return augment_cls(**input_dict, device=device)

    def __eq__(self, other: Any) -> bool:
        if not issubclass(type(other), Augmentation):
            return False
        return _compare_dicts(self.to_dict(), other.to_dict())

    @property
    def name(self) -> str:
        return type(self).__name__


class EventAugmentation(Augmentation):
    """Base class for augmentations applied to Events."""

    AUGMENTATION_TYPE = "event"


class SceneAugmentation(Augmentation):
    """Base class for augmentations applied to whole Scenes."""

    AUGMENTATION_TYPE = "scene"


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------


class LowpassFilter(EventAugmentation):
    """Low-pass filter; cutoff sampled between 5512 and 22050 Hz by default."""

    MIN_FREQ, MAX_FREQ = 5512, 22050

    def __init__(self, sample_rate=config.SAMPLE_RATE, cutoff_frequency_hz=None, device=None):
        super().__init__(sample_rate, device)
        self.cutoff_frequency_hz = utils.sanitise_positive_number(
            self.sample_value(
                cutoff_frequency_hz,
                stats.uniform(self.MIN_FREQ, self.MAX_FREQ - self.MIN_FREQ),
            )
        )
        self.params = dict(cutoff_frequency_hz=self.cutoff_frequency_hz)
        self.fx = lambda x, **_: _biquad(x, "lowpass", self.sample_rate, self.cutoff_frequency_hz, device=self.device)


class HighpassFilter(EventAugmentation):
    """High-pass filter; cutoff sampled between 32 and 1024 Hz by default."""

    MIN_FREQ, MAX_FREQ = 32, 1024

    def __init__(self, sample_rate=config.SAMPLE_RATE, cutoff_frequency_hz=None, device=None):
        super().__init__(sample_rate, device)
        self.cutoff_frequency_hz = utils.sanitise_positive_number(
            self.sample_value(
                cutoff_frequency_hz,
                stats.uniform(self.MIN_FREQ, self.MAX_FREQ - self.MIN_FREQ),
            )
        )
        self.params = dict(cutoff_frequency_hz=self.cutoff_frequency_hz)
        self.fx = lambda x, **_: _biquad(x, "highpass", self.sample_rate, self.cutoff_frequency_hz, device=self.device)


class HighShelfFilter(EventAugmentation):
    """High-shelf filter with variable cutoff, gain (dB), and Q."""

    MIN_FREQ, MAX_FREQ = 5512, 22050
    MIN_GAIN, MAX_GAIN = -20, 10
    MIN_Q, MAX_Q = 0.1, 1.0

    def __init__(self, sample_rate=config.SAMPLE_RATE, gain_db=None, cutoff_frequency_hz=None, q=None, device=None):
        super().__init__(sample_rate, device)
        self.cutoff_frequency_hz = utils.sanitise_positive_number(
            self.sample_value(
                cutoff_frequency_hz, stats.uniform(self.MIN_FREQ, self.MAX_FREQ - self.MIN_FREQ)
            )
        )
        self.gain_db = self.sample_value(gain_db, stats.uniform(self.MIN_GAIN, self.MAX_GAIN - self.MIN_GAIN))
        self.q = utils.sanitise_positive_number(
            self.sample_value(q, stats.uniform(self.MIN_Q, self.MAX_Q - self.MIN_Q))
        )
        self.params = dict(cutoff_frequency_hz=self.cutoff_frequency_hz, gain_db=self.gain_db, q=self.q)
        self.fx = lambda x, **_: _biquad(
            x, "highshelf", self.sample_rate, self.cutoff_frequency_hz, self.q, self.gain_db, self.device
        )


class LowShelfFilter(EventAugmentation):
    """Low-shelf filter with variable cutoff, gain (dB), and Q."""

    MIN_FREQ, MAX_FREQ = 32, 1024
    MIN_GAIN, MAX_GAIN = -20, 10
    MIN_Q, MAX_Q = 0.1, 1.0

    def __init__(self, sample_rate=config.SAMPLE_RATE, gain_db=None, cutoff_frequency_hz=None, q=None, device=None):
        super().__init__(sample_rate, device)
        self.cutoff_frequency_hz = utils.sanitise_positive_number(
            self.sample_value(
                cutoff_frequency_hz, stats.uniform(self.MIN_FREQ, self.MAX_FREQ - self.MIN_FREQ)
            )
        )
        self.gain_db = self.sample_value(gain_db, stats.uniform(self.MIN_GAIN, self.MAX_GAIN - self.MIN_GAIN))
        self.q = utils.sanitise_positive_number(
            self.sample_value(q, stats.uniform(self.MIN_Q, self.MAX_Q - self.MIN_Q))
        )
        self.params = dict(cutoff_frequency_hz=self.cutoff_frequency_hz, gain_db=self.gain_db, q=self.q)
        self.fx = lambda x, **_: _biquad(
            x, "lowshelf", self.sample_rate, self.cutoff_frequency_hz, self.q, self.gain_db, self.device
        )


class MultibandEqualizer(EventAugmentation):
    """N-band parametric EQ: a cascade of peak filters with per-band parameters."""

    MIN_BANDS, MAX_BANDS = 1, 8
    MIN_GAIN, MAX_GAIN = -20, 10
    MIN_FREQ, MAX_FREQ = 1024, 22050
    MIN_Q, MAX_Q = 0.1, 1.0

    def __init__(self, sample_rate=config.SAMPLE_RATE, n_bands=None, gain_db=None, cutoff_frequency_hz=None, q=None, device=None):
        super().__init__(sample_rate, device)
        self.n_bands = utils.sanitise_positive_number(
            self.sample_value(n_bands, stats.uniform(self.MIN_BANDS, self.MAX_BANDS - self.MIN_BANDS)),
            cast_to=int,
        )
        self.gain_db = self.sample_peak_filter_params(
            gain_db, stats.uniform(self.MIN_GAIN, self.MAX_GAIN - self.MIN_GAIN)
        )
        self.cutoff_frequency_hz = self.sample_peak_filter_params(
            cutoff_frequency_hz, stats.uniform(self.MIN_FREQ, self.MAX_FREQ - self.MIN_FREQ)
        )
        self.q = self.sample_peak_filter_params(q, stats.uniform(self.MIN_Q, self.MAX_Q - self.MIN_Q))
        self.params = dict(
            n_bands=self.n_bands,
            gain_db=self.gain_db,
            cutoff_frequency_hz=self.cutoff_frequency_hz,
            q=self.q,
        )
        self.fx = [
            (lambda g, f, q_: lambda x, **_: _biquad(x, "peak", self.sample_rate, f, q_, g, self.device))(
                g, f, q_
            )
            for g, f, q_ in zip(self.gain_db, self.cutoff_frequency_hz, self.q)
        ]

    def sample_peak_filter_params(self, override, default_dist) -> list:
        """Sample per-band parameter lists (N values from override or default)."""
        if override is None:
            dist = utils.sanitise_distribution(default_dist)
            return [dist.rvs() for _ in range(self.n_bands)]
        if isinstance(override, (list, np.ndarray)):
            if len(override) != self.n_bands:
                raise ValueError(f"Expected {self.n_bands} values but got {len(override)}")
            return list(override)
        if isinstance(override, utils.NUMERIC_DTYPES):
            return [override] * self.n_bands
        try:
            dist = utils.sanitise_distribution(override)
            return [dist.rvs() for _ in range(self.n_bands)]
        except TypeError:
            raise TypeError(f"Cannot handle type {type(override)}")


# ---------------------------------------------------------------------------
# Dynamics and saturation
# ---------------------------------------------------------------------------


class Compressor(EventAugmentation):
    """Dynamic range compressor (UREI-1176-inspired defaults)."""

    RATIOS = [4, 8, 12, 20]
    MIN_THRESHOLD_DB, MAX_THRESHOLD_DB = -40, -20
    MIN_ATTACK, MAX_ATTACK = 1, 100
    MIN_RELEASE, MAX_RELEASE = 50, 1100

    def __init__(
        self,
        sample_rate=config.SAMPLE_RATE,
        threshold_db=None,
        ratio=None,
        attack_ms=None,
        release_ms=None,
        device=None,
    ):
        super().__init__(sample_rate, device)
        self.threshold_db = -utils.sanitise_positive_number(
            abs(
                self.sample_value(
                    threshold_db,
                    stats.uniform(self.MIN_THRESHOLD_DB, abs(self.MAX_THRESHOLD_DB)),
                )
            )
        )
        self.ratio = self.sample_value(ratio, lambda: float(np.random.choice(self.RATIOS)))
        self.attack_ms = utils.sanitise_positive_number(
            self.sample_value(attack_ms, stats.uniform(self.MIN_ATTACK, self.MAX_ATTACK - self.MIN_ATTACK))
        )
        self.release_ms = utils.sanitise_positive_number(
            self.sample_value(release_ms, stats.uniform(self.MIN_RELEASE, self.MAX_RELEASE - self.MIN_RELEASE))
        )
        self.params = dict(
            threshold_db=self.threshold_db,
            ratio=self.ratio,
            attack_ms=self.attack_ms,
            release_ms=self.release_ms,
        )
        self.fx = lambda x, **_: _compress(
            x, self.sample_rate, self.threshold_db, self.ratio, self.attack_ms, self.release_ms, self.device
        )


class Limiter(EventAugmentation):
    """Limiter: fast-attack, near-infinite-ratio compression at a threshold."""

    MIN_THRESHOLD_DB, MAX_THRESHOLD_DB = -40, -20
    MIN_RELEASE, MAX_RELEASE = 50, 1100

    def __init__(self, sample_rate=config.SAMPLE_RATE, threshold_db=None, release_ms=None, device=None):
        super().__init__(sample_rate, device)
        self.threshold_db = -utils.sanitise_positive_number(
            abs(
                self.sample_value(
                    threshold_db, stats.uniform(self.MIN_THRESHOLD_DB, abs(self.MAX_THRESHOLD_DB))
                )
            )
        )
        self.release_ms = utils.sanitise_positive_number(
            self.sample_value(release_ms, stats.uniform(self.MIN_RELEASE, self.MAX_RELEASE - self.MIN_RELEASE))
        )
        self.params = dict(threshold_db=self.threshold_db, release_ms=self.release_ms)
        self.fx = lambda x, **_: _limit(x, self.sample_rate, self.threshold_db, self.release_ms, self.device)


class Clipping(EventAugmentation):
    """Hard clipping at a dB threshold (sampled between -10 and -1 dB)."""

    MIN_THRESHOLD_DB, MAX_THRESHOLD_DB = -10, -1

    def __init__(self, sample_rate=config.SAMPLE_RATE, threshold_db=None, device=None):
        super().__init__(sample_rate, device)
        # Reference-parity note (reference augmentation.py:858): the reference
        # samples stats.uniform(MIN, abs(MAX)) whose support is [-10, -9] dB —
        # NOT the documented [-10, -1] — because the loc+scale trick only
        # covers the range when MIN == 2*MAX. The sampling distribution is
        # part of the dataset-generation contract, so the quirk is replicated
        # verbatim rather than "fixed" into a different random stream.
        self.threshold_db = -utils.sanitise_positive_number(
            abs(
                self.sample_value(
                    threshold_db, stats.uniform(self.MIN_THRESHOLD_DB, abs(self.MAX_THRESHOLD_DB))
                )
            )
        )
        self.params = dict(threshold_db=self.threshold_db)
        self.fx = lambda x, **_: fx_dsp.clip_db(x, self.threshold_db)


class Distortion(EventAugmentation):
    """tanh-waveshaping distortion with drive sampled between 10 and 30 dB."""

    MIN_DRIVE, MAX_DRIVE = 10, 30

    def __init__(self, sample_rate=config.SAMPLE_RATE, drive_db=None, device=None):
        super().__init__(sample_rate, device)
        self.drive_db = utils.sanitise_positive_number(
            self.sample_value(drive_db, stats.uniform(self.MIN_DRIVE, self.MAX_DRIVE - self.MIN_DRIVE))
        )
        self.params = dict(drive_db=self.drive_db)
        self.fx = lambda x, **_: fx_dsp.distort(x, self.drive_db)


class Bitcrush(EventAugmentation):
    """Quantizes samples to a bit depth sampled between 8 and 32 bits."""

    MIN_DEPTH, MAX_DEPTH = 8, 32

    def __init__(self, sample_rate=config.SAMPLE_RATE, bit_depth=None, device=None):
        super().__init__(sample_rate, device)
        self.bit_depth = utils.sanitise_positive_number(
            self.sample_value(bit_depth, stats.uniform(self.MIN_DEPTH, self.MAX_DEPTH - self.MIN_DEPTH))
        )
        self.params = dict(bit_depth=self.bit_depth)
        self.fx = lambda x, **_: fx_dsp.bitcrush(x, self.bit_depth)


class Gain(EventAugmentation):
    """Scalar gain sampled between -10 and +10 dB."""

    MIN_GAIN, MAX_GAIN = -10, 10

    def __init__(self, sample_rate=config.SAMPLE_RATE, gain_db=None, device=None):
        super().__init__(sample_rate, device)
        self.gain_db = self.sample_value(gain_db, stats.uniform(self.MIN_GAIN, self.MAX_GAIN - self.MIN_GAIN))
        self.params = dict(gain_db=self.gain_db)
        self.fx = lambda x, **_: fx_dsp.gain(x, self.gain_db)


# ---------------------------------------------------------------------------
# Modulation
# ---------------------------------------------------------------------------


class Chorus(EventAugmentation):
    """LFO-modulated delay chorus (rate, depth, centre delay, feedback, mix)."""

    MIN_RATE, MAX_RATE = 0, 10
    MIN_DEPTH, MAX_DEPTH = 0.0, 1.0
    MIN_DELAY, MAX_DELAY = 1.0, 20.0
    MIN_MIX, MAX_MIX = 0.1, 0.5
    MIN_FEEDBACK, MAX_FEEDBACK = 0.0, 0.9

    def __init__(
        self,
        sample_rate=config.SAMPLE_RATE,
        rate_hz=None,
        depth=None,
        centre_delay_ms=None,
        feedback=None,
        mix=None,
        device=None,
    ):
        super().__init__(sample_rate, device)
        self.rate_hz = utils.sanitise_positive_number(
            self.sample_value(rate_hz, stats.uniform(self.MIN_RATE, self.MAX_RATE - self.MIN_RATE))
        )
        self.depth = utils.sanitise_positive_number(
            self.sample_value(depth, stats.uniform(self.MIN_DEPTH, self.MAX_DEPTH - self.MIN_DEPTH))
        )
        self.centre_delay_ms = utils.sanitise_positive_number(
            self.sample_value(centre_delay_ms, stats.uniform(self.MIN_DELAY, self.MAX_DELAY - self.MIN_DELAY))
        )
        self.feedback = utils.sanitise_positive_number(
            self.sample_value(feedback, stats.uniform(self.MIN_FEEDBACK, self.MAX_FEEDBACK - self.MIN_FEEDBACK))
        )
        self.mix = utils.sanitise_positive_number(
            self.sample_value(mix, stats.uniform(self.MIN_MIX, self.MAX_MIX - self.MIN_MIX))
        )
        self.params = dict(
            rate_hz=self.rate_hz,
            depth=self.depth,
            centre_delay_ms=self.centre_delay_ms,
            feedback=self.feedback,
            mix=self.mix,
        )
        self.fx = lambda x, **_: fx_dsp.chorus(
            x, self.sample_rate, self.rate_hz, self.depth, self.centre_delay_ms, self.feedback, self.mix
        )


class Phaser(EventAugmentation):
    """Swept-allpass phaser (rate, depth, centre frequency, feedback, mix)."""

    MIN_RATE, MAX_RATE = 0, 10
    MIN_DEPTH, MAX_DEPTH = 0.0, 1.0
    MIN_FREQ, MAX_FREQ = 260, 6500
    MIN_MIX, MAX_MIX = 0.1, 0.5
    MIN_FEEDBACK, MAX_FEEDBACK = 0.0, 0.9

    def __init__(
        self,
        sample_rate=config.SAMPLE_RATE,
        rate_hz=None,
        depth=None,
        centre_frequency_hz=None,
        feedback=None,
        mix=None,
        device=None,
    ):
        super().__init__(sample_rate, device)
        self.rate_hz = utils.sanitise_positive_number(
            self.sample_value(rate_hz, stats.uniform(self.MIN_RATE, self.MAX_RATE - self.MIN_RATE))
        )
        self.depth = utils.sanitise_positive_number(
            self.sample_value(depth, stats.uniform(self.MIN_DEPTH, self.MAX_DEPTH - self.MIN_DEPTH))
        )
        self.centre_frequency_hz = utils.sanitise_positive_number(
            self.sample_value(
                centre_frequency_hz, stats.uniform(self.MIN_FREQ, self.MAX_FREQ - self.MIN_FREQ)
            )
        )
        self.feedback = utils.sanitise_positive_number(
            self.sample_value(feedback, stats.uniform(self.MIN_FEEDBACK, self.MAX_FEEDBACK - self.MIN_FEEDBACK))
        )
        self.mix = utils.sanitise_positive_number(
            self.sample_value(mix, stats.uniform(self.MIN_MIX, self.MAX_MIX - self.MIN_MIX))
        )
        self.params = dict(
            rate_hz=self.rate_hz,
            depth=self.depth,
            centre_frequency_hz=self.centre_frequency_hz,
            feedback=self.feedback,
            mix=self.mix,
        )
        self.fx = lambda x, **_: fx_dsp.phaser(
            x,
            self.sample_rate,
            self.rate_hz,
            self.depth,
            self.centre_frequency_hz,
            self.feedback,
            self.mix,
        )


class Delay(EventAugmentation):
    """Feedback delay (delay time in seconds, feedback, mix)."""

    MIN_DELAY, MAX_DELAY = 0.01, 1.0
    MIN_FEEDBACK, MAX_FEEDBACK = 0.1, 0.5
    MIN_MIX, MAX_MIX = 0.1, 0.5

    def __init__(self, sample_rate=config.SAMPLE_RATE, delay_seconds=None, feedback=None, mix=None, device=None):
        super().__init__(sample_rate, device)
        self.delay_seconds = utils.sanitise_positive_number(
            self.sample_value(delay_seconds, stats.uniform(self.MIN_DELAY, self.MAX_DELAY - self.MIN_DELAY))
        )
        self.feedback = utils.sanitise_positive_number(
            self.sample_value(feedback, stats.uniform(self.MIN_FEEDBACK, self.MAX_FEEDBACK - self.MIN_FEEDBACK))
        )
        self.mix = utils.sanitise_positive_number(
            self.sample_value(mix, stats.uniform(self.MIN_MIX, self.MAX_MIX - self.MIN_MIX))
        )
        self.params = dict(delay_seconds=self.delay_seconds, feedback=self.feedback, mix=self.mix)
        self.fx = lambda x, **_: fx_dsp.delay_fx(
            x, self.sample_rate, self.delay_seconds, self.feedback, self.mix
        )


# ---------------------------------------------------------------------------
# Codec emulations
# ---------------------------------------------------------------------------


class GSMFullRateCompressor(EventAugmentation):
    """GSM full-rate (2G call) artifact emulation; quality in 0..3."""

    QUALITIES = range(4)

    def __init__(self, sample_rate=config.SAMPLE_RATE, quality=None, device=None):
        super().__init__(sample_rate, device)
        self.quality = int(
            utils.sanitise_positive_number(
                self.sample_value(quality, lambda: int(np.random.choice(self.QUALITIES)))
            )
        )
        self.params = dict(quality=self.quality)
        self.fx = lambda x, **_: fx_dsp.gsm_fullrate(x, self.sample_rate, self.quality)


class MP3Compressor(EventAugmentation):
    """MP3 (VBR) compression-artifact emulation; vbr_quality 2 (good) .. 10 (bad)."""

    VBR_MIN, VBR_MAX = 2.001, 9.999
    SUPPORTED_SAMPLE_RATES = [8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000]

    def __init__(self, sample_rate=config.SAMPLE_RATE, vbr_quality=None, device=None):
        super().__init__(sample_rate, device)
        if self.sample_rate not in self.SUPPORTED_SAMPLE_RATES:
            supporteds = " Hz, ".join(str(i) for i in self.SUPPORTED_SAMPLE_RATES)
            raise ValueError(
                f"Expected sample rate to be one of {supporteds}, but got {self.sample_rate}"
            )
        self.vbr_quality = utils.sanitise_positive_number(
            self.sample_value(vbr_quality, stats.uniform(self.VBR_MIN, self.VBR_MAX - self.VBR_MIN))
        )
        self.params = dict(vbr_quality=self.vbr_quality)
        self.fx = lambda x, **_: fx_dsp.mp3_artifacts(x, self.sample_rate, self.vbr_quality)


# ---------------------------------------------------------------------------
# Time / pitch
# ---------------------------------------------------------------------------


class PitchShift(EventAugmentation):
    """Pitch shift by +/- 3 semitones (phase vocoder + resample)."""

    MIN_SEMITONES, MAX_SEMITONES = -3, 3

    def __init__(self, sample_rate=config.SAMPLE_RATE, semitones=None, device=None):
        super().__init__(sample_rate, device)
        self.semitones = int(
            self.sample_value(
                semitones, stats.uniform(self.MIN_SEMITONES, self.MAX_SEMITONES - self.MIN_SEMITONES)
            )
        )
        self.params = dict(semitones=self.semitones)
        self.fx = lambda x, **_: _pitch_shift(x, self.sample_rate, self.semitones, self.device)

    def process(self, input_array: np.ndarray) -> np.ndarray:
        if self.semitones == 0:
            return input_array
        return super().process(input_array)


class SpeedUp(EventAugmentation):
    """Time stretch (speed change without pitch change); factor 0.7 .. 1.5."""

    MIN_SHIFT, MAX_SHIFT = 0.7, 1.5

    def __init__(self, sample_rate=config.SAMPLE_RATE, stretch_factor=None, device=None):
        super().__init__(sample_rate, device)
        self.stretch_factor = utils.sanitise_positive_number(
            self.sample_value(stretch_factor, stats.uniform(self.MIN_SHIFT, self.MAX_SHIFT - self.MIN_SHIFT))
        )
        self.params = dict(stretch_factor=self.stretch_factor)
        self.fx = lambda x, **_: _time_stretch(x, self.stretch_factor, self.device)

    def process(self, input_array: np.ndarray) -> np.ndarray:
        if self.stretch_factor == 1.0:
            return input_array
        return super().process(input_array)


# ---------------------------------------------------------------------------
# Emphasis
# ---------------------------------------------------------------------------


class Preemphasis(EventAugmentation):
    """First-order pre-emphasis: y[n] = x[n] - coef * x[n-1]."""

    MIN_COEF, MAX_COEF = 0.0, 1.0

    def __init__(self, sample_rate=config.SAMPLE_RATE, coef=None, device=None):
        super().__init__(sample_rate, device)
        self.coef = utils.sanitise_positive_number(
            self.sample_value(coef, stats.uniform(self.MIN_COEF, self.MAX_COEF - self.MIN_COEF))
        )
        self.params = dict(coef=self.coef)
        self.fx = self._apply_fx

    def _apply_fx(self, input_audio: np.ndarray, *_, **__) -> np.ndarray:
        from scipy.signal import lfilter

        return lfilter([1.0, -self.coef], [1.0], input_audio, axis=-1).astype(
            input_audio.dtype, copy=False
        )


class Deemphasis(Preemphasis):
    """Inverse of Preemphasis: y[n] = x[n] + coef * y[n-1]."""

    def _apply_fx(self, input_audio: np.ndarray, *_, **__) -> np.ndarray:
        from scipy.signal import lfilter

        return lfilter([1.0], [1.0, -self.coef], input_audio, axis=-1).astype(
            input_audio.dtype, copy=False
        )


# ---------------------------------------------------------------------------
# Amplitude envelopes / simple transforms
# ---------------------------------------------------------------------------


class Fade(EventAugmentation):
    """Fade-in / fade-out with 5 shape options per end (+ "none")."""

    MIN_FADE, MAX_FADE = 0.0, 1.0  # seconds
    FADE_SHAPES = ["linear", "exponential", "logarithmic", "quarter_sine", "half_sine", "none"]

    def __init__(
        self,
        sample_rate=config.SAMPLE_RATE,
        fade_in_len=None,
        fade_out_len=None,
        fade_in_shape=None,
        fade_out_shape=None,
        device=None,
    ):
        super().__init__(sample_rate, device)
        self.fade_in_len = utils.sanitise_positive_number(
            self.sample_value(fade_in_len, stats.uniform(self.MIN_FADE, self.MAX_FADE - self.MIN_FADE))
        )
        self.fade_out_len = utils.sanitise_positive_number(
            self.sample_value(fade_out_len, stats.uniform(self.MIN_FADE, self.MAX_FADE - self.MIN_FADE))
        )
        self.fade_in_shape = self._sample_fade_shape(fade_in_shape)
        self.fade_out_shape = self._sample_fade_shape(fade_out_shape)
        self.fx = self._apply_fx
        self.params = dict(
            fade_in_len=self.fade_in_len,
            fade_out_len=self.fade_out_len,
            fade_in_shape=self.fade_in_shape,
            fade_out_shape=self.fade_out_shape,
        )

    def _sample_fade_shape(self, given_shape: Optional[str] = None) -> str:
        if given_shape is None:
            given_shape = str(np.random.choice(self.FADE_SHAPES))
        if given_shape not in self.FADE_SHAPES:
            raise ValueError(
                f"Expected `shape` to be one of {', '.join(self.FADE_SHAPES)} but got {given_shape}"
            )
        return given_shape

    @staticmethod
    def _shape_curve(fade: np.ndarray, shape: str, direction: str) -> np.ndarray:
        if direction == "in":
            if shape == "linear":
                return fade
            if shape == "exponential":
                return np.power(2, (fade - 1)) * fade
            if shape == "logarithmic":
                return np.log10(0.1 + fade) + 1
            if shape == "quarter_sine":
                return np.sin(fade * math.pi / 2)
            if shape == "half_sine":
                return np.sin(fade * math.pi - math.pi / 2) / 2 + 0.5
        else:
            if shape == "linear":
                return 1 - fade
            if shape == "exponential":
                return np.power(2, -fade) * (1 - fade)
            if shape == "logarithmic":
                return np.log10(1.1 - fade) + 1
            if shape == "quarter_sine":
                return np.sin(fade * math.pi / 2 + math.pi / 2)
            if shape == "half_sine":
                return np.sin(fade * math.pi + math.pi / 2) / 2 + 0.5
        return fade

    def _apply_fx(self, input_audio: np.ndarray, *_, **__) -> np.ndarray:
        n = input_audio.shape[-1]
        n_in = min(int(round(self.fade_in_len * self.sample_rate)), n)
        n_out = min(int(round(self.fade_out_len * self.sample_rate)), n)

        fade_in = np.ones(n)
        if n_in > 0 and self.fade_in_shape != "none":
            curve = self._shape_curve(np.linspace(0, 1, n_in), self.fade_in_shape, "in")
            fade_in = np.clip(np.concatenate([curve, np.ones(n - n_in)]), 0, 1)
        fade_out = np.ones(n)
        if n_out > 0 and self.fade_out_shape != "none":
            curve = self._shape_curve(np.linspace(0, 1, n_out), self.fade_out_shape, "out")
            fade_out = np.clip(np.concatenate([np.ones(n - n_out), curve]), 0, 1)

        fade = (fade_in * fade_out).reshape((1,) * (input_audio.ndim - 1) + (-1,))
        return input_audio * fade


class Invert(EventAugmentation):
    """Phase inversion: y[n] = -x[n]."""

    def __init__(self, sample_rate=config.SAMPLE_RATE, device=None):
        super().__init__(sample_rate, device)
        self.fx = lambda x, **_: np.negative(x)
        self.params = dict()


class Reverse(EventAugmentation):
    """Time reversal along the sample axis."""

    def __init__(self, sample_rate=config.SAMPLE_RATE, device=None):
        super().__init__(sample_rate, device)
        self.fx = lambda x, **_: np.flip(x, axis=-1)
        self.params = dict()


# ---------------------------------------------------------------------------
# Time warping (DJ-style frame FX)
# ---------------------------------------------------------------------------


class TimeWarp(EventAugmentation):
    """Parent for frame-level time-warp FX (silence/duplicate/remove/reverse)."""

    MIN_PROB, MAX_PROB = 0.05, 0.15
    MIN_FPS, MAX_FPS = 2, 10.0

    def __init__(self, sample_rate=config.SAMPLE_RATE, fps=None, prob=None, device=None):
        super().__init__(sample_rate, device)
        self.fps = utils.sanitise_positive_number(
            self.sample_value(fps, stats.uniform(self.MIN_FPS, self.MAX_FPS - self.MIN_FPS))
        )
        if self.fps == 0.0:
            raise ValueError(f"Expected fps to be greater than 0 but got {fps}")
        self.prob = utils.sanitise_positive_number(
            self.sample_value(prob, stats.uniform(self.MIN_PROB, self.MAX_PROB - self.MIN_PROB))
        )
        self.fx = self._apply_fx
        self.params = dict(fps=self.fps, prob=self.prob)

    def _timewarp(self, sliced_audio_frames) -> list[np.ndarray]:
        return list(sliced_audio_frames)

    def _apply_fx(self, input_audio: np.ndarray, *_, **__) -> np.ndarray:
        if self.prob == 0:
            return input_audio
        fl = round(self.sample_rate / self.fps)
        n = input_audio.shape[-1]
        if fl > max(input_audio.shape):
            sliced = [input_audio]
        else:
            n_frames = n // fl
            sliced = [input_audio[..., i * fl : (i + 1) * fl] for i in range(n_frames)]
        combframes = self._timewarp(sliced)
        try:
            return np.concatenate(combframes, axis=-1)
        except ValueError:
            return input_audio


class TimeWarpSilence(TimeWarp):
    """Randomly silences frames with probability `prob`."""

    def _timewarp(self, sliced_audio_frames) -> list[np.ndarray]:
        out = []
        for frame in sliced_audio_frames:
            if random() < self.prob:
                frame = np.zeros_like(frame)
            out.append(frame)
        return out


class TimeWarpDuplicate(TimeWarp):
    """Randomly duplicates frames with probability `prob`."""

    def _timewarp(self, sliced_audio_frames) -> list[np.ndarray]:
        out = []
        for frame in sliced_audio_frames:
            if random() < self.prob:
                out.append(frame)
            out.append(frame)
        return out


class TimeWarpRemove(TimeWarp):
    """Randomly removes frames with probability `prob`."""

    def _timewarp(self, sliced_audio_frames) -> list[np.ndarray]:
        out = []
        for frame in sliced_audio_frames:
            if random() < self.prob:
                continue
            out.append(frame)
        return out


class TimeWarpReverse(TimeWarp):
    """Randomly reverses frames with probability `prob`."""

    def _timewarp(self, sliced_audio_frames) -> list[np.ndarray]:
        out = []
        for frame in sliced_audio_frames:
            if random() < self.prob:
                frame = np.flip(frame, axis=-1)
            out.append(frame)
        return out


# All augmentations that can be applied to Event objects
ALL_EVENT_AUGMENTATIONS = [
    LowpassFilter,
    HighpassFilter,
    MultibandEqualizer,
    Compressor,
    Chorus,
    Delay,
    Distortion,
    Phaser,
    Gain,
    GSMFullRateCompressor,
    MP3Compressor,
    PitchShift,
    SpeedUp,
    TimeWarpRemove,
    TimeWarpSilence,
    TimeWarpDuplicate,
    TimeWarpReverse,
    Preemphasis,
    Deemphasis,
    Fade,
    Clipping,
    Bitcrush,
    Limiter,
    HighShelfFilter,
    LowShelfFilter,
    Invert,
    Reverse,
]


def validate_event_augmentation(augmentation_obj: Any) -> None:
    """Validate an augmentation instance for use with an Event.

    Must be a callable *instance* of an EventAugmentation subclass exposing
    `fx`, `params`, and AUGMENTATION_TYPE == "event".
    """
    if not callable(augmentation_obj):
        raise ValueError("Augmentation object must be callable")
    if isinstance(augmentation_obj, type):
        raise ValueError("Augmentation object must be an instance of a class, not the class itself")
    if not issubclass(type(augmentation_obj), EventAugmentation):
        raise ValueError(
            "Augmentation object must be a subclass of `audiblelight_tpu_torch.augmentation.EventAugmentation`"
        )
    for attr in ["fx", "AUGMENTATION_TYPE", "params"]:
        if not hasattr(augmentation_obj, attr):
            raise AttributeError(f"Augmentation object must have '{attr}' attribute")
    if getattr(augmentation_obj, "AUGMENTATION_TYPE", "") != "event":
        raise ValueError(
            f"Augmentation type must be 'event', but got "
            f"'{getattr(augmentation_obj, 'AUGMENTATION_TYPE', '')}'"
        )
