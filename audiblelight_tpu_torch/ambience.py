"""Background ambience of a Scene: colored noise or a looped audio file.

Copy of audiblelight_tpu/ambience.py: noise beds ("gaussian", the colour
names, or a numeric power-law exponent) and file beds (an audio file tiled
over the channels and the duration). The fused renderer draws a "gaussian"
bed on the card (render.ambience_bed_device); the plan path makes every
other bed on the host (`Ambience.load_ambience`), with the reference's
numpy and Python `random` draws, so the same streams give the same bed bit
for bit.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Any, Iterable, Optional, Union

import numpy as np

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.io.audio import load_audio, valid_audio
from audiblelight_tpu_torch.micarrays import _compare_dicts
from audiblelight_tpu_torch.utils import logger

# Map of colour names to beta exponents; higher beta = more low-frequency energy
NOISE_MAPPING = dict(pink=1, brown=2, red=2, blue=-1, white=0, violet=-2)
# Keywords of powerlaw_psd_gaussian that an Ambience records and passes on
NOISE_KWARGS = ("fmin", "seed")


class Ambience:
    """Persistent background noise for a Scene."""

    def __init__(
        self,
        channels: int,
        duration: utils.Numeric,
        alias: str,
        filepath: Optional[Union[str, Path]] = None,
        noise: Optional[Union[str, utils.Numeric]] = None,
        ref_db: Optional[utils.Numeric] = config.DEFAULT_REF_DB,
        sample_rate: Optional[utils.Numeric] = config.SAMPLE_RATE,
        **kwargs,
    ):
        """Initialise invariant background noise for a Scene.

        Either `filepath` (an audio file, tiled over the channels and the
        duration) or `noise` (a colour name, "gaussian", or a numeric beta
        exponent) must be given; extra kwargs (`fmin`, `seed`) are recorded
        as the reference records them.
        """
        self.channels = utils.sanitise_positive_number(channels, cast_to=int)
        self.sample_rate = utils.sanitise_positive_number(sample_rate, cast_to=int)
        self.duration = utils.sanitise_positive_number(duration)
        self.alias = alias

        if noise is None and filepath is not None:
            self.filepath, self.beta = utils.sanitise_filepath(filepath), None
        elif noise is not None and filepath is None:
            self.filepath, self.beta = None, _parse_beta(noise)
        elif noise is not None and filepath is not None:
            raise AttributeError("Only one of `noise` or `filepath` should be provided.")
        else:
            raise AttributeError("One of `noise` or `filepath` must be provided")

        for kwarg in kwargs:
            if kwarg not in NOISE_KWARGS:
                raise AttributeError(f"`{kwarg}` is not a valid keyword argument for `powerlaw_psd_gaussian`")
        self.noise_kwargs = kwargs

        # The noise floor must be a negative dB value
        utils.sanitise_positive_number(-ref_db)
        self.ref_db = ref_db

        self.audio = None

    @property
    def is_audio_loaded(self) -> bool:
        """True when the bed has been drawn and is valid audio."""
        if self.audio is None:
            return False
        try:
            return valid_audio(self.audio)
        except (TypeError, ValueError):
            return False

    def load_ambience(self, ignore_cache: Optional[bool] = False, normalize: Optional[bool] = True) -> np.ndarray:
        """The bed as a (channels, samples) array, made on the host once and
        kept. "gaussian" is float32 white noise from a PCG generator seeded
        by one draw of numpy's global stream; the other exponents shape a
        Gaussian spectrum (`powerlaw_psd_gaussian`, its own seeded
        generator). A file is loaded at the scene's rate and tiled to the
        duration: a mono file over every channel, a file with the bed's
        channel count as it is, any other one channel of it picked by
        Python's `random`. `normalize` divides each channel by its peak."""
        if self.is_audio_loaded and not ignore_cache:
            return self.audio
        total_samples = round(self.duration * self.sample_rate)
        shape = (self.channels, total_samples)
        if self.beta == "gaussian":
            out = np.random.default_rng(np.random.randint(0, 2**31)).standard_normal(shape, dtype=np.float32)
        elif self.beta is not None:
            out = powerlaw_psd_gaussian(self.beta, shape, **self.noise_kwargs)
        else:
            ambient = utils.coerce2d(load_audio(self.filepath, sr=self.sample_rate, mono=False)[0])
            n_audio_channels, n_samples = ambient.shape
            tile_channels = 1
            if n_audio_channels != self.channels:
                if n_audio_channels == 1:
                    ambient = ambient[0, :]
                else:
                    logger.warning(
                        f"Passed audio has {n_audio_channels} channels, but expected "
                        f"{self.channels} channels. A random mono channel will be chosen."
                    )
                    ambient = ambient[random.choice(range(n_audio_channels)), :]
                tile_channels = self.channels
            repeats = -(-total_samples // n_samples)  # ceiling division
            out = np.tile(utils.coerce2d(ambient), (tile_channels, repeats))[:, :total_samples]
        if normalize:
            if out.dtype != np.float32:
                out = np.asarray(out, dtype=np.float64)
            peak = np.maximum(np.max(out, axis=1, keepdims=True), -np.min(out, axis=1, keepdims=True)) + utils.tiny(out)
            out /= peak
        self.audio = out
        return self.audio

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Ambience):
            return False
        return _compare_dicts(self.to_dict(), other.to_dict())

    def __str__(self) -> str:
        return f"'Ambience' with alias '{self.alias}'."

    def __repr__(self) -> str:
        return utils.repr_as_json(self)

    def to_dict(self) -> dict:
        """Metadata for this object as a dictionary."""
        return dict(
            alias=self.alias,
            beta=self.beta,
            filepath=str(self.filepath) if self.filepath is not None else None,
            channels=self.channels,
            sample_rate=self.sample_rate,
            duration=self.duration,
            ref_db=self.ref_db,
            noise_kwargs=self.noise_kwargs,
        )

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any]) -> "Ambience":
        """Instantiate Ambience from a dictionary."""
        for k in ["alias", "filepath", "duration", "ref_db", "beta", "channels"]:
            if k not in input_dict:
                raise KeyError(f"Missing key: '{k}'")
        return cls(
            channels=input_dict["channels"],
            sample_rate=input_dict["sample_rate"],
            alias=input_dict["alias"],
            filepath=input_dict["filepath"],
            duration=input_dict["duration"],
            noise=input_dict["beta"],
            ref_db=input_dict["ref_db"],
            **input_dict.get("noise_kwargs", {}),
        )


def powerlaw_psd_gaussian(beta: utils.Numeric, shape: Union[int, Iterable[int]], fmin: Optional[utils.Numeric] = 0.0,
                          seed: Optional[int] = utils.SEED) -> np.ndarray:
    """Gaussian (1/f)^beta noise by Timmer & Koenig spectral shaping (numpy).

    The last axis of `shape` is time; the others are independent. The output
    has about unit variance. The generator, `np.random.default_rng(seed)`,
    draws the real and then the imaginary parts, as the reference does."""
    if isinstance(shape, (np.integer, int)):
        size = [shape]
    elif isinstance(shape, Iterable):
        size = list(shape)
    else:
        raise ValueError(f"Argument `shape` must be int or Iterable[int] but got {type(shape)}")
    samples = size[-1]
    f = np.fft.rfftfreq(samples)
    fmin = utils.sanitise_positive_number(fmin)
    if 0 <= fmin <= 0.5:
        fmin = max(fmin, 1.0 / (samples + utils.tiny(float(samples))))
    else:
        raise ValueError(f"Argument `fmin` must be chosen between 0 and 0.5 but got {fmin:.2f}.")
    s_scale = f.copy()
    ix = np.sum(s_scale < fmin)
    if ix and ix < len(s_scale):
        s_scale[:ix] = s_scale[ix]
    s_scale = s_scale ** (-beta / 2.0)

    # Theoretical standard deviation of the output
    w = s_scale[1:].copy()
    w[-1] *= (1 + (samples % 2)) / 2.0
    sigma = 2 * np.sqrt(np.sum(w**2)) / (samples + utils.tiny(float(samples)))

    size[-1] = len(f)
    s_scale = s_scale[(np.newaxis,) * (len(size) - 1) + (Ellipsis,)]
    rng = np.random.default_rng(seed)
    sr = rng.normal(scale=s_scale, size=size)
    si = rng.normal(scale=s_scale, size=size)
    if not (samples % 2):
        si[..., -1] = 0
        sr[..., -1] *= np.sqrt(2)
    si[..., 0] = 0
    sr[..., 0] *= np.sqrt(2)
    y = np.fft.irfft(sr + 1j * si, n=samples, axis=-1)
    y /= sigma
    return y


def _parse_beta(noise: Any) -> Union[float, str]:
    """Parse a noise colour name, "gaussian", or numeric beta exponent."""
    if isinstance(noise, str):
        if noise in NOISE_MAPPING:
            return NOISE_MAPPING[noise]
        if noise.lower() == "gaussian":
            return "gaussian"
        keys = ", ".join(NOISE_MAPPING.keys())
        raise KeyError(f"Expected a string in {keys} but got {noise}.")
    if isinstance(noise, utils.NUMERIC_DTYPES):
        return noise
    raise TypeError(f"Expected either a string or numeric input, but got {type(noise)}.")
