"""The port's augmentation FX on the CPU against the JAX package's.

- The host FX (`ops.fx_dsp`, the port's copy) against
  `audiblelight_tpu.ops.fx_dsp` with its numpy backend forced
  (AUDIBLELIGHT_FX_BACKEND=numpy): the same code, within 1e-6 of peak.
- The torch FX (`ops.fx_torch`) on CPU tensors against
  `audiblelight_tpu.ops.fx_jax` on the same inputs: the biquads and the
  one-pole within 1e-5 of peak; the compressor (and limiter) within 1e-6 of
  peak of the float64 compressor and no further from fx_jax than fx_jax's
  own float32 scan is from that (1.0-1.6e-5 of peak); the
  one-pole also against the sequential recurrence (atol 1e-4, c = 0.9995)
  and, at lengths across blocks and blocks of blocks, against the
  recurrence in float64 (1e-5 of peak);
  the time stretch and the pitch shift with identical lengths, correlation
  > 0.99 and peak within 10 %, the reference's own bound between fx_jax and
  numpy (their phase accumulates to ~1e5 rad in the top bins; fx_jax rounds
  it in float32, the port in float64, so samples differ by up to ~1e-2 of
  peak).
- The device rule: the torch FX run where the augmentation's device is a
  card, the host FX on the CPU; no environment variable changes that, and
  asking for the card without one raises.
"""

import numpy as np
import pytest
import torch

from audiblelight_tpu.ops import fx_dsp as j_dsp
from audiblelight_tpu.ops import fx_jax
from audiblelight_tpu_torch import augmentation as taug
from audiblelight_tpu_torch.ops import fx_dsp as t_dsp
from audiblelight_tpu_torch.ops import fx_torch

SR = 24000


@pytest.fixture(scope="module")
def tone():
    rng = np.random.default_rng(42)
    t = np.arange(SR) / SR
    x = 0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * np.sin(2 * np.pi * 3520.0 * t)
    return (x + 0.02 * rng.standard_normal(SR)).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


HOST_FX = {
    "lowpass": lambda m, x: m.biquad(x, "lowpass", SR, 1000.0),
    "highpass": lambda m, x: m.biquad(x, "highpass", SR, 200.0),
    "peak": lambda m, x: m.biquad(x, "peak", SR, 2000.0, 4.0, -12.0),
    "lowshelf": lambda m, x: m.biquad(x, "lowshelf", SR, 400.0, 0.7071, 9.0),
    "highshelf": lambda m, x: m.biquad(x, "highshelf", SR, 5000.0, 0.7071, -9.0),
    "compress": lambda m, x: m.compress(4 * x, SR, -20.0, 4.0, 5.0, 100.0),
    "limit": lambda m, x: m.limit(4 * x, SR, -25.0, 300.0),
    "clip": lambda m, x: m.clip_db(x, -9.5),
    "distort": lambda m, x: m.distort(x, 20.0),
    "bitcrush": lambda m, x: m.bitcrush(x, 9.3),
    "gain": lambda m, x: m.gain(x, -6.0),
    "chorus": lambda m, x: m.chorus(x, SR, 2.0, 0.5, 8.0, 0.4, 0.3),
    "phaser": lambda m, x: m.phaser(x, SR, 1.5, 0.7, 1000.0, 0.5, 0.4),
    "delay": lambda m, x: m.delay_fx(x, SR, 0.12, 0.4, 0.3),
    "gsm": lambda m, x: m.gsm_fullrate(x, SR, 2),
    "mp3": lambda m, x: m.mp3_artifacts(x, SR, 6.0),
    "time_stretch": lambda m, x: m.time_stretch(x, 1.3),
    "pitch_shift": lambda m, x: m.pitch_shift(x, SR, -3),
}


@pytest.mark.parametrize("name", list(HOST_FX))
def test_host_fx_match_reference_numpy(tone, monkeypatch, name):
    monkeypatch.setenv("AUDIBLELIGHT_FX_BACKEND", "numpy")
    fn = HOST_FX[name]
    assert _rel(fn(t_dsp, tone), fn(j_dsp, tone)) <= 1e-6


@pytest.mark.parametrize("kind,freq,q,gain", [
    ("lowpass", 1000.0, 0.7071, 0.0), ("highpass", 32.0, 0.7071, 0.0), ("peak", 2000.0, 4.0, -12.0),
    ("lowshelf", 400.0, 0.7071, 9.0), ("highshelf", 5000.0, 0.7071, -9.0),
])
def test_biquad_matches_fx_jax(tone, kind, freq, q, gain):
    b, a = j_dsp._biquad_coeffs(kind, SR, freq, q, gain)
    assert _rel(fx_torch.biquad(tone, b, a, device="cpu"), fx_jax.biquad(tone, b, a)) <= 1e-5
    stereo = np.stack([tone, -0.5 * tone])
    assert _rel(fx_torch.biquad(stereo, b, a, device="cpu"), fx_jax.biquad(stereo, b, a)) <= 1e-5


@pytest.mark.parametrize("args", [(-20.0, 4.0, 5.0, 100.0), (-30.0, 1000.0, 0.5, 1000.0)],
                         ids=["compressor", "limiter"])
def test_compress_matches_fx_jax(tone, args):
    """Within 1e-6 of peak of the same compressor in float64 (its one-poles
    by scipy's lfilter, at the float32 coefficients both packages use), and
    no further from fx_jax than fx_jax is from that float64 compressor plus
    1e-6 of peak: fx_jax's float32 associative scan raises c to powers by
    repeated products, which puts it 1.0e-5 (compressor) and 1.6e-5
    (limiter) of peak from the float64 result on this input."""
    from scipy.signal import lfilter

    loud = tone * 4.0
    got = fx_torch.compress(loud, SR, *args, device="cpu")
    threshold_db, ratio, attack_ms, release_ms = args
    att, rel = (float(np.float32(np.exp(-1.0 / max(ms * 1e-3 * SR, 1.0)))) for ms in (attack_ms, release_ms))
    level_db = 20.0 * np.log10(lfilter([1.0 - att], [1.0, -att], np.abs(loud.astype(np.float64))) + 1e-10)
    gain_db = lfilter([1.0 - rel], [1.0, -rel], -np.maximum(level_db - threshold_db, 0.0) * (1.0 - 1.0 / ratio))
    exact = (loud * 10.0 ** (gain_db / 20.0)).astype(np.float32)
    assert _rel(got, exact) <= 1e-6
    want = fx_jax.compress(loud, SR, *args)
    assert _rel(got, want) <= _rel(want, exact) + 1e-6
    assert np.abs(got).max() < np.abs(loud).max()


def test_onepole_matches_fx_jax_and_the_recurrence():
    import jax.numpy as jnp

    x = np.random.default_rng(42).standard_normal(8192).astype(np.float32)
    c = 0.9995
    got = fx_torch.onepole(x, c, device="cpu").numpy()
    assert _rel(got, np.asarray(fx_jax._onepole(jnp.asarray(x), jnp.float32(c)))) <= 1e-5
    want = np.empty_like(x)
    acc = 0.0
    for i, v in enumerate(x):
        acc = (1 - c) * v + c * acc
        want[i] = acc
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("n,c", [(1, 0.9), (127, 0.5), (30001, 0.92), (5000, float(np.exp(-1.0))),
                                 (128 * 128 * 3 + 5, 0.9995)])
def test_onepole_blocks_match_the_recurrence(n, c):
    """The blocked scan at lengths below one block, across blocks, and
    across blocks of blocks, for fast and slow poles, against the
    recurrence in float64 (scipy's lfilter), two channels at once."""
    from scipy.signal import lfilter

    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    c32 = float(np.float32(c))
    want = lfilter([1.0 - c32], [1.0, -c32], x.astype(np.float64), axis=-1)
    got = fx_torch.onepole(x, c, device="cpu").numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _correlated(got, want) -> None:
    assert got.shape == want.shape  # identical output-length law
    corr = float(np.dot(got.ravel(), want.ravel()) / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-12))
    assert corr > 0.99
    assert abs(np.abs(got).max() - np.abs(want).max()) < 0.1 * np.abs(want).max()


@pytest.mark.parametrize("rate", [0.75, 0.9, 1.1, 1.3])
def test_time_stretch_matches_fx_jax(tone, rate):
    _correlated(fx_torch.time_stretch(tone, rate, device="cpu"), fx_jax.time_stretch(tone, rate))
    stereo = np.stack([tone, tone[::-1].copy()])
    _correlated(fx_torch.time_stretch(stereo, rate, device="cpu"), fx_jax.time_stretch(stereo, rate))


@pytest.mark.parametrize("semitones", [-7, -3, 2, 3])
def test_pitch_shift_matches_fx_jax(tone, semitones):
    got = fx_torch.pitch_shift(tone, SR, semitones, device="cpu")
    _correlated(got, fx_jax.pitch_shift(tone, SR, semitones))
    assert got.shape == tone.shape
    spec = np.abs(np.fft.rfft(got * np.hanning(len(got))))
    f = np.fft.rfftfreq(len(got), 1 / SR)
    band = (f > 100) & (f < 1000)
    assert abs(f[band][np.argmax(spec[band])] - 440.0 * 2 ** (semitones / 12.0)) < 15.0


def test_fx_follow_the_device_not_an_environment_variable(tone, monkeypatch):
    """On the CPU the augmentations take the host FX whatever the reference's
    backend variable says; the card is used only where it is asked for."""
    monkeypatch.setenv("AUDIBLELIGHT_FX_BACKEND", "jax")
    assert not taug._on_card("cpu")
    aug = taug.SpeedUp(sample_rate=SR, stretch_factor=1.3, device="cpu")
    monkeypatch.setattr(fx_torch, "time_stretch", lambda *a, **k: pytest.fail("torch FX on the CPU"))
    out = aug(tone)
    np.testing.assert_array_equal(out, taug.utils.pad_or_truncate_audio(
        t_dsp.time_stretch(tone, 1.3)[None], SR, pad_mode="wrap")[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            taug.SpeedUp(sample_rate=SR, stretch_factor=1.3)(tone)
    assert not any("jax" in name.lower() or name.startswith("_probe") for name in vars(t_dsp))
