"""The port's MP3 and FLAC codecs (audiblelight_tpu_torch/io/codecs.py) and
their dispatch in `io/audio.py`, against the JAX package's.

- MP3 (libmpg123 over ctypes): the repo's FMA clip decodes to the
  reference's samples exactly, with the reference's duration; files written
  by `mp3_write` (libmp3lame) round-trip. These cases skip where the
  libraries cannot be loaded, as the reference's tests do.
- FLAC: `flac_write`'s default (verbatim) bytes equal the reference's; files
  written by either package decode in the other bit for bit, including the
  port's Rice-coded files (fixed and LPC predictors, every stereo
  decorrelation, 16- and 24-bit, a partial last block), which exercise the
  port's numpy residual decode against the reference's per-sample loop.
- `load_audio` (offset, duration, mono, resample) and `get_duration` on both
  formats equal the reference's within 1e-6; an unsupported suffix raises
  the reference's error.
"""

import numpy as np
import pytest

from pathlib import Path

from audiblelight_tpu.io import audio as jaudio
from audiblelight_tpu.io import codecs as jcodecs
from audiblelight_tpu_torch.io import audio as taudio
from audiblelight_tpu_torch.io import codecs as tcodecs

REPO = Path(__file__).resolve().parents[1]
MP3 = REPO / "tests/resources/soundevents/music/000010.mp3"
SR = 44100

needs_mp3 = pytest.mark.skipif(not jcodecs.mp3_available(), reason="libmpg123 not present")
needs_lame = pytest.mark.skipif(
    not (jcodecs.mp3_available() and jcodecs.mp3_encode_available()), reason="libmpg123/libmp3lame not present"
)


def _signal(channels: int, n: int, seed: int = 0) -> np.ndarray:
    """A tone plus noise, made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    tone = 0.4 * np.sin(2 * np.pi * 440.0 * t)[None] * np.linspace(1.0, 0.6, channels)[:, None]
    return (tone + 0.05 * rng.standard_normal((channels, n))).astype(np.float32)


@needs_mp3
def test_mp3_decode_matches_reference():
    """The repo's FMA clip: the same samples, rate and duration."""
    got, sr = tcodecs.mp3_read(MP3)
    want, want_sr = jcodecs.mp3_read(MP3)
    assert sr == want_sr and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert tcodecs.mp3_duration(MP3) == jcodecs.mp3_duration(MP3)
    assert taudio.get_duration(MP3) == jaudio.get_duration(MP3)


@needs_lame
@pytest.mark.parametrize("channels", [1, 2])
def test_mp3_write_round_trips(tmp_path, channels):
    """mp3_write's file decodes (in both packages, to the same samples) to the
    tone it was given: its length within the codec's slack, its peak and
    level kept."""
    x = _signal(channels, 2 * SR)
    tcodecs.mp3_write(tmp_path / "t.mp3", x, SR)
    got, sr = tcodecs.mp3_read(tmp_path / "t.mp3")
    want, _ = jcodecs.mp3_read(tmp_path / "t.mp3")
    np.testing.assert_array_equal(got, want)
    assert sr == SR and got.shape[0] == channels
    assert abs(got.shape[1] - x.shape[1]) < 0.1 * SR
    n = min(got.shape[1], x.shape[1])
    peak_hz = np.argmax(np.abs(np.fft.rfft(got[0, :n]))) * SR / n
    assert abs(peak_hz - 440.0) < 5.0
    assert abs(np.abs(got).max() - np.abs(x).max()) < 0.1
    assert abs(tcodecs.mp3_duration(tmp_path / "t.mp3") - 2.0) < 0.1


@pytest.mark.parametrize("bps,n", [(16, 10000), (24, 11025), (8, 5000)])
def test_flac_write_bytes_equal_reference(tmp_path, bps, n):
    x = _signal(2, n, seed=bps)
    tcodecs.flac_write(tmp_path / "t.flac", x, SR, bps=bps)
    jcodecs.flac_write(tmp_path / "j.flac", x, SR, bps=bps)
    assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_flac_verbatim_decodes_across_packages(tmp_path, writer):
    x = _signal(3, 9000, seed=1)
    (tcodecs if writer == "port" else jcodecs).flac_write(tmp_path / "x.flac", x, SR)
    got, sr = tcodecs.flac_read(tmp_path / "x.flac")
    want, want_sr = jcodecs.flac_read(tmp_path / "x.flac")
    assert sr == want_sr == SR
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, x, atol=1.0 / (1 << 15))
    assert tcodecs.flac_duration(tmp_path / "x.flac") == jcodecs.flac_duration(tmp_path / "x.flac")


@pytest.mark.parametrize("method", ["fixed", "lpc"])
@pytest.mark.parametrize("stereo", ["independent", "left_side", "right_side", "mid_side"])
@pytest.mark.parametrize("bps", [16, 24])
def test_flac_rice_decode_equals_reference(tmp_path, method, stereo, bps):
    """Rice-coded frames (the port's encoder) decode to the reference's
    samples bit for bit, and to the quantised input: lossless."""
    x = _signal(2, 4096 * 2 + 777, seed=bps)
    x[:, 5000:5100] = 0.0  # a run of zero residuals
    tcodecs.flac_write(tmp_path / "r.flac", x, SR, bps=bps, method=method, stereo=stereo)
    got, _ = tcodecs.flac_read(tmp_path / "r.flac")
    want, _ = jcodecs.flac_read(tmp_path / "r.flac")
    np.testing.assert_array_equal(got, want)
    scale = 1 << (bps - 1)
    q = np.clip(np.round(x * scale), -scale, scale - 1) / scale
    np.testing.assert_array_equal(got, q.astype(np.float32))


def test_flac_rice_mono_and_escape_partition(tmp_path):
    """A mono fixed-predictor file with a silent stretch (escaped partitions
    of zero-bit fields) and a loud click (a long unary code): both packages
    read it the same."""
    x = _signal(1, 6000, seed=3)
    x[0, :2000] = 0.0
    x[0, 3000] = 0.99
    tcodecs.flac_write(tmp_path / "m.flac", x, SR, method="fixed")
    got, _ = tcodecs.flac_read(tmp_path / "m.flac")
    want, _ = jcodecs.flac_read(tmp_path / "m.flac")
    np.testing.assert_array_equal(got, want)


def _both(fn, path, **kw):
    return getattr(taudio, fn)(path, **kw), getattr(jaudio, fn)(path, **kw)


@pytest.mark.parametrize("fmt", ["mp3", "flac"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(mono=False),
    dict(offset=0.25, duration=0.5),
    dict(offset=0.1, duration=0.3, mono=False, sr=24000),
    dict(sr=22050),
], ids=["whole mono", "whole channels", "slice", "slice resampled", "resampled"])
def test_load_audio_matches_reference(tmp_path, fmt, kw):
    if fmt == "mp3":
        if not jcodecs.mp3_available():
            pytest.skip("libmpg123 not present")
        path = MP3
    else:
        path = tmp_path / "x.flac"
        tcodecs.flac_write(path, _signal(2, SR, seed=4), SR, method="lpc")
    (got, got_sr), (want, want_sr) = _both("load_audio", path, **kw)
    assert got_sr == want_sr and got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    g, w = _both("get_duration", path)
    assert abs(g - w) < 1e-6


def test_unsupported_format_raises(tmp_path):
    p = tmp_path / "x.ogg"
    p.write_bytes(b"OggS")
    for fn in (taudio.get_duration, taudio.load_audio):
        with pytest.raises(ValueError, match="Unsupported audio format"):
            fn(p)
