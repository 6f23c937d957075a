"""Host FX of the augmentations (copy of audiblelight_tpu/ops/fx_dsp.py).

numpy/scipy implementations: RBJ-cookbook biquads, feed-forward dynamics
(compressor/limiter), clipping, tanh distortion, bitcrush, gain,
modulated-delay chorus and phaser, a tap-expanded feedback delay, GSM and
MP3 codec-artifact emulations, and a phase-vocoder time stretch and pitch
shift. They run on the host; `augmentation` takes the biquads, the dynamics,
the time stretch and the pitch shift through `ops.fx_torch` instead when an
augmentation runs on a card.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as ssignal

# ---------------------------------------------------------------------------
# Biquad filters (RBJ audio EQ cookbook)
# ---------------------------------------------------------------------------


def _biquad_coeffs(kind: str, sr: float, freq: float, q: float = 0.7071, gain_db: float = 0.0):
    """Return (b, a) for an RBJ cookbook biquad."""
    freq = min(max(freq, 1.0), sr / 2 - 1.0)
    w0 = 2 * np.pi * freq / sr
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / (2 * q)
    big_a = 10 ** (gain_db / 40.0)

    if kind == "lowpass":
        b = [(1 - cw) / 2, 1 - cw, (1 - cw) / 2]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "highpass":
        b = [(1 + cw) / 2, -(1 + cw), (1 + cw) / 2]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "peak":
        b = [1 + alpha * big_a, -2 * cw, 1 - alpha * big_a]
        a = [1 + alpha / big_a, -2 * cw, 1 - alpha / big_a]
    elif kind == "lowshelf":
        sq = 2 * np.sqrt(big_a) * alpha
        b = [
            big_a * ((big_a + 1) - (big_a - 1) * cw + sq),
            2 * big_a * ((big_a - 1) - (big_a + 1) * cw),
            big_a * ((big_a + 1) - (big_a - 1) * cw - sq),
        ]
        a = [
            (big_a + 1) + (big_a - 1) * cw + sq,
            -2 * ((big_a - 1) + (big_a + 1) * cw),
            (big_a + 1) + (big_a - 1) * cw - sq,
        ]
    elif kind == "highshelf":
        sq = 2 * np.sqrt(big_a) * alpha
        b = [
            big_a * ((big_a + 1) + (big_a - 1) * cw + sq),
            -2 * big_a * ((big_a - 1) + (big_a + 1) * cw),
            big_a * ((big_a + 1) + (big_a - 1) * cw - sq),
        ]
        a = [
            (big_a + 1) - (big_a - 1) * cw + sq,
            2 * ((big_a - 1) - (big_a + 1) * cw),
            (big_a + 1) - (big_a - 1) * cw - sq,
        ]
    else:
        raise ValueError(f"Unknown biquad kind: {kind}")

    b = np.asarray(b, dtype=np.float64) / a[0]
    a = np.asarray(a, dtype=np.float64) / a[0]
    return b, a


def biquad(audio: np.ndarray, kind: str, sr: float, freq: float, q: float = 0.7071, gain_db: float = 0.0) -> np.ndarray:
    """Apply a single RBJ biquad along the last axis."""
    b, a = _biquad_coeffs(kind, sr, freq, q, gain_db)
    return ssignal.lfilter(b, a, audio, axis=-1).astype(audio.dtype, copy=False)


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------


def _smooth(x: np.ndarray, coeff: float) -> np.ndarray:
    """One-pole smoothing y[n] = (1-c) x[n] + c y[n-1], vectorised via lfilter."""
    return ssignal.lfilter([1.0 - coeff], [1.0, -coeff], x, axis=-1)


def _ms_to_coeff(ms: float, sr: float) -> float:
    return float(np.exp(-1.0 / max(ms * 1e-3 * sr, 1.0)))


def compress(
    audio: np.ndarray,
    sr: float,
    threshold_db: float,
    ratio: float,
    attack_ms: float,
    release_ms: float,
) -> np.ndarray:
    """Feed-forward dynamic range compressor (fully vectorised).

    Level detection with attack smoothing; static gain curve
    g = (threshold - level) * (1 - 1/ratio) above threshold; release-smoothed gain.
    """
    eps = 1e-10
    level = _smooth(np.abs(audio), _ms_to_coeff(attack_ms, sr))
    level_db = 20.0 * np.log10(level + eps)
    over = np.maximum(level_db - threshold_db, 0.0)
    gain_db = -over * (1.0 - 1.0 / max(ratio, 1.0))
    gain_db = _smooth(gain_db, _ms_to_coeff(release_ms, sr))
    return (audio * 10 ** (gain_db / 20.0)).astype(audio.dtype, copy=False)


def limit(audio: np.ndarray, sr: float, threshold_db: float, release_ms: float) -> np.ndarray:
    """Limiter: near-infinite-ratio compressor with fast attack + output clip."""
    out = compress(audio, sr, threshold_db, ratio=1000.0, attack_ms=0.5, release_ms=release_ms)
    ceiling = 10 ** (threshold_db / 20.0)
    return np.clip(out, -ceiling, ceiling)


def clip_db(audio: np.ndarray, threshold_db: float) -> np.ndarray:
    """Hard clipping at a dB threshold."""
    t = 10 ** (threshold_db / 20.0)
    return np.clip(audio, -t, t)


def distort(audio: np.ndarray, drive_db: float) -> np.ndarray:
    """tanh waveshaper with input drive (pedalboard Distortion-equivalent shape)."""
    return np.tanh(audio * 10 ** (drive_db / 20.0)).astype(audio.dtype, copy=False)


def bitcrush(audio: np.ndarray, bit_depth: float) -> np.ndarray:
    """Quantize sample values to the given (possibly fractional) bit depth."""
    levels = 2.0 ** (bit_depth - 1)
    return (np.round(audio * levels) / levels).astype(audio.dtype, copy=False)


def gain(audio: np.ndarray, gain_db: float) -> np.ndarray:
    """Scalar gain in dB."""
    return (audio * 10 ** (gain_db / 20.0)).astype(audio.dtype, copy=False)


# ---------------------------------------------------------------------------
# Modulation FX
# ---------------------------------------------------------------------------


def _fractional_read(audio: np.ndarray, delays: np.ndarray) -> np.ndarray:
    """Read audio at (t - delays) with linear interpolation; zero before t=0."""
    n = audio.shape[-1]
    t = np.arange(n, dtype=np.float64)
    read = t - delays
    lo = np.floor(read).astype(np.int64)
    frac = read - lo
    lo_c = np.clip(lo, 0, n - 1)
    hi_c = np.clip(lo + 1, 0, n - 1)
    out = audio[..., lo_c] * (1 - frac) + audio[..., hi_c] * frac
    return np.where(read >= 0, out, 0.0)


def chorus(
    audio: np.ndarray,
    sr: float,
    rate_hz: float,
    depth: float,
    centre_delay_ms: float,
    feedback: float,
    mix: float,
) -> np.ndarray:
    """LFO-modulated delay chorus.

    The feedback path is expanded into successive modulated taps with geometric
    gains (vectorised approximation of the recursive delay line).
    """
    n = audio.shape[-1]
    t = np.arange(n, dtype=np.float64)
    centre = centre_delay_ms * 1e-3 * sr
    lfo = np.sin(2 * np.pi * rate_hz * t / sr)
    delay = centre * (1.0 + 0.5 * depth * lfo)
    delay = np.maximum(delay, 1.0)

    wet = np.zeros_like(audio, dtype=np.float64)
    fb_gain = 1.0
    total_delay = delay.copy()
    for _ in range(6 if feedback > 0 else 1):
        wet += fb_gain * _fractional_read(audio, total_delay)
        fb_gain *= feedback
        if fb_gain < 1e-4:
            break
        total_delay = total_delay + delay
    return ((1.0 - mix) * audio + mix * wet).astype(audio.dtype, copy=False)


def phaser(
    audio: np.ndarray,
    sr: float,
    rate_hz: float,
    depth: float,
    centre_frequency_hz: float,
    feedback: float,
    mix: float,
    n_stages: int = 6,
    block: int = 256,
) -> np.ndarray:
    """Cascaded-allpass phaser with block-wise LFO-swept coefficients."""
    n = audio.shape[-1]
    n_blocks = -(-n // block)
    t_blocks = (np.arange(n_blocks) * block + block / 2) / sr
    lfo = np.sin(2 * np.pi * rate_hz * t_blocks)
    freqs = centre_frequency_hz * (2.0 ** (depth * lfo))  # sweep +-1 octave * depth
    freqs = np.clip(freqs, 20.0, sr / 2 - 100.0)

    wet = np.array(audio, dtype=np.float64, copy=True)
    # First-order allpass coefficient per block: a = (tan(pi f/sr) - 1)/(tan(pi f/sr) + 1)
    tans = np.tan(np.pi * freqs / sr)
    coeffs = (tans - 1.0) / (tans + 1.0)

    zi = np.zeros((n_stages,) + audio.shape[:-1] + (1,))
    fb_sample = 0.0
    for bi in range(n_blocks):
        sl = slice(bi * block, min((bi + 1) * block, n))
        seg = wet[..., sl] + feedback * fb_sample
        a = coeffs[bi]
        for s in range(n_stages):
            seg, zi[s] = ssignal.lfilter([a, 1.0], [1.0, a], seg, axis=-1, zi=zi[s])
        wet[..., sl] = seg
        fb_sample = seg[..., -1:]
    return ((1.0 - mix) * audio + mix * wet).astype(audio.dtype, copy=False)


def delay_fx(audio: np.ndarray, sr: float, delay_seconds: float, feedback: float, mix: float) -> np.ndarray:
    """Feedback delay, expanded into a finite geometric sum of shifted taps."""
    d = max(int(round(delay_seconds * sr)), 1)
    n = audio.shape[-1]
    wet = np.zeros_like(audio, dtype=np.float64)
    g = 1.0
    k = 1
    while g >= 1e-4 and k * d < n * 4:
        shift = k * d
        if shift < n:
            wet[..., shift:] += g * audio[..., : n - shift]
        g *= feedback
        if feedback <= 0:
            break
        k += 1
    return ((1.0 - mix) * audio + mix * wet).astype(audio.dtype, copy=False)


# ---------------------------------------------------------------------------
# Codec-artifact emulations
# ---------------------------------------------------------------------------


def gsm_fullrate(audio: np.ndarray, sr: float, quality: int = 2) -> np.ndarray:
    """GSM full-rate codec artifact emulation.

    Pipeline: band-limit + resample to 8 kHz (resampler sharpness scales with
    `quality`), 13-bit companded quantisation (GSM RPE-LTP operates on 13-bit
    samples), resample back. Emulates the muffled, quantised 2G-call character.
    """
    from math import gcd

    g = gcd(int(sr), 8000)
    up, down = 8000 // g, int(sr) // g
    # Lower quality = shorter filter = more aliasing (mirrors resampler quality)
    window = ("kaiser", 2.0 + 3.0 * quality)
    low = ssignal.resample_poly(audio, up, down, axis=-1, window=window)
    # 13-bit quantisation with mild mu-law-ish companding
    mu = 255.0
    comp = np.sign(low) * np.log1p(mu * np.abs(low)) / np.log1p(mu)
    q = 2.0**12
    comp_q = np.round(comp * q) / q
    low_q = np.sign(comp_q) * (np.expm1(np.abs(comp_q) * np.log1p(mu))) / mu
    out = ssignal.resample_poly(low_q, down, up, axis=-1, window=window)
    # match original length
    n = audio.shape[-1]
    if out.shape[-1] < n:
        out = np.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, n - out.shape[-1])])
    return out[..., :n].astype(audio.dtype, copy=False)


def mp3_artifacts(audio: np.ndarray, sr: float, vbr_quality: float) -> np.ndarray:
    """MP3-style compression artifact emulation.

    STFT-domain per-band magnitude quantisation with a quality-dependent noise
    floor plus high-frequency cutoff — reproducing the characteristic smearing
    and band-limiting of low-bitrate MP3 without a LAME dependency.
    """
    nfft = 1024
    f, t, z = ssignal.stft(audio, fs=sr, nperseg=nfft, axis=-1)
    # vbr_quality 2 (good) .. 10 (bad): cutoff from ~0.9 Nyquist down to ~0.35
    frac = np.clip(1.0 - (vbr_quality - 2.0) / 8.0, 0.0, 1.0)
    cutoff = (0.35 + 0.55 * frac) * (sr / 2)
    # z has shape (..., F, T): mask the frequency axis (second-to-last)
    z = z * (f <= cutoff)[..., :, None]
    # Magnitude quantisation: step grows with quality value
    mag = np.abs(z)
    phase = np.angle(z)
    step = np.maximum(mag.max() * 10 ** (-(80 - 6 * vbr_quality) / 20.0), 1e-12)
    mag_q = np.round(mag / step) * step
    z_q = mag_q * np.exp(1j * phase)
    _, out = ssignal.istft(z_q, fs=sr, nperseg=nfft)
    n = audio.shape[-1]
    if out.shape[-1] < n:
        out = np.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, n - out.shape[-1])])
    return out[..., :n].astype(audio.dtype, copy=False)


# ---------------------------------------------------------------------------
# Phase vocoder: time stretch + pitch shift
# ---------------------------------------------------------------------------


def time_stretch(audio: np.ndarray, rate: float, nfft: int = 2048, hop: int = 512) -> np.ndarray:
    """Phase-vocoder time stretch: rate > 1 speeds up (shortens) the audio."""
    if rate == 1.0:
        return audio
    mono = audio.ndim == 1
    x = audio[None, :] if mono else audio

    window = np.hanning(nfft)
    # analysis STFT
    n = x.shape[-1]
    n_frames = max(1 + (n - nfft) // hop, 1)
    pad = (n_frames - 1) * hop + nfft - n
    xp = np.pad(x, [(0, 0), (0, max(pad, 0))])
    idx = np.arange(nfft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = xp[:, idx] * window  # (C, T, nfft)
    spec = np.fft.rfft(frames, axis=-1)  # (C, T, F)

    # synthesis frame positions
    time_steps = np.arange(0, n_frames, rate)
    mags = np.abs(spec)
    phases = np.angle(spec)

    # interpolate magnitudes; accumulate phase with instantaneous frequency
    t_lo = np.floor(time_steps).astype(int)
    t_hi = np.minimum(t_lo + 1, n_frames - 1)
    frac = (time_steps - t_lo)[None, :, None]
    mag_i = mags[:, t_lo] * (1 - frac) + mags[:, t_hi] * frac

    omega = 2 * np.pi * hop * np.arange(spec.shape[-1]) / nfft
    dphase = phases[:, t_hi] - phases[:, t_lo] - omega
    dphase = dphase - 2 * np.pi * np.round(dphase / (2 * np.pi))
    inst_freq = omega + dphase  # per synthesis step

    phase_acc = np.cumsum(np.concatenate([phases[:, t_lo[:1]], inst_freq[:, :-1]], axis=1), axis=1)
    out_spec = mag_i * np.exp(1j * phase_acc)

    # overlap-add synthesis
    out_frames = np.fft.irfft(out_spec, n=nfft, axis=-1) * window
    n_out_frames = out_frames.shape[1]
    out_len = (n_out_frames - 1) * hop + nfft
    out = np.zeros((x.shape[0], out_len))
    norm = np.zeros(out_len)
    for i in range(n_out_frames):
        out[:, i * hop : i * hop + nfft] += out_frames[:, i]
        norm[i * hop : i * hop + nfft] += window**2
    out = out / np.maximum(norm, 1e-8)

    return (out[0] if mono else out).astype(audio.dtype, copy=False)


def pitch_shift(audio: np.ndarray, sr: float, semitones: float) -> np.ndarray:
    """Pitch shift via time stretch + resample (constant duration)."""
    if semitones == 0:
        return audio
    factor = 2.0 ** (semitones / 12.0)
    stretched = time_stretch(audio, 1.0 / factor)
    from math import gcd

    # Resample by 1/factor to restore duration while shifting pitch
    up = int(round(sr))
    down = int(round(sr * factor))
    g = gcd(up, down)
    out = ssignal.resample_poly(stretched, up // g, down // g, axis=-1)
    n = audio.shape[-1]
    if out.shape[-1] < n:
        out = np.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, n - out.shape[-1])])
    return out[..., :n].astype(audio.dtype, copy=False)
