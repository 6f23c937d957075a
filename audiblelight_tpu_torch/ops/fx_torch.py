"""The augmentations' heavy FX in torch on the caller's device (counterpart
of audiblelight_tpu/ops/fx_jax.py).

- the exact one-pole recurrence y[t] = (1 - c) x[t] + c y[t-1] (`onepole`),
  scanned in blocks: a product with the lower-triangular c^(i - j) inside
  each block of 128 samples, then the blocks' carries;
- a biquad by frequency sampling on an nfft grid (`biquad`), whose
  circular-wrap error is bounded by the filter's response beyond 8,192
  samples;
- the feed-forward compressor of `fx_dsp.compress` on two one-poles
  (`compress`, also the limiter's);
- the phase-vocoder time stretch (`time_stretch`, 2,048-point frames, hop
  512) and the windowed-sinc fractional resampler that turns it into a
  pitch shift (`pitch_shift`).

Each takes a numpy array (or a tensor) and `device` (a tensor's own device,
else `device`, default `cuda`) and returns numpy, as fx_jax's do; the
reference buckets shapes to powers of two only to reuse XLA programs, the
port computes the true lengths. Every inverse FFT drops the imaginary parts
of the DC and Nyquist bins first (`utils.irfft_real`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audiblelight_tpu_torch.utils import irfft_real, resolve_device

_NFFT = 2048
_HOP = 512
_RESAMPLE_TAPS = 32
_BLOCK = 128  # the one-pole's block: a (128, 128) product per block


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _tensor(x, device) -> torch.Tensor:
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _numpy(y: torch.Tensor, like) -> np.ndarray:
    return y.cpu().numpy().astype(np.asarray(like).dtype if not isinstance(like, torch.Tensor) else np.float32,
                                  copy=False)


# ---------------------------------------------------------------------------
# Exact one-pole recurrence
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _decays(c: float, size: int, device: torch.device) -> tuple:
    """The block's constants on `device`, float32 from float64 powers: the
    (size, size) lower-triangular L[i, j] = c^(i - j) (transposed, for a
    product from the right) and the carries' weights c^(1..size)."""
    k = torch.arange(size, dtype=torch.float64, device=device)
    lag = k[:, None] - k[None, :]
    decay = torch.where(lag >= 0, c ** lag.clamp_min(0), 0.0)
    return decay.T.to(torch.float32).contiguous(), (c ** (k + 1)).to(torch.float32)


def _recur(b: torch.Tensor, c: float) -> torch.Tensor:
    """y[t] = c y[t-1] + b[t] along the last axis from y[-1] = 0, in blocks
    of _BLOCK samples: inside each block one product with L = c^(i - j);
    across blocks the same recurrence on the blocks' last values with
    c^_BLOCK (blocked again while there are more than _BLOCK blocks), each
    block then given its carry, c^(i + 1) times the previous block's last
    value. float32 products with TF32 off."""
    n = b.shape[-1]
    size = min(_BLOCK, n)
    n_blocks = -(-n // size)
    decay_t, weights = _decays(c, size, b.device)
    x = torch.nn.functional.pad(b, (0, n_blocks * size - n)).reshape(*b.shape[:-1], n_blocks, size)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = torch.matmul(x, decay_t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if n_blocks > 1:
        ends = _recur(y[..., -1], c**size)
        y = y + torch.nn.functional.pad(ends[..., :-1], (1, 0))[..., None] * weights
    return y.reshape(*b.shape[:-1], n_blocks * size)[..., :n]


def onepole(x, coeff: float, device=None) -> torch.Tensor:
    """Exact one-pole smoothing y[t] = (1 - c) x[t] + c y[t-1] along the last
    axis of `x`, returned as a tensor on its device (fx_jax._onepole, which
    scans it with lax.associative_scan): a blocked scan, a handful of
    launches, exact (no truncated impulse response)."""
    x = _tensor(x, device)
    c = np.float32(coeff)
    return _recur(float(np.float32(1.0) - c) * x, float(c))


# ---------------------------------------------------------------------------
# Biquad by frequency sampling
# ---------------------------------------------------------------------------


def _filter_fft(x: torch.Tensor, b, a, n: int, nfft: int) -> torch.Tensor:
    """y = IIR(b, a) * x on an nfft grid, the response evaluated in float32
    in the reference's order of operations."""
    w = float(np.float32(2.0 * np.pi)) * torch.arange(nfft // 2 + 1, dtype=torch.float32, device=x.device) / nfft
    e1 = torch.complex(torch.cos(w), -torch.sin(w))
    e2 = e1 * e1
    b0, b1, b2 = (float(v) for v in np.float32(b))
    a0, a1, a2 = (float(v) for v in np.float32(a))
    h = (b0 + b1 * e1 + b2 * e2) / (a0 + a1 * e1 + a2 * e2)
    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    return irfft_real(spec * h, nfft)[..., :n]


def biquad(audio, b: np.ndarray, a: np.ndarray, device=None) -> np.ndarray:
    """One biquad (coefficients from fx_dsp._biquad_coeffs) along the last axis."""
    n = audio.shape[-1]
    nfft = 2 * _next_pow2(max(n, 8192))
    return _numpy(_filter_fft(_tensor(audio, device), b, a, n, nfft), audio)


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------


def compress(audio, sr: float, threshold_db: float, ratio: float, attack_ms: float, release_ms: float,
             device=None) -> np.ndarray:
    """Feed-forward compressor; the detector and curve of fx_dsp.compress."""
    x = _tensor(audio, device)
    att = np.exp(-1.0 / max(attack_ms * 1e-3 * sr, 1.0))
    rel = np.exp(-1.0 / max(release_ms * 1e-3 * sr, 1.0))
    keep = float(np.float32(1.0) - np.float32(1.0 / max(ratio, 1.0)))
    level_db = 20.0 * torch.log10(onepole(x.abs(), att) + 1e-10)
    gain_db = onepole(-torch.clamp_min(level_db - float(np.float32(threshold_db)), 0.0) * keep, rel)
    return _numpy(x * 10.0 ** (gain_db / 20.0), audio)


# ---------------------------------------------------------------------------
# Phase vocoder: time stretch, and the fractional resampler -> pitch shift
# ---------------------------------------------------------------------------


def _pv_out_frames(n_frames: int, rate: float) -> int:
    """Synthesis frame count: len(np.arange(0, n_frames, rate))."""
    return len(np.arange(0, n_frames, rate))


def _stretch(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Phase-vocoder stretch of (C, n) audio; returns (C, n_out)."""
    dev = x.device
    c, n = x.shape
    n_frames = max(1 + (n - _NFFT) // _HOP, 1)
    pad_len = (n_frames - 1) * _HOP + _NFFT
    xp = torch.nn.functional.pad(x, (0, max(pad_len - n, 0)))[:, :pad_len]
    window = torch.as_tensor(np.hanning(_NFFT), dtype=torch.float32, device=dev)
    frames = xp.unfold(-1, _NFFT, _HOP)[:, :n_frames] * window  # (C, T, nfft)
    spec = torch.fft.rfft(frames, dim=-1)
    mags, phases = spec.abs(), torch.angle(spec)

    t_out = _pv_out_frames(n_frames, rate)
    time_steps = torch.arange(t_out, dtype=torch.float32, device=dev) * float(np.float32(rate))
    last = max(n_frames - 1, 0)
    valid = (time_steps < float(max(n_frames, 1))).to(torch.float32)
    t_lo = torch.floor(time_steps).to(torch.int64).clamp(0, last)
    t_hi = torch.clamp_max(t_lo + 1, last)
    frac = (time_steps - t_lo.to(torch.float32))[None, :, None]
    mag_i = (mags[:, t_lo] * (1 - frac) + mags[:, t_hi] * frac) * valid[None, :, None]

    n_bins = spec.shape[-1]
    omega = (2.0 * np.pi * _HOP * torch.arange(n_bins, dtype=torch.float32, device=dev) / _NFFT).to(torch.float32)
    dphase = phases[:, t_hi] - phases[:, t_lo] - omega
    dphase = dphase - 2.0 * np.pi * torch.round(dphase / (2.0 * np.pi))
    inst_freq = omega + dphase
    # The phase runs to ~1e5 rad in the top bins: accumulated in float64, so
    # that its rounding does not depend on the device's scan order
    steps = torch.cat([phases[:, t_lo[:1]], inst_freq[:, :-1]], dim=1).to(torch.float64)
    phase_acc = torch.remainder(torch.cumsum(steps, dim=1), 2.0 * np.pi)
    out_spec = torch.polar(mag_i.to(torch.float64), phase_acc).to(torch.complex64)
    out_frames = irfft_real(out_spec, _NFFT) * window  # (C, T_out, nfft)

    # Overlap-add as nfft / hop interleaved streams; norm sums window^2 over
    # the valid frames
    n_out = (t_out - 1) * _HOP + _NFFT
    out = torch.zeros((c, n_out + _NFFT), dtype=torch.float32, device=dev)
    norm = torch.zeros((n_out + _NFFT,), dtype=torch.float32, device=dev)
    w2 = (window**2)[None, :] * valid[:, None]  # (T_out, nfft)
    for j in range(_NFFT // _HOP):
        lane = out_frames[:, :, j * _HOP : (j + 1) * _HOP].reshape(c, t_out * _HOP)
        out[:, j * _HOP : (j + t_out) * _HOP] += lane
        norm[j * _HOP : (j + t_out) * _HOP] += w2[:, j * _HOP : (j + 1) * _HOP].reshape(t_out * _HOP)
    return (out / torch.clamp_min(norm, 1e-8))[:, :n_out]


def time_stretch(audio, rate: float, device=None) -> np.ndarray:
    """Phase-vocoder time stretch; rate > 1 shortens. The framing and output
    length of fx_dsp.time_stretch."""
    if rate == 1.0:
        return audio
    x = _tensor(audio, device)
    out = _stretch(x[None] if x.ndim == 1 else x, rate)
    return _numpy(out[0] if x.ndim == 1 else out, audio)


def _frac_resample(x: torch.Tensor, factor: float, out_len: int) -> torch.Tensor:
    """Windowed-sinc fractional resampling of (C, src_len): out[t] = x(t * factor),
    anti-aliasing cutoff 0.92 / max(factor, 1), each output's taps normalised
    to a unit sum."""
    dev = x.device
    src_len = x.shape[-1]
    f32 = float(np.float32(factor))
    pos = torch.arange(out_len, dtype=torch.float32, device=dev) * f32
    i0 = torch.floor(pos).to(torch.int64)
    k = torch.arange(_RESAMPLE_TAPS, device=dev) - (_RESAMPLE_TAPS // 2 - 1)
    idx = i0[:, None] + k[None, :]  # (T, M)
    arg = idx.to(torch.float32) - pos[:, None]
    cutoff = float(np.float32(0.92 / max(factor, 1.0)))
    sinc = cutoff * torch.sinc(cutoff * arg)
    hann = 0.5 + 0.5 * torch.cos(np.pi * arg / (_RESAMPLE_TAPS // 2))
    hann = torch.where(arg.abs() < _RESAMPLE_TAPS // 2, hann, 0.0)
    w = sinc * hann * ((idx >= 0) & (idx < src_len))
    w = w / torch.clamp_min(w.sum(-1, keepdim=True).abs(), 1e-8)
    gathered = x[:, idx.clamp(0, src_len - 1)]  # (C, T, M)
    return torch.einsum("ctm,tm->ct", gathered, w) * (pos < src_len)


def pitch_shift(audio, sr: float, semitones: float, device=None) -> np.ndarray:
    """Pitch shift: the phase-vocoder stretch by 1 / factor, resampled back to
    the input's length (factor = 2^(semitones / 12))."""
    if semitones == 0:
        return audio
    factor = 2.0 ** (semitones / 12.0)
    x = _tensor(audio, device)
    x2 = x[None] if x.ndim == 1 else x
    out = _frac_resample(_stretch(x2, 1.0 / factor), factor, x2.shape[-1])
    return _numpy(out[0] if x.ndim == 1 else out, audio)
