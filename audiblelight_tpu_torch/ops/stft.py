"""STFT / overlap-add inverse with the sin^2 window (counterpart of
audiblelight_tpu/ops/stft.py).

window = sin(pi n / W)^2, left pad W - H, 2 ceil(S / 2H) + 1 frames, rfft
with backward norm, irfft with forward norm, overlap-add, trim [W : frames*H].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from audiblelight_tpu_torch import config
from audiblelight_tpu_torch.utils import irfft_real


def sin_squared_window(win_size: int, device=None) -> torch.Tensor:
    """w[n] = sin(pi * n / W)^2, in f32."""
    arg = math.pi / win_size * torch.arange(win_size, dtype=torch.float32, device=device)
    # sin of the f32 argument, correctly rounded (evaluated in f64)
    return torch.sin(arg.double()).float() ** 2


def n_stft_frames(n_samples: int, hop_size: int = config.HOP_SIZE) -> int:
    """Number of STFT frames produced for an input of `n_samples` samples."""
    return 2 * int(-(-n_samples // (2 * hop_size))) + 1


def stft(
    y: torch.Tensor,
    fft_size: int = config.FFT_SIZE,
    win_size: int = config.WIN_SIZE,
    hop_size: int = config.HOP_SIZE,
) -> torch.Tensor:
    """STFT of `y` (..., n_samples) along its last axis.

    Returns the complex spectrogram with STFT dims first: (n_frames, n_freq, ...).
    """
    if win_size % hop_size != 0:
        raise ValueError("win_size must be an integer multiple of hop_size")
    n_samples = y.shape[-1]
    n_frames = n_stft_frames(n_samples, hop_size)
    y_padded = F.pad(y, (win_size - hop_size, n_frames * hop_size - n_samples))
    frames = y_padded.unfold(-1, win_size, hop_size)[..., :n_frames, :]  # (..., frames, W)
    window = sin_squared_window(win_size, device=y.device).to(y.dtype)
    spec = torch.fft.rfft(frames * window, n=fft_size, dim=-1, norm="backward")
    return torch.movedim(torch.movedim(spec, -1, 0), -1, 0)


def istft_overlap_add(
    spatial_stft: torch.Tensor,
    fft_size: int = config.FFT_SIZE,
    win_size: int = config.WIN_SIZE,
    hop_size: int = config.HOP_SIZE,
) -> torch.Tensor:
    """Recompose an STFT (n_frames, n_freq, n_ch) into audio by overlap-add.

    Returns (n_frames * hop - win, n_ch).
    """
    n_frames, _, n_ch = spatial_stft.shape
    if fft_size % hop_size != 0:
        raise ValueError("fft_size must be an integer multiple of hop_size")
    k_per_frame = fft_size // hop_size
    frames = irfft_real(spatial_stft, fft_size, dim=1, norm="forward")  # (fr, N, C)
    total = (n_frames + 1) * hop_size + win_size
    chunks = frames.reshape(n_frames, k_per_frame, hop_size, n_ch)
    flat_len = n_frames * hop_size
    out = torch.zeros((total, n_ch), dtype=frames.dtype, device=frames.device)
    for k in range(k_per_frame):
        out[k * hop_size : k * hop_size + flat_len] += chunks[:, k].reshape(flat_len, n_ch)
    return out[win_size : n_frames * hop_size]
