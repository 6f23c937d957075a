"""FFT convolution: time-invariant (static sources) and time-variant (moving)
(counterpart of audiblelight_tpu/ops/convolve.py).

The time-variant convolution is an ordinary linear convolution ALONG THE
FRAME AXIS between the IR spectrogram bank and the weight-modulated audio
spectrogram, summed over IRs:

    out[i, f, c] = sum_j ( S_ir[:, f, c, j]  *conv_t*  (w[:, j] . S_audio[:, f]) )[i]

computed with batched FFTs over frames.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from audiblelight_tpu_torch import config
from audiblelight_tpu_torch.ops.stft import istft_overlap_add, stft
from audiblelight_tpu_torch.utils import irfft_real


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def fft_convolve(audio: torch.Tensor, irs: torch.Tensor, out_len: Optional[int] = None) -> torch.Tensor:
    """Batched time-invariant convolution of mono audio with an IR bank.

    audio (..., n_samples), irs (..., n_channels, ir_len) -> (..., n_channels,
    out_len); out_len defaults to the full linear length.
    """
    n_samples = audio.shape[-1]
    ir_len = irs.shape[-1]
    full = n_samples + ir_len - 1
    if out_len is None:
        out_len = full
    nfft = _next_pow2(full)
    a_hat = torch.fft.rfft(audio, n=nfft, dim=-1)[..., None, :]
    i_hat = torch.fft.rfft(irs, n=nfft, dim=-1)
    return irfft_real(a_hat * i_hat, nfft)[..., :out_len]


def interpolation_matrix(
    ir_times: np.ndarray,
    sr: float = config.SAMPLE_RATE,
    hop_size: int = config.HOP_SIZE,
    n_frames: Optional[int] = None,
) -> np.ndarray:
    """(n_frames, n_irs) linear crossfade weights between consecutive IRs at
    the frame boundaries of `ir_times` (seconds). Host-side numpy."""
    frames = np.round((np.asarray(ir_times) * sr + hop_size) / hop_size)
    n_frames = n_frames if n_frames is not None else int(frames[-1])
    g_interp = np.zeros((n_frames, len(frames)))
    for ni in range(len(frames) - 1):
        tpts = np.arange(frames[ni], frames[ni + 1] + 1, dtype=int) - 1
        # Ramp over the FULL segment, then truncate to the frame budget, so a
        # clipped segment keeps its crossfade slope.
        ratio = np.linspace(0, 1, len(tpts))
        keep = (tpts >= 0) & (tpts < n_frames)
        tpts, ratio = tpts[keep], ratio[keep]
        if len(tpts) == 0:
            continue
        g_interp[tpts, ni] = 1 - ratio
        g_interp[tpts, ni + 1] = ratio
    return g_interp


def time_variant_convolve_spec(s_audio: torch.Tensor, s_ir: torch.Tensor, w_ir: torch.Tensor) -> torch.Tensor:
    """Convolve a bank of time-varying IR spectrograms with an audio spectrogram.

    s_audio (n_audio_frames, n_freq) complex, s_ir (n_ir_frames, n_freq, n_ch,
    n_irs) complex, w_ir (n_w_frames, n_irs) real -> (n_frames, n_freq, n_ch)
    complex with n_frames = min(n_audio_frames, n_w_frames). One FFT along
    the frame axis (the reference's single-block path).
    """
    n_ir_frames = s_ir.shape[0]
    m = min(s_audio.shape[0], w_ir.shape[0])
    y = w_ir[:m, :, None].to(s_audio.dtype) * s_audio[:m, None, :]  # (m, J, F)
    nfft = _next_pow2(n_ir_frames + m - 1)
    a = torch.fft.fft(s_ir, n=nfft, dim=0)  # (L, F, C, J)
    b = torch.fft.fft(y, n=nfft, dim=0)  # (L, J, F)
    out_hat = torch.einsum("tfcj,tjf->tfc", a, b)
    return torch.fft.ifft(out_hat, dim=0)[:m]


def tv_convolve(
    audio: torch.Tensor,
    irs: torch.Tensor,
    w_ir,
    fft_size: int = config.FFT_SIZE,
    win_size: int = config.WIN_SIZE,
    hop_size: int = config.HOP_SIZE,
) -> torch.Tensor:
    """Moving-source render: STFT -> time-variant convolution -> iSTFT.

    audio (n_samples,), irs (n_ch, n_irs, ir_len) (the trajectory's IRs),
    w_ir (n_w_frames, n_irs) crossfade weights (`interpolation_matrix`) ->
    (n_ch, n_frames * hop - win) wet audio, the reference iSTFT's trim.
    """
    s_ir = stft(irs, fft_size, win_size, hop_size)  # (frames, F, C, J)
    s_audio = stft(audio, fft_size, win_size, hop_size)
    w = torch.as_tensor(w_ir, dtype=torch.float32, device=audio.device)
    return istft_overlap_add(time_variant_convolve_spec(s_audio, s_ir, w), fft_size, win_size, hop_size).T
