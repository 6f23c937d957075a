"""Colored noise: Gaussian (1/f)^beta power-law PSD shaping (counterpart of
audiblelight_tpu/ops/noise.py, Timmer & Koenig 1995)."""

from __future__ import annotations

import torch


def powerlaw_psd_gaussian(
    gen: torch.Generator, beta: float, shape: tuple, device=None, fmin: float = 0.0
) -> torch.Tensor:
    """Gaussian (1/f)^beta noise of `shape` (last axis is time), drawn from `gen`.

    Normalised to about unit variance and zero mean. Statistically (not
    draw for draw) equivalent to the reference.
    """
    shape = tuple(shape)
    samples = shape[-1]
    f = torch.fft.rfftfreq(samples, device=device)
    eps = float(torch.finfo(torch.float32).tiny)
    fmin_eff = max(fmin, 1.0 / (samples + eps))
    s_scale = torch.where(f < fmin_eff, torch.full_like(f, fmin_eff), f) ** (-beta / 2.0)
    w = s_scale[1:].clone()
    w[-1] *= (1 + (samples % 2)) / 2.0
    sigma = 2 * torch.sqrt(torch.sum(w**2)) / (samples + eps)

    fshape = shape[:-1] + (f.shape[0],)
    sr = torch.randn(fshape, generator=gen, device=device) * s_scale
    si = torch.randn(fshape, generator=gen, device=device) * s_scale
    if samples % 2 == 0:
        si[..., -1] = 0.0
        sr[..., -1] *= 2.0**0.5
    si[..., 0] = 0.0
    sr[..., 0] *= 2.0**0.5
    y = torch.fft.irfft(torch.complex(sr, si), n=samples, dim=-1)
    return y / sigma
