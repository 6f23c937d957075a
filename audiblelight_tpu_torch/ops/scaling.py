"""Level scaling and normalisation on tensors (counterpart of
audiblelight_tpu/ops/scaling.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_TINY32 = float(torch.finfo(torch.float32).tiny)


def apply_snr(x: torch.Tensor, snr) -> torch.Tensor:
    """Scale a signal so that its absolute peak equals `snr`."""
    peak = torch.clamp_min(x.abs().max(), 1e-15)
    return x * snr / peak


def db_to_multiplier(db, x):
    """The multiplier m with 20 log10(m x) ~= db."""
    return 10 ** (db / 20.0) / (x + _TINY32)


def peak_normalize(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Normalise so that max(|x|) == 1, over `axis` (dims kept) or the whole
    tensor."""
    peak = x.abs().max() if axis is None else x.abs().amax(dim=axis, keepdim=True)
    return x / (peak + _TINY32)


def normalize_irs(irs: torch.Tensor) -> torch.Tensor:
    """Energy-normalise an IR bank.

    Each IR's energy is sqrt(sum(ir^2)) along the last (sample) axis; IRs are
    divided by the mean energy across the second-to-last axis, so a bank
    shaped (emitters, capsules, samples) is normalised per emitter by its
    mean per-capsule energy.
    """
    e = torch.sqrt(torch.sum(irs.abs() ** 2, dim=-1, keepdim=True)) + _TINY32
    return irs / torch.mean(e, dim=-2, keepdim=True)


def pad_or_truncate_audio(audio: torch.Tensor, desired_samples: int) -> torch.Tensor:
    """Zero-pad or truncate a (..., samples) tensor to `desired_samples`."""
    n = audio.shape[-1]
    if n < desired_samples:
        return F.pad(audio, (0, desired_samples - n))
    return audio[..., :desired_samples]
