"""Level normalisation (counterpart of audiblelight_tpu/ops/scaling.py)."""

from __future__ import annotations

import torch

_TINY32 = float(torch.finfo(torch.float32).tiny)


def normalize_irs(irs: torch.Tensor) -> torch.Tensor:
    """Energy-normalise an IR bank.

    Each IR's energy is sqrt(sum(ir^2)) along the last (sample) axis; IRs are
    divided by the mean energy across the second-to-last axis, so a bank
    shaped (emitters, capsules, samples) is normalised per emitter by its
    mean per-capsule energy.
    """
    e = torch.sqrt(torch.sum(irs.abs() ** 2, dim=-1, keepdim=True)) + _TINY32
    return irs / torch.mean(e, dim=-2, keepdim=True)
