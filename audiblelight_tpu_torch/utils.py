"""Small helpers shared across the port."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present, so a missing card never turns into a silent CPU run.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def polar_to_cartesian(spherical_array: np.ndarray) -> np.ndarray:
    """Convert (azimuth deg, elevation deg, radius) rows to Cartesian rows."""
    sph = np.atleast_2d(np.asarray(spherical_array, dtype=float))
    if not np.all(np.abs(sph[:, 1]) <= 90):
        raise ValueError("Invalid elevation angle: expected values in [-90, 90]")
    az = np.deg2rad(sph[:, 0])
    el = np.deg2rad(sph[:, 1])
    r = sph[:, 2]
    cos_el = np.cos(el)
    return np.column_stack((r * cos_el * np.cos(az), r * cos_el * np.sin(az), r * np.sin(el)))


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, one elementwise op at a time.

    Written out (as jnp.cross and the Pallas kernels are) rather than through
    torch.cross: each product and difference is its own op, so no backend can
    contract them into fused multiply-adds and the rounding matches the
    reference's f32 arithmetic.
    """
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of a * b as ((x0 + x1) + x2), the reference's order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def norm3(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, rounded as jnp.linalg.norm rounds it."""
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)
