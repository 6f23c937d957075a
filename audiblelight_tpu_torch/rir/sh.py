"""Real spherical harmonics and the receiver encodings (PyTorch).

Counterpart of audiblelight_tpu/rir/sh.py: the ambisonic layouts (ACN
ordering, SN3D normalisation, AmbiX FOA channels [W, X, Y, Z]) and the
analytic binaural head (Brown-Duda spherical-head shadow, Woodworth ITD).
Coordinates as utils.polar_to_cartesian: +x front, +y left, +z up.

The SH constants are the reference's f32 values (jnp.sqrt of a Python float
rounds to f32 before the division), so the gains agree bit for bit; the
head model's Python-float constants round to f32 where they meet a tensor,
as they do in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from audiblelight_tpu_torch.profiling import count

_S3 = float(np.sqrt(np.float32(3.0)) / np.float32(2.0))
_S5_8 = float(np.sqrt(np.float32(5.0 / 8.0)))
_S15_2 = float(np.sqrt(np.float32(15.0)) / np.float32(2.0))
_S3_8 = float(np.sqrt(np.float32(3.0 / 8.0)))


def sh_real(order: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis values (ACN order, SN3D norm) of (..., 3) unit vectors:
    (..., (order+1)^2), for orders 0..3."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.ones_like(x)]  # ACN 0: W
    if order >= 1:
        comps += [y, z, x]  # ACN 1..3: Y, Z, X
    if order >= 2:
        comps += [
            2.0 * _S3 * x * y,
            2.0 * _S3 * y * z,
            0.5 * (3.0 * z * z - 1.0),
            2.0 * _S3 * x * z,
            _S3 * (x * x - y * y),
        ]
    if order >= 3:
        comps += [
            _S5_8 * y * (3 * x * x - y * y),
            2.0 * _S15_2 * x * y * z,
            _S3_8 * y * (5 * z * z - 1.0),
            0.5 * z * (5 * z * z - 3.0),
            _S3_8 * x * (5 * z * z - 1.0),
            _S15_2 * z * (x * x - y * y),
            _S5_8 * x * (x * x - 3 * y * y),
        ]
    if order > 3:
        raise NotImplementedError("SH orders above 3 are not implemented")
    return torch.stack(comps, dim=-1)


def encoding_channels(encoding: str, cl: int) -> int:
    """Output channels of a tracer encoding: "omni" -> one per capsule,
    "foa" -> 4, "binaural" -> 2, "sh{N}" -> (N+1)^2 for N <= 3."""
    if encoding == "foa":
        return 4
    if encoding == "binaural":
        return 2
    if encoding.startswith("sh"):
        order = int(encoding[2:])
        if not 0 <= order <= 3:
            raise ValueError(f"sh encoding order must be 0..3, got {order}")
        return (order + 1) ** 2
    return cl


def ambisonic_encoding_gains(dirs: torch.Tensor, encode_order: int, encoding: str) -> torch.Tensor:
    """Per-direction ambisonic gains at `encode_order` (clipped to the
    layout's order), zero-padded to the layout's channel count. "foa" permutes
    ACN [W, Y, Z, X] to the FOAListener order [W, X, Y, Z]."""
    c_out = encoding_channels(encoding, 1)
    layout_order = int(round(c_out**0.5)) - 1
    encode_order = max(0, min(int(encode_order), layout_order))
    g = sh_real(encode_order, dirs)
    if g.shape[-1] < c_out:
        g = torch.cat([g, g.new_zeros(g.shape[:-1] + (c_out - g.shape[-1],))], dim=-1)
    if encoding == "foa":
        count("host_syncs")  # the index list's upload from pageable memory waits for the device
        g = g[..., [0, 3, 1, 2]]
    return g


def foa_encoding_gains(dirs: torch.Tensor) -> torch.Tensor:
    """AmbiX (SN3D) first-order gains (W, X, Y, Z) of (..., 3) arrival
    (receiver -> source) directions."""
    sh = sh_real(1, dirs)
    return torch.stack([sh[..., 0], sh[..., 3], sh[..., 1], sh[..., 2]], dim=-1)


def binaural_encoding_gains(dirs: torch.Tensor) -> torch.Tensor:
    """Broadband (..., 2) [left, right] head-shadow gains of (..., 3) arrival
    directions: each ear a cardioid aimed at +-90 degrees azimuth. The
    tracer's binaural encoding uses the frequency-resolved head below."""
    y = dirs[..., 1]
    return torch.stack([0.5 * (1.0 + y), 0.5 * (1.0 - y)], dim=-1)


# Average human head radius (Duda & Martens 1998)
HEAD_RADIUS_M = 0.0875


def spherical_head_gains(dirs: torch.Tensor, freqs, c: float = 343.0,
                         head_radius: float = HEAD_RADIUS_M) -> torch.Tensor:
    """Per-frequency [left, right] magnitude gains of the Brown-Duda
    spherical-head shadow model,

        H(w, theta) = (1 + j alpha(theta) w / (2 w0)) / (1 + j w / (2 w0)),
        w0 = c / a,   alpha(theta) = 1.05 + 0.95 cos(theta * 180 / 150),

    theta the angle between the arrival (receiver -> source) direction and
    the ear axis (+y left, -y right).

    Arguments:
        dirs: (..., 3) unit receiver -> source vectors.
        freqs: (F,) frequencies in Hz.

    Returns (..., 2, F) magnitudes ordered [left, right].
    """
    freqs = torch.as_tensor(freqs, dtype=torch.float32, device=dirs.device)
    w_ratio = (2.0 * math.pi * freqs) * (head_radius / (2.0 * c))  # w / (2 w0)
    y = torch.clamp(dirs[..., 1], -1.0, 1.0)
    return torch.stack([spherical_head_shadow(y, w_ratio), spherical_head_shadow(-y, w_ratio)], dim=-2)


def spherical_head_shadow(cos_to_ear: torch.Tensor, w_ratio: torch.Tensor) -> torch.Tensor:
    """One ear's Brown-Duda shadow magnitude (..., F), from the cosine of the
    angle between the arrival direction and the ear axis (...,) and
    w_ratio = 2 pi f a / (2 c) (F,)."""
    theta = torch.arccos(torch.clamp(cos_to_ear, -1.0, 1.0))
    alpha = 1.05 + 0.95 * torch.cos(theta * (180.0 / 150.0))
    num = 1.0 + (alpha[..., None] * w_ratio) ** 2
    den = 1.0 + w_ratio**2
    return torch.sqrt(num / den)


def woodworth_itd(dirs: torch.Tensor, c: float = 343.0, head_radius: float = HEAD_RADIUS_M) -> torch.Tensor:
    """(..., 2) per-ear arrival-time offsets (seconds) [left, right] from the
    Woodworth formula, to add to the head-centre delay: the near ear leads
    by (a/c) cos(theta), the far ear lags by (a/c)(theta - pi/2) once the
    path wraps the head (theta from the ear axis)."""
    y = torch.clamp(dirs[..., 1], -1.0, 1.0)

    def ear(cos_th):
        theta = torch.arccos(cos_th)
        return (head_radius / c) * torch.where(theta < math.pi / 2.0, -cos_th, theta - math.pi / 2.0)

    return torch.stack([ear(y), ear(-y)], dim=-1)
