"""The yardstick's arithmetic: the card's peaks and the operations and bytes
the cells' work needs, counted from the scenes' own shapes, independent of
how the program does it."""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): float32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def ism_terms(rows: int, emitters: int, n_samples: int, order: int) -> int:
    """(listener, emitter, image, bin) terms of one image-source call: each
    of the 8 (2 order + 1)^3 images of each emitter, at each rfft bin of an
    n_samples IR, for each listener row."""
    return rows * emitters * 8 * (2 * order + 1) ** 3 * (n_samples // 2 + 1)


ISM_FLOPS_PER_TERM = 30  # fp32 operations a term needs: phase, sincos, gain, accumulate


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)
