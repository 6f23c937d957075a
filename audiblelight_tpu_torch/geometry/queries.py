"""Batched spatial queries on triangle soups (PyTorch).

Counterpart of audiblelight_tpu/geometry/queries.py. First hit and segment
occlusion go through the tracer's kernels (ops.cuda_kernels): the CUDA kernel
for tensors on the card, its plain PyTorch version for tensors on the CPU.
Point-in-mesh is plain PyTorch on either device (the reference has no TPU
kernel for it); it chunks over faces like the reference's XLA path.
"""

from __future__ import annotations

import numpy as np
import torch

from audiblelight_tpu_torch.ops import cuda_kernels

PAD_DISTANCE = 1.0e9
_EPS = 1.0e-9

# Fixed, slightly irrational ray direction for the parity test: avoids
# axis-aligned edge grazing on axis-aligned architecture meshes.
_PARITY_DIR = np.array([0.57735027, 0.62882718, 0.52019128])
_PARITY_DIR = _PARITY_DIR / np.linalg.norm(_PARITY_DIR)


def ray_mesh_first_hit(origins: torch.Tensor, dirs: torch.Tensor, tris: torch.Tensor, table=None):
    """First-hit distance and face index for rays against the mesh.

    Returns (t, face_idx): t is +inf (and face_idx -1) where a ray escapes.
    `table` is `cuda_kernels.first_hit_table(tris)`, built once per mesh by
    callers that cast many rays at it.
    """
    return cuda_kernels.ray_first_hit(origins, dirs, tris, table)


def segments_occluded(starts: torch.Tensor, ends: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """True where the open segment start->end is blocked by the mesh. (R,) bools.

    A small endpoint margin keeps segments that touch the surface at their
    endpoints (emitters placed on walls) from counting as occluded.
    """
    return cuda_kernels.segments_occluded(starts, ends, tris)


def ray_crossing_counts(points: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Number of mesh crossings of a fixed-direction ray from each point. (R,) int32."""
    points = torch.atleast_2d(points).to(torch.float32)
    d = torch.as_tensor(_PARITY_DIR, dtype=torch.float32, device=points.device).expand_as(points)
    tab = cuda_kernels.mt_face_table(tris)
    counts = torch.zeros(points.shape[0], dtype=torch.int32, device=points.device)
    step = cuda_kernels._face_chunk(points.shape[0], tab.shape[0])
    for f0 in range(0, tab.shape[0], step):
        in_tri, t = cuda_kernels._mt_pair(points, d, tab[f0 : f0 + step].T[:, None, :])
        counts += (in_tri & (t > _EPS)).sum(dim=1, dtype=torch.int32)
    return counts


def points_inside_mesh(points: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Boolean mask: True where each point is inside the (watertight) mesh,
    by ray-crossing parity along a fixed non-axis-aligned direction."""
    return ray_crossing_counts(points, tris) % 2 == 1
