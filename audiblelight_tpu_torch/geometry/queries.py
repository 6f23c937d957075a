"""Batched spatial queries on triangle soups (PyTorch).

Counterpart of audiblelight_tpu/geometry/queries.py. First hit and segment
occlusion go through the tracer's kernels (ops.cuda_kernels): the CUDA kernel
for tensors on the card, its plain PyTorch version for tensors on the CPU.
Point-in-mesh and the nearest-surface distance (placement's validity tests)
are plain PyTorch on either device (the reference has no TPU kernel for
them); they chunk over faces like the reference's XLA path.
"""

from __future__ import annotations

import numpy as np
import torch

from audiblelight_tpu_torch.ops import cuda_kernels
from audiblelight_tpu_torch.utils import dot3

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


def segments_occluded(starts: torch.Tensor, ends: torch.Tensor, tris: torch.Tensor, tree=None) -> torch.Tensor:
    """True where the open segment start->end is blocked by the mesh. (R,) bools.

    A small endpoint margin keeps segments that touch the surface at their
    endpoints (emitters placed on walls) from counting as occluded. `tree` is
    `cuda_kernels.any_hit_tree(tris)`, built once per mesh by callers that
    query it many times.
    """
    return cuda_kernels.segments_occluded(starts, ends, tris, tree)


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


def _point_tri_dist_sq(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distance of points (R, 3) to triangles (Fc, 3) x 3, (R, Fc):
    Ericson's closest-point regions, branch-free, as the reference writes them."""
    ab, ac = b - a, c - a
    ap = p[:, None] - a[None]
    bp = p[:, None] - b[None]
    cp = p[:, None] - c[None]
    d1, d2 = dot3(ab[None], ap), dot3(ac[None], ap)
    d3, d4 = dot3(ab[None], bp), dot3(ac[None], bp)
    d5, d6 = dot3(ab[None], cp), dot3(ac[None], cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    def safe(num, den):
        return num / torch.where(den.abs() > _EPS, den, torch.ones_like(den))

    v_ab = torch.clamp(safe(d1, d1 - d3), 0.0, 1.0)
    w_ac = torch.clamp(safe(d2, d2 - d6), 0.0, 1.0)
    w_bc = torch.clamp(safe(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0, 1.0)
    denom = va + vb + vc
    v_in, w_in = safe(vb, denom), safe(vc, denom)

    closest = a[None] + v_in[..., None] * ab[None] + w_in[..., None] * ac[None]
    for mask, point in (
        ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0), b[None] + w_bc[..., None] * (c - b)[None]),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a[None] + w_ac[..., None] * ac[None]),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a[None] + v_ab[..., None] * ab[None]),
        ((d6 >= 0) & (d5 <= d6), c[None].expand_as(ap)),
        ((d3 >= 0) & (d4 <= d3), b[None].expand_as(ap)),
        ((d1 <= 0) & (d2 <= 0), a[None].expand_as(ap)),
    ):
        closest = torch.where(mask[..., None], point, closest)
    diff = p[:, None] - closest
    return dot3(diff, diff)


def nearest_surface_distance(points: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Distance from each point (R, 3) to the nearest point of the mesh
    surface, (R,) f32, chunked over faces."""
    points = torch.atleast_2d(points).to(torch.float32)
    tris = tris.to(torch.float32)
    best = torch.full((points.shape[0],), float("inf"), dtype=torch.float32, device=points.device)
    # ~16 (R, Fc) temporaries live at once: a sixteenth of the kernels' chunk
    step = max(1, min(tris.shape[0], (cuda_kernels._CHUNK_ELEMS // 16) // max(points.shape[0], 1)))
    for f0 in range(0, tris.shape[0], step):
        t = tris[f0 : f0 + step]
        d2 = _point_tri_dist_sq(points, t[:, 0], t[:, 1], t[:, 2])
        best = torch.minimum(best, d2.amin(dim=1))
    return torch.sqrt(best)
