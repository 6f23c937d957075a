"""Occlusion of segments that end at one point (kernel K6).

Counterpart of audiblelight_tpu/ops/star_occlusion.py. The tracer's rain
visibility in the exact mode asks, every bounce, whether the segment from
each hit point to the listener (the rig's centroid, or one capsule) is
blocked. The reference answers with an azimuth cull: project to the
xy-plane about the centre c0; a face whose nearest xy-point to c0 lies at
rho_min >= rho_lim (a narrow face) can only block a segment whose start's
azimuth about c0 lies inside the face's own azimuth window, the circular
hull of its vertex azimuths padded by asin(r_pad / rho_min); faces nearer
the centre (the wide faces) are tested by every segment.

- `build_star_accel`: the reference's route decision, taken the same way
  (a numpy copy of its split, so the tile and wide counts are the
  reference's and it returns None where the reference does), and the star's
  face tree: an any-hit tree (`cuda_kernels.any_hit_tree`) over the faces
  the reference's star tests (finite, area > 0), built once per mesh.
  `star_windows` gives the per-face split and windows.
- `star_segments_occluded`: the glue around the kernel, the segments toward
  the common end formed as the dense any-hit forms them, then one K6 launch
  that walks the tree. The result equals the dense any-hit
  (`geometry.queries.segments_occluded`) on the same segments, boolean for
  boolean.
- `star_segments_occluded_plain`: the same glue around the kernel's plain
  walk (`cuda_kernels.any_hit_walk_plain`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audiblelight_tpu_torch.ops.cuda_kernels import (
    AnyHitTree,
    any_hit_tree,
    any_hit_walk_plain,
    segment_inputs,
    star_any_hit,
)
from audiblelight_tpu_torch.utils import resolve_device

TILE_FACES = 256  # narrow faces per tile of the reference's layout (its tile count)
RHO0 = 0.2  # [m] least xy-distance from the centre of a narrow face
WIDE_FRACTION_MAX = 0.35  # above this share of wide faces the layout does not pay


@dataclass
class StarAccel:
    """Listener-centred occlusion: the star's face tree, on one device, and
    the reference's layout counts."""

    tree: AnyHitTree  # over the star's faces (star_faces)
    center: torch.Tensor  # (3,) the star centre c0
    n_tiles: int  # the reference's narrow tiles
    n_wide: int  # the reference's always-tested (wide) faces
    r_pad: float  # most |segment end - center| the reference's layout holds for

    def __repr__(self):
        return f"StarAccel(tiles={self.n_tiles}, wide={self.n_wide}, r_pad={self.r_pad}, {self.tree})"


def _face_rows(tris: np.ndarray) -> np.ndarray:
    """(F, 9) [a, e1, e2] rows."""
    a = tris[:, 0]
    return np.concatenate([a, tris[:, 1] - a, tris[:, 2] - a], axis=1).astype(np.float32)


def _point_seg_dist2d(p, a, b):
    """Distance from the 2D point p to the segment ab; inputs (..., 2)."""
    ab = b - a
    t = np.clip(np.sum((p - a) * ab, axis=-1) / np.maximum(np.sum(ab * ab, axis=-1), 1e-20), 0.0, 1.0)
    proj = a + t[..., None] * ab
    return np.linalg.norm(p - proj, axis=-1)


def star_faces(tris: np.ndarray) -> np.ndarray:
    """(F,) bool: the faces the reference's star tests, finite (every
    coordinate under 1e8 in size) and of area > 0."""
    tris = np.asarray(tris, dtype=np.float32)
    finite = np.all(np.abs(tris) < 1.0e8, axis=(1, 2))
    area = np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=-1)
    return finite & (area > 0)


def star_windows(tris: np.ndarray, center: np.ndarray, r_pad: float = 0.02):
    """The star's face split about `center` (3,) for segment ends within
    `r_pad` of it: (face rows (F', 9) of the finite, non-degenerate faces of
    `tris` (F, 3, 3), narrow mask (F',), window centres and padded
    half-widths (radians) of the narrow faces in row order), or None when
    no face is left. A narrow face can block only a segment whose start's
    azimuth about the centre lies within its window."""
    tris = np.asarray(tris, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    vt = tris[star_faces(tris)]
    if len(vt) == 0:
        return None

    # Least xy-distance from c0 to each face's xy-triangle (0 if it holds c0)
    c2 = center[:2]
    v2 = vt[..., :2]
    edge_d = np.minimum(np.minimum(_point_seg_dist2d(c2, v2[:, 0], v2[:, 1]),
                                   _point_seg_dist2d(c2, v2[:, 1], v2[:, 2])),
                        _point_seg_dist2d(c2, v2[:, 2], v2[:, 0]))

    def _cross(o, a, b):
        return (a[:, 0] - o[0]) * (b[:, 1] - o[1]) - (a[:, 1] - o[1]) * (b[:, 0] - o[0])

    s0, s1, s2 = _cross(c2, v2[:, 0], v2[:, 1]), _cross(c2, v2[:, 1], v2[:, 2]), _cross(c2, v2[:, 2], v2[:, 0])
    inside = ((s0 >= 0) & (s1 >= 0) & (s2 >= 0)) | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0))
    rho_min = np.where(inside, 0.0, edge_d)
    narrow = rho_min >= max(RHO0, 3.0 * r_pad)
    nf, n_rho = vt[narrow], rho_min[narrow]

    # Narrow windows: the circular hull of the 3 vertex azimuths + the parallax pad
    az = np.arctan2(nf[..., 1] - center[1], nf[..., 0] - center[0])
    azs = np.sort(az, axis=1)
    gaps = np.stack([azs[:, 1] - azs[:, 0], azs[:, 2] - azs[:, 1], 2 * np.pi - (azs[:, 2] - azs[:, 0])], axis=1)
    big = np.argmax(gaps, axis=1)
    span = 2 * np.pi - gaps[np.arange(len(nf)), big]
    # Window centre: the middle of the minor arc (it starts after the largest gap)
    start = np.where(big == 0, azs[:, 1], np.where(big == 1, azs[:, 2], azs[:, 0]))
    cen = np.mod(start + span / 2.0 + np.pi, 2 * np.pi) - np.pi
    half = span / 2.0 + np.arcsin(np.clip(r_pad / n_rho, 0.0, 1.0))
    return _face_rows(vt), narrow, cen, half


def star_tree(tris: np.ndarray, device=None) -> AnyHitTree:
    """The any-hit tree of the star's faces (`star_faces`) of `tris` (F, 3, 3)
    on `device` (the card unless the caller names one); it does not depend
    on the centre, so a mesh builds it once for all its stars."""
    dev = resolve_device(device)
    tris_t = torch.as_tensor(np.asarray(tris, dtype=np.float32), device=dev)
    return any_hit_tree(tris_t, torch.as_tensor(star_faces(tris), device=dev))


def build_star_accel(tris: np.ndarray, center: np.ndarray, r_pad: float = 0.02, device=None,
                     tree: AnyHitTree = None):
    """The star about `center` (3,) of `tris` (F, 3, 3), valid for segment
    ends within `r_pad` of it, on `device` (the card unless the caller names
    one), walking `tree` (`star_tree(tris)`, built here when None). Returns
    None where the reference's layout would not pay (more than
    WIDE_FRACTION_MAX of the faces wide, or no face): callers run the dense
    any-hit, as the reference's do."""
    center = np.asarray(center, dtype=np.float32)
    windows = star_windows(tris, center, r_pad)
    if windows is None:
        return None
    rows, narrow, _, _ = windows
    n_wide = int(np.sum(~narrow))
    if n_wide > WIDE_FRACTION_MAX * len(rows):
        return None
    dev = resolve_device(device)
    return StarAccel(tree=star_tree(tris, dev) if tree is None else tree,
                     center=torch.as_tensor(center, device=dev),
                     n_tiles=max(1, -(-int(np.sum(narrow)) // TILE_FACES)), n_wide=n_wide, r_pad=float(r_pad))


def _star_inputs(starts: torch.Tensor, end: torch.Tensor) -> tuple:
    """(origins, unit directions, lengths) of the segments starts[i] -> end,
    formed as the dense any-hit forms them."""
    starts = torch.atleast_2d(starts).to(torch.float32)
    end = torch.as_tensor(end, dtype=torch.float32, device=starts.device).reshape(1, 3)
    return segment_inputs(starts, end.expand(starts.shape[0], 3))


def star_segments_occluded(accel: StarAccel, starts: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """(R,) bool: the open segment starts[i] -> end is blocked by the mesh.

    The tracer passes the rig's centroid or one capsule as `end` (3,), the
    end point the star was chosen for; the walk itself holds for any end.
    One K6 launch on a CUDA device, its plain walk on the CPU; equals
    `segments_occluded(starts, end, tris)` on the mesh the star was built
    from."""
    return star_any_hit(*_star_inputs(starts, end), accel.tree)


def star_segments_occluded_plain(accel: StarAccel, starts: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """`star_segments_occluded` through the kernel's plain walk (any device)."""
    return any_hit_walk_plain(*_star_inputs(starts, end), accel.tree)[0]


__all__ = ["StarAccel", "build_star_accel", "star_segments_occluded"]
