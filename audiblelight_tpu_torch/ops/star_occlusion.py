"""Azimuth-culled occlusion of segments that end at one point (kernel K6).

Counterpart of audiblelight_tpu/ops/star_occlusion.py. The tracer's rain
visibility in the exact mode asks, every bounce, whether the segment from
each hit point to the listener (the rig's centroid, or one capsule) is
blocked. Those segments form a star about the centre c0, which admits a cull
no general any-hit query has: project to the xy-plane; a face whose nearest
xy-point to c0 lies at rho_min >= rho_lim (a narrow face) can only block a
segment whose start's azimuth about c0 lies inside the face's own azimuth
window, the circular hull of its vertex azimuths padded by
asin(r_pad / rho_min). Faces nearer the centre (the wide faces) are tested
by every segment.

- `build_star_accel`: the host build, a numpy copy of the reference's, so the
  tables equal the reference's bit for bit: narrow faces sorted by window
  centre into tiles of TILE_FACES with one circular window per tile, and the
  wide faces apart. `star_windows` gives its per-face split and windows.
- `star_segments_occluded`: the glue around the kernel (azimuth sort, one
  packed gather, zero-length padding, per-block azimuth ranges, the launch,
  the un-sort). The result equals the dense any-hit
  (`geometry.queries.segments_occluded`) on the same segments, boolean for
  boolean: the same origins, directions and lengths, the same arithmetic,
  and a conservative cull.
- `star_segments_occluded_plain`: the same glue around the kernel's plain
  version, which runs the same block x tile cull.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audiblelight_tpu_torch.ops.cuda_kernels import STAR_BLOCK, STAR_TILE_FACES, star_any_hit, star_any_hit_plain
from audiblelight_tpu_torch.utils import norm3, resolve_device

_EPS = 1e-9
FACE_GROUP = 8  # the wide table's rows are padded to a multiple of this
TILE_FACES = STAR_TILE_FACES  # narrow faces per cullable tile
RHO0 = 0.2  # [m] least xy-distance from the centre of a narrow face
WIDE_FRACTION_MAX = 0.35  # above this share of wide faces the layout does not pay


@dataclass
class StarAccel:
    """Listener-centred occlusion layout, its tensors on one device."""

    narrow_tab: torch.Tensor  # (n_tiles * TILE_FACES, 9) window-sorted face rows [a, e1, e2]
    tile_meta: torch.Tensor  # (2, n_tiles) [window centre az; padded half-width]
    wide_tab: torch.Tensor  # (F_wide_pad, 9) always-tested face rows
    center: torch.Tensor  # (3,) the star centre c0
    n_tiles: int
    n_wide: int
    r_pad: float  # most |segment end - center| the windows hold for

    def __repr__(self):
        return (f"StarAccel(tiles={self.n_tiles}, narrow={self.narrow_tab.shape[0]}, "
                f"wide={self.n_wide}, r_pad={self.r_pad})")


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


def star_windows(tris: np.ndarray, center: np.ndarray, r_pad: float = 0.02):
    """The star's face split about `center` (3,) for segment ends within
    `r_pad` of it: (face rows (F', 9) of the finite, non-degenerate faces of
    `tris` (F, 3, 3), narrow mask (F',), window centres and padded
    half-widths (radians) of the narrow faces in row order), or None when
    no face is left. A narrow face can block only a segment whose start's
    azimuth about the centre lies within its window."""
    tris = np.asarray(tris, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)

    finite = np.all(np.abs(tris) < 1.0e8, axis=(1, 2))
    area = np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=-1)
    vt = tris[finite & (area > 0)]
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


def build_star_accel(tris: np.ndarray, center: np.ndarray, r_pad: float = 0.02, device=None):
    """The star layout of `tris` (F, 3, 3) about `center` (3,), valid for
    segment ends within `r_pad` of it, with its tensors on `device` (the
    card unless the caller names one). Returns None when the layout would not pay (more than
    WIDE_FRACTION_MAX of the faces wide): callers run the dense any-hit."""
    center = np.asarray(center, dtype=np.float32)
    windows = star_windows(tris, center, r_pad)
    if windows is None:
        return None
    rows, narrow, cen, half = windows
    n_wide = int(np.sum(~narrow))
    if n_wide > WIDE_FRACTION_MAX * len(rows):
        return None
    wide_rows, n_rows = rows[~narrow], rows[narrow]

    order = np.argsort(cen, kind="stable")
    n_rows, cen, half = n_rows[order], cen[order], half[order]
    n_tiles = max(1, -(-len(n_rows) // TILE_FACES))
    n_rows = np.concatenate([n_rows, np.zeros((n_tiles * TILE_FACES - len(n_rows), 9), np.float32)], axis=0)

    # Per-tile circular hull of the member windows: the members span a
    # contiguous arc, unwrapped relative to the tile's first member
    tc = np.empty(n_tiles, np.float32)
    th = np.empty(n_tiles, np.float32)
    for i in range(n_tiles):
        c = cen[i * TILE_FACES : (i + 1) * TILE_FACES]
        h = half[i * TILE_FACES : (i + 1) * TILE_FACES]
        rel = np.mod(c - c[0] + np.pi, 2 * np.pi) - np.pi
        lo, hi = np.min(rel - h), np.max(rel + h)
        tc[i] = np.mod(c[0] + (lo + hi) / 2.0 + np.pi, 2 * np.pi) - np.pi
        th[i] = (hi - lo) / 2.0

    f_wide_pad = max(FACE_GROUP, -(-max(n_wide, 1) // FACE_GROUP) * FACE_GROUP)
    wide_rows = np.concatenate([wide_rows, np.zeros((f_wide_pad - n_wide, 9), np.float32)], axis=0)

    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)  # noqa: E731
    return StarAccel(narrow_tab=t(n_rows), tile_meta=t(np.stack([tc, th])), wide_tab=t(wide_rows),
                     center=t(center), n_tiles=n_tiles, n_wide=n_wide, r_pad=float(r_pad))


def _star_inputs(accel: StarAccel, starts: torch.Tensor, end: torch.Tensor):
    """(order, sorted starts, dirs, lengths, block ranges) of the kernel.

    Segments are sorted by the start's azimuth about the centre, so each
    block of STAR_BLOCK covers a contiguous azimuth range; one packed row
    gather applies the order. The directions and lengths are formed as the
    dense any-hit forms them. Padding repeats the last row with length 0 (an
    empty window), which stays inside the last block's range."""
    r = starts.shape[0]
    c = accel.center
    az = torch.atan2(starts[:, 1] - c[1], starts[:, 0] - c[0])
    order = torch.argsort(az)
    seg = end.expand(r, 3) - starts
    length = norm3(seg)
    dirs = seg / torch.clamp_min(length, _EPS)[:, None]
    packed = torch.cat([starts, dirs, length[:, None], az[:, None]], dim=1)[order]
    r_pad = max(STAR_BLOCK, -(-r // STAR_BLOCK) * STAR_BLOCK)
    pad_rows = packed[-1:].expand(r_pad - r, 8).clone()
    pad_rows[:, 6] = 0.0
    packed = torch.cat([packed, pad_rows], dim=0)
    az_blocks = packed[:, 7].reshape(-1, STAR_BLOCK)
    brange = torch.stack([az_blocks.amin(dim=1), az_blocks.amax(dim=1)]).contiguous()
    return (order, packed[:, 0:3].contiguous(), packed[:, 3:6].contiguous(), packed[:, 6].contiguous(),
            brange)


def _star_query(kernel, accel: StarAccel, starts, end) -> torch.Tensor:
    starts = torch.atleast_2d(starts).to(torch.float32)
    end = torch.as_tensor(end, dtype=torch.float32, device=starts.device).reshape(3)
    r = starts.shape[0]
    if r == 0:
        return torch.zeros(0, dtype=torch.bool, device=starts.device)
    order, o, d, length, brange = _star_inputs(accel, starts, end)
    occ = kernel(o, d, length, brange, accel.narrow_tab, accel.tile_meta, accel.wide_tab, accel.n_wide)
    out = torch.empty(r, dtype=torch.bool, device=starts.device)
    out[order] = occ[:r]
    return out


def star_segments_occluded(accel: StarAccel, starts: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """(R,) bool: the open segment starts[i] -> end is blocked by the mesh.

    `end` (3,) must lie within accel.r_pad of accel.center (the tracer passes
    the rig's centroid or one capsule). Runs the K6 kernel on a CUDA device
    and its plain version on the CPU; equals `segments_occluded(starts, end,
    tris)` on the mesh the layout was built from."""
    return _star_query(star_any_hit, accel, starts, end)


def star_segments_occluded_plain(accel: StarAccel, starts: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """`star_segments_occluded` through the kernel's plain version (any device)."""
    return _star_query(star_any_hit_plain, accel, starts, end)
