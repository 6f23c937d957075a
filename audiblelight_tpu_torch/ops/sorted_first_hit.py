"""Cone-sorted, entry-ordered first hit of a ray wavefront (kernel K9).

Counterpart of audiblelight_tpu/ops/sorted_first_hit.py. The route recovers
a BVH's work savings with sorted wavefront coherence:

- `build_sorted_tiles`: the host build, a numpy copy of the reference's, so
  the tables equal the reference's bit for bit: the finite faces of nonzero
  area sorted by centroid Morton code into tiles of SORTED_TILE_FACES rows
  of the dense big first hit's table [e2, w2, -e1, -w1, -n, -k], centred on
  the middle of the valid vertices' bounds, zero rows as padding, one tight
  box per tile. `order` maps a sorted position to the original face.
- `sorted_first_hit`: the glue around the kernel (rays sorted by origin cell
  x direction cone with dead rays last, padding with dead copies of the last
  ray, each block's box over its live rays, the directed entry bound of
  every (block, tile) pair, each block's reachable tiles in ascending bound
  order, the launch, the un-sort). A block stops once every ray's best hit
  precedes the next tile's bound, and the smallest sorted index wins a tie,
  so the result is the dense big first hit over the sorted faces.
- `sorted_walk`: the same glue around the kernel's plain version, and the
  tiles its walk visited per block.

Face indices refer to the Morton-sorted order; dead rays and misses report
(inf, -1). Neither package wires this route into its tracer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from audiblelight_tpu_torch.ops.cuda_kernels import SFH_LANES, SORTED_TILE_FACES, first_hit_sorted, sorted_walk_plain
from audiblelight_tpu_torch.ops.tiled_first_hit import _morton3
from audiblelight_tpu_torch.utils import resolve_device

_EPS = 1e-9
_BIG = 3.0e38
TILE_FACES = SORTED_TILE_FACES

# Sort-key granularity, the reference's: 8 azimuth x 2 elevation bins and
# 4 x 4 x 2 origin cells
AZ_BINS = 8
EL_BINS = 2
CELL_BITS = (2, 2, 1)


@dataclass
class SortedTiles:
    """Morton-tiled big-variant face table and per-tile boxes, tensors on one device."""

    face_tab: torch.Tensor  # (n_tiles * TILE_FACES, 16) centred [e2, w2, -e1, -w1, -n, -k]
    tile_lo: torch.Tensor  # (n_tiles, 3) box minima, centred
    tile_hi: torch.Tensor  # (n_tiles, 3) box maxima, centred
    center: torch.Tensor  # (3,) the centring translation baked into face_tab
    room_lo: torch.Tensor  # (3,) the valid vertices' minima, centred
    room_span: torch.Tensor  # (3,) their extents
    n_tiles: int
    n_faces: int  # valid (sorted) faces, before the padding

    def __repr__(self):
        return f"SortedTiles(tiles={self.n_tiles}, faces={self.n_faces})"


_FIELDS = ("face_tab", "tile_lo", "tile_hi", "center", "room_lo", "room_span")


def sorted_tiles_from_numpy(fields, device) -> SortedTiles:
    """A SortedTiles from a mapping of its fields (arrays and the two
    counts), e.g. the leaves of the reference's build as numpy."""
    dev = torch.device(device)
    # A copy: the reference's arrays come as read-only numpy views
    tensors = {k: torch.tensor(np.asarray(fields[k], dtype=np.float32), device=dev) for k in _FIELDS}
    return SortedTiles(**tensors, n_tiles=int(fields["n_tiles"]), n_faces=int(fields["n_faces"]))


def build_sorted_tiles(tris: np.ndarray, device=None) -> tuple[SortedTiles | None, np.ndarray]:
    """(tiles, order) of `tris` (F, 3, 3), the tensors on `device` (the card
    unless the caller names one): `order` maps a sorted position to the
    original face, so per-face tables permute as `attr[order]`. (None, empty
    order) when no face is finite with nonzero area."""
    tris = np.asarray(tris, dtype=np.float32)
    finite = np.all(np.abs(tris) < 1.0e8, axis=(1, 2))
    area = np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=-1)
    order = np.nonzero(finite & (area > 0))[0]
    if len(order) == 0:
        return None, order
    vt = tris[order]

    cen = vt.mean(axis=1)
    lo = cen.min(axis=0)
    span = np.maximum(cen.max(axis=0) - lo, 1e-6)
    g = np.clip(((cen - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)
    morton = np.argsort(_morton3(g[:, 0], g[:, 1], g[:, 2]), kind="stable")
    vt = vt[morton]
    order = order[morton]

    n = len(vt)
    n_tiles = -(-n // TILE_FACES)
    pad = n_tiles * TILE_FACES - n

    # Centred coordinates bound the f32 cancellation in the precomputed
    # triple-product constants, as in the dense big first hit's table
    vmin = vt.reshape(-1, 3).min(axis=0)
    vmax = vt.reshape(-1, 3).max(axis=0)
    center = 0.5 * (vmin + vmax)

    av = vt[:, 0] - center
    e1 = vt[:, 1] - vt[:, 0]
    e2 = vt[:, 2] - vt[:, 0]
    w1 = np.cross(av, e1)
    w2 = np.cross(av, e2)
    nrm = np.cross(e1, e2)
    kk = np.sum(av * nrm, axis=-1)
    tab = np.concatenate([e2, w2, -e1, -w1, -nrm, -kk[:, None]], axis=1).astype(np.float32)
    tab = np.pad(tab, ((0, pad), (0, 0)))  # zero rows: a = 0, never hit

    vt_c = vt - center
    tl = np.empty((n_tiles, 3), np.float32)
    th = np.empty((n_tiles, 3), np.float32)
    for t in range(n_tiles):
        blk = vt_c[t * TILE_FACES : (t + 1) * TILE_FACES]
        tl[t] = blk.min(axis=(0, 1))
        th[t] = blk.max(axis=(0, 1))

    fields = dict(face_tab=tab, tile_lo=tl, tile_hi=th, center=center.astype(np.float32),
                  room_lo=(vmin - center).astype(np.float32),
                  room_span=np.maximum(vmax - vmin, 1e-6).astype(np.float32), n_tiles=n_tiles, n_faces=n)
    return sorted_tiles_from_numpy(fields, resolve_device(device)), order


def padded_sorted_tris(tris: np.ndarray, order: np.ndarray, n_tiles: int) -> np.ndarray:
    """(n_tiles * TILE_FACES, 3, 3) the faces in sorted order, the face
    indices of both routes refer to, padded with sentinel faces at 1e9: the
    dense big first hit leaves those out of its centre and gives them zero
    rows, so its table over these faces is the tiles' own."""
    vt = np.asarray(tris, dtype=np.float32)[order]
    pad = np.full((n_tiles * TILE_FACES - len(vt), 3, 3), 1.0e9, np.float32)
    return np.concatenate([vt, pad], axis=0)


def _bins(x: torch.Tensor, n: int) -> torch.Tensor:
    """int32(x) clipped to [0, n - 1]; x is clamped to [-1, n] first, so an
    out-of-range value saturates as XLA's conversion does."""
    return x.clamp(-1.0, float(n)).to(torch.int32).clamp(0, n - 1)


def _sort_keys(o_c: torch.Tensor, d: torch.Tensor, alive, tiles: SortedTiles) -> torch.Tensor:
    """(cell, cone) sort keys of the rays; dead rays key past every live group."""
    az = torch.atan2(d[:, 1], d[:, 0])
    azb = _bins((az * (0.5 / math.pi) + 0.5) * AZ_BINS, AZ_BINS)
    elb = _bins((d[:, 2] * 0.5 + 0.5) * EL_BINS, EL_BINS)
    rel = (o_c - tiles.room_lo) / tiles.room_span
    nx, ny, nz = (1 << b for b in CELL_BITS)
    cell = (_bins(rel[:, 0] * nx, nx) * ny + _bins(rel[:, 1] * ny, ny)) * nz + _bins(rel[:, 2] * nz, nz)
    key = (cell * AZ_BINS + azb) * EL_BINS + elb
    if alive is not None:
        key = torch.where(alive, key, nx * ny * nz * AZ_BINS * EL_BINS)
    return key


def _block_tile_bounds(omin, omax, dmin, dmax, tile_lo, tile_hi) -> torch.Tensor:
    """The conservative directed entry bound of every (block, tile) pair,
    (B, T) from block boxes (B, 3) and tile boxes (T, 3): per axis, a tile
    strictly ahead on the + side needs a positive direction and gap / dmax
    of travel (+inf when the cone has none), the - side likewise, an
    overlapping axis 0; the bound is the largest over the axes."""
    gap_pos = tile_lo[None, :, :] - omax[:, None, :]
    gap_neg = omin[:, None, :] - tile_hi[None, :, :]
    dmax_e = dmax[:, None, :]
    dmin_e = dmin[:, None, :]
    t_pos = torch.where(gap_pos > 0.0,
                        torch.where(dmax_e > _EPS, gap_pos / torch.clamp_min(dmax_e, _EPS), math.inf), 0.0)
    t_neg = torch.where(gap_neg > 0.0,
                        torch.where(dmin_e < -_EPS, gap_neg / torch.clamp_min(-dmin_e, _EPS), math.inf), 0.0)
    return torch.maximum(t_pos, t_neg).amax(dim=-1)


def sorted_inputs(tiles: SortedTiles, origins: torch.Tensor, dirs: torch.Tensor, alive: torch.Tensor) -> tuple:
    """(order, o, d, live, perm, dlo, nv) of the kernel for R rays, as the
    reference's glue forms them (sorted_first_hit.py:378-445): a stable sort
    by key, one packed gather, padding to whole blocks of SFH_LANES with dead
    copies of the last ray, each block's box over its live rays, the bounds
    of every (block, tile) pair (+inf for an all-dead block), each block's
    tiles in ascending bound order (stable), and its count of finite
    bounds; the bounds past it read 3e38."""
    r = origins.shape[0]
    o_c = origins - tiles.center
    order = torch.argsort(_sort_keys(o_c, dirs, alive, tiles), stable=True)
    packed = torch.cat([o_c, dirs, alive[:, None].to(torch.float32)], dim=1)[order]
    r_pad = max(SFH_LANES, -(-r // SFH_LANES) * SFH_LANES)
    pad_row = torch.cat([packed[-1:, 0:6], torch.zeros_like(packed[-1:, 6:7])], dim=1)
    packed = torch.cat([packed, pad_row.expand(r_pad - r, 7)], dim=0)
    o, d = packed[:, 0:3].contiguous(), packed[:, 3:6].contiguous()
    live = packed[:, 6].to(torch.int32)

    ob = o.reshape(-1, SFH_LANES, 3)
    db = d.reshape(-1, SFH_LANES, 3)
    lb = live.reshape(-1, SFH_LANES).bool()[..., None]
    big = 1e30
    omin = torch.where(lb, ob, big).amin(dim=1)
    omax = torch.where(lb, ob, -big).amax(dim=1)
    dmin = torch.where(lb, db, big).amin(dim=1)
    dmax = torch.where(lb, db, -big).amax(dim=1)
    dlo = _block_tile_bounds(omin, omax, dmin, dmax, tiles.tile_lo, tiles.tile_hi)
    dlo = torch.where(lb.any(dim=1), dlo, math.inf)
    perm = torch.argsort(dlo, dim=1, stable=True)
    dlo = torch.take_along_dim(dlo, perm, dim=1)
    finite = torch.isfinite(dlo)
    nv = finite.sum(dim=1).to(torch.int32)
    dlo = torch.where(finite, dlo, _BIG).contiguous()
    return order, o, d, live, perm.to(torch.int32).contiguous(), dlo, nv


def _sorted_query(kernel, tiles: SortedTiles, origins, dirs, alive) -> tuple:
    """(t (R,), sorted face (R,), *what else `kernel` returns) in the rays' order."""
    origins = torch.atleast_2d(origins).to(torch.float32)
    dirs = torch.atleast_2d(dirs).to(torch.float32)
    r = origins.shape[0]
    if r == 0:
        return (torch.zeros(0, dtype=torch.float32, device=origins.device),
                torch.zeros(0, dtype=torch.int32, device=origins.device))
    alive = torch.ones(r, dtype=torch.bool, device=origins.device) if alive is None else alive.to(torch.bool)
    order, o, d, live, perm, dlo, nv = sorted_inputs(tiles, origins, dirs, alive)
    t, idx, *extra = kernel(o, d, live, perm, dlo, nv, tiles.face_tab)
    t, idx = t[:r], idx[:r]
    # Misses and dead lanes (whose t is 0) report (inf, -1)
    miss = (t >= _BIG) | (idx < 0)
    t_out = torch.empty_like(t)
    idx_out = torch.empty_like(idx)
    t_out[order] = torch.where(miss, math.inf, t)
    idx_out[order] = torch.where(miss, -1, idx)
    return (t_out, idx_out, *extra)


def sorted_first_hit(tiles: SortedTiles, origins: torch.Tensor, dirs: torch.Tensor, alive=None):
    """First hit (t (R,), sorted face (R,) int32) of each ray against the
    Morton-tiled mesh; `alive` (R,) bool, all live by default. Dead rays and
    misses give (inf, -1). Runs the K9 kernel on a CUDA device and its plain
    version on the CPU; equals the dense big first hit over the sorted faces
    (`build_sorted_tiles`' `order`) bit for bit."""
    return _sorted_query(first_hit_sorted, tiles, origins, dirs, alive)


def sorted_walk(tiles: SortedTiles, origins: torch.Tensor, dirs: torch.Tensor, alive=None):
    """`sorted_first_hit` through the kernel's plain version (any device),
    and the tiles its walk visited per block of SFH_LANES sorted rays:
    (t, face, visited (n_blocks,) int64). A dense walk visits n_tiles."""
    return _sorted_query(sorted_walk_plain, tiles, origins, dirs, alive)
