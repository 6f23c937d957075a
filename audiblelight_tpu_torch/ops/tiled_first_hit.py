"""Reachability-culled first hit of a bounce wavefront (kernel K7).

Counterpart of audiblelight_tpu/ops/tiled_first_hit.py. The tracer's bounce
loop asks for the first hit of rays whose origins sit on the mesh and whose
directions leave it. This route keeps the dense classic Moller-Trumbore
arithmetic but skips whole (ray block, face tile) pairs:

- `build_mesh_tiles`: the host build, a numpy copy of the reference's, so
  the tables equal the reference's bit for bit: the finite, non-degenerate
  faces sorted by centroid Morton code into tiles of TILE_FACES rows [a, e1,
  e2, original index], one tight AABB per tile.
- `tiled_first_hit`: the glue around the kernel (the octant-major,
  origin-cell-minor ray sort, one packed gather, padding to whole blocks,
  the block boxes `bmeta`, each block's tiles in ascending order of a
  distance lower bound, the launch, the un-sort). A block skips a tile that
  lies behind all its rays on a signed axis and stops once every ray's best
  hit precedes the next tile's bound; the smallest original index wins a
  tie, so the result is the dense first hit on the same faces
  (`cuda_kernels.dense_mt_table`).
- `tiled_walk`: the same glue around the kernel's plain version, which walks
  the same tiles in the same order, and the tiles it tested per block.

The reference runs this route only on a TPU and records it at par with its
dense kernel there (audiblelight_tpu/ops/tiled_first_hit.py:27-34); the port
takes it on every device when `config.USE_TILED_FIRST_HIT` is on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audiblelight_tpu_torch.ops.cuda_kernels import (
    TILED_BLOCK,
    TILED_TILE_FACES,
    first_hit_tiled,
    tiled_walk_plain,
)
from audiblelight_tpu_torch.utils import norm3, resolve_device

_BIG = 3.0e38
TILE_FACES = TILED_TILE_FACES


@dataclass
class MeshTiles:
    """Morton-tiled face layout and per-tile AABBs, tensors on one device."""

    face_tab: torch.Tensor  # (n_tiles * TILE_FACES, 10): [a, e1, e2, orig_idx]
    tile_aabb: torch.Tensor  # (6, n_tiles): xmin ymin zmin xmax ymax zmax
    n_tiles: int
    n_faces: int

    def __repr__(self):
        return f"MeshTiles(tiles={self.n_tiles}, faces={self.n_faces})"


def _morton3(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray) -> np.ndarray:
    """Interleave three 10-bit integer grids into Morton codes."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return spread(ix) | (spread(iy) << np.uint64(1)) | (spread(iz) << np.uint64(2))


def build_mesh_tiles(tris: np.ndarray, device=None) -> MeshTiles | None:
    """The tile layout of `tris` (F, 3, 3), its tensors on `device` (the
    card unless the caller names one); None when no face is finite and
    non-degenerate."""
    tris = np.asarray(tris, dtype=np.float32)
    finite = np.all(np.abs(tris) < 1.0e8, axis=(1, 2))
    area = np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=-1)
    valid = np.nonzero(finite & (area > 0))[0]
    if len(valid) == 0:
        return None
    vt = tris[valid]

    cen = vt.mean(axis=1)
    lo = cen.min(axis=0)
    span = np.maximum(cen.max(axis=0) - lo, 1e-6)
    g = np.clip(((cen - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(g[:, 0], g[:, 1], g[:, 2]), kind="stable")
    vt = vt[order]
    orig = valid[order].astype(np.float32)

    n = len(vt)
    n_tiles = -(-n // TILE_FACES)
    a = vt[:, 0]
    rows = np.zeros((n_tiles * TILE_FACES, 10), np.float32)
    rows[:n, 0:3] = a
    rows[:n, 3:6] = vt[:, 1] - a
    rows[:n, 6:9] = vt[:, 2] - a
    rows[:n, 9] = orig
    rows[n:, 9] = -1.0  # degenerate padding, never hits

    aabb = np.empty((6, n_tiles), np.float32)
    for t in range(n_tiles):
        blk = vt[t * TILE_FACES : (t + 1) * TILE_FACES]
        aabb[0:3, t] = blk.min(axis=(0, 1))
        aabb[3:6, t] = blk.max(axis=(0, 1))

    dev = resolve_device(device)
    return MeshTiles(face_tab=torch.as_tensor(rows, device=dev), tile_aabb=torch.as_tensor(aabb, device=dev),
                     n_tiles=n_tiles, n_faces=int(tris.shape[0]))


def tiled_inputs(tiles: MeshTiles, origins: torch.Tensor, dirs: torch.Tensor) -> tuple:
    """(order, o, d, bmeta, perm, dlo) of the kernel for R rays, as the
    reference's glue forms them (tiled_first_hit.py:304-357).

    Rays sort by direction-sign octant (the high bits: per-block sign
    coherence turns the per-axis constraints on), then by a 16 x 16 x 8 cell
    of the wavefront's own origin box. Padding repeats the last sorted row.
    Each block's tiles sort by the gap between its origin box and the tile's
    box, the distance lower bound `dlo`."""
    r = origins.shape[0]
    lo = origins.amin(dim=0)
    span = torch.clamp_min(origins.amax(dim=0) - lo, 1e-6)
    # Made on the device: a copy from the host would synchronise the stream
    scale = torch.full((3,), 15.999, dtype=torch.float32, device=origins.device)
    scale[2] = 7.999
    cell = ((origins - lo) / span * scale).to(torch.int32)
    octant = ((dirs[:, 0] >= 0).to(torch.int32) + 2 * (dirs[:, 1] >= 0).to(torch.int32)
              + 4 * (dirs[:, 2] >= 0).to(torch.int32))
    key = octant * 2048 + ((cell[:, 0] * 16 + cell[:, 1]) * 8 + cell[:, 2])
    order = torch.argsort(key, stable=True)

    packed = torch.cat([origins, dirs], dim=1)[order]  # one row gather
    r_pad = max(TILED_BLOCK, -(-r // TILED_BLOCK) * TILED_BLOCK)
    packed = torch.cat([packed, packed[-1:].expand(r_pad - r, 6)], dim=0)
    o, d = packed[:, 0:3].contiguous(), packed[:, 3:6].contiguous()

    ob = o.reshape(-1, TILED_BLOCK, 3)
    db = d.reshape(-1, TILED_BLOCK, 3)
    omin, omax = ob.amin(dim=1), ob.amax(dim=1)
    bmeta = torch.cat([omin, omax, db.amin(dim=1), db.amax(dim=1)], dim=1).T.contiguous()

    t_lo = tiles.tile_aabb[0:3].T  # (n_tiles, 3)
    t_hi = tiles.tile_aabb[3:6].T
    gap = torch.clamp_min(torch.maximum(t_lo[None] - omax[:, None], omin[:, None] - t_hi[None]), 0.0)
    dlo = norm3(gap)  # (n_blocks, n_tiles)
    perm = torch.argsort(dlo, dim=1, stable=True)
    dlo_sorted = torch.take_along_dim(dlo, perm, dim=1).contiguous()
    return order, o, d, bmeta, perm.to(torch.int32).contiguous(), dlo_sorted


def _tiled_query(kernel, tiles: MeshTiles, origins, dirs) -> tuple:
    """(t (R,), face (R,), *what else `kernel` returns) in the rays' order."""
    origins = torch.atleast_2d(origins).to(torch.float32)
    dirs = torch.atleast_2d(dirs).to(torch.float32)
    r = origins.shape[0]
    if r == 0:
        return (torch.zeros(0, dtype=torch.float32, device=origins.device),
                torch.zeros(0, dtype=torch.int32, device=origins.device))
    order, o, d, bmeta, perm, dlo = tiled_inputs(tiles, origins, dirs)
    t, idx, *extra = kernel(o, d, bmeta, perm, dlo, tiles.face_tab, tiles.tile_aabb)
    t, idx = t[:r], idx[:r]
    miss = t >= _BIG
    t_out = torch.empty_like(t)
    idx_out = torch.empty_like(idx)
    t_out[order] = torch.where(miss, torch.full_like(t, float("inf")), t)
    idx_out[order] = torch.where(miss, torch.full_like(idx, -1), idx)
    return (t_out, idx_out, *extra)


def tiled_first_hit(tiles: MeshTiles, origins: torch.Tensor, dirs: torch.Tensor):
    """First hit (t (R,), original face (R,) int32) of each ray against the
    tiled mesh: t = +inf and face = -1 where a ray escapes. Runs the K7
    kernel on a CUDA device and its plain version on the CPU; equals the
    dense classic Moller-Trumbore first hit over the original faces."""
    return _tiled_query(first_hit_tiled, tiles, origins, dirs)


def tiled_walk(tiles: MeshTiles, origins: torch.Tensor, dirs: torch.Tensor):
    """`tiled_first_hit` through the kernel's plain version (any device),
    and the tiles its walk tested: (t, face, tiles tested per block of
    TILED_BLOCK sorted rays (n_blocks,) int64). A dense walk would test
    n_tiles per block."""
    return _tiled_query(tiled_walk_plain, tiles, origins, dirs)
