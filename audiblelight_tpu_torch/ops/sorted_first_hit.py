"""First hit of a ray wavefront against the Morton-sorted faces of a mesh
(kernel K9).

Counterpart of audiblelight_tpu/ops/sorted_first_hit.py. The reference
culls per block of 512 cone-sorted rays against Morton tiles of 256 faces;
the port keeps its tiles and its contract and culls per ray:

- `build_sorted_tiles`: the host build, a numpy copy of the reference's, so
  the tables equal the reference's bit for bit: the finite faces of nonzero
  area sorted by centroid Morton code into tiles of SORTED_TILE_FACES rows
  of the dense big first hit's table [e2, w2, -e1, -w1, -n, -k], centred on
  the middle of the valid vertices' bounds, zero rows as padding, one tight
  box per tile. `order` maps a sorted position to the original face. The
  pair-walk first hit (K10, ops/pair_first_hit.py) walks these tiles; they
  carry its tree (`pair_tree`, ops/pair_first_hit.py:build_pair_tree).
- `build_sorted_tree`: the face tree of the tiles' rows (K1 big's tree over
  the sentinel-padded sorted faces, `padded_sorted_tris`), built once per
  tiling; each row reports its sorted index.
- `sorted_first_hit`: one launch of the K9 kernel, one thread per ray
  walking the tree (the centring and the alive mask inside the launch; no
  ray sort, no tile bounds, no host read). The result is the dense big first
  hit over the sorted faces, bit for bit.
- `sorted_walk`: the kernel's plain walk, with each ray's visits.

Face indices refer to the Morton-sorted order; dead rays and misses report
(inf, -1). Neither package wires this route into its tracer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audiblelight_tpu_torch.ops.cuda_kernels import (SORTED_TILE_FACES, FaceBVH, big_face_bvh, first_hit_sorted,
                                                     sorted_walk_plain)
from audiblelight_tpu_torch.ops.tiled_first_hit import _morton3
from audiblelight_tpu_torch.utils import resolve_device

TILE_FACES = SORTED_TILE_FACES


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
    pair_tree: FaceBVH | None = None  # K10's tree of the rows in tile order (build_pair_tree)

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
    unless the caller names one), K10's tree built: `order` maps a sorted
    position to the original face, so per-face tables permute as
    `attr[order]`. (None, empty order) when no face is finite with nonzero
    area."""
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
    tiles = sorted_tiles_from_numpy(fields, resolve_device(device))
    # Imported here: ops/pair_first_hit.py imports this module
    from audiblelight_tpu_torch.ops.pair_first_hit import build_pair_tree

    tiles.pair_tree = build_pair_tree(tiles, tris, order)
    return tiles, order


def padded_sorted_tris(tris: np.ndarray, order: np.ndarray, n_tiles: int) -> np.ndarray:
    """(n_tiles * TILE_FACES, 3, 3) the faces in sorted order, the face
    indices of both routes refer to, padded with sentinel faces at 1e9: the
    dense big first hit leaves those out of its centre and gives them zero
    rows, so its table over these faces is the tiles' own."""
    vt = np.asarray(tris, dtype=np.float32)[order]
    pad = np.full((n_tiles * TILE_FACES - len(vt), 3, 3), 1.0e9, np.float32)
    return np.concatenate([vt, pad], axis=0)


def build_sorted_tree(tiles: SortedTiles, tris: np.ndarray, order: np.ndarray) -> FaceBVH:
    """The face tree K9 walks, over the rows of `tiles.face_tab` (from
    `build_sorted_tiles(tris)`, which gave `order`), on the tiles' device:
    the sentinel-padded sorted faces, centred on `tiles.center`, with K1
    big's keep rule (the zero padding rows are left out), each row reporting
    its sorted index. The dense big first hit's own table over these faces
    is the tiles' table, so this is K1 big's tree over them."""
    padded = torch.as_tensor(padded_sorted_tris(tris, order, tiles.n_tiles), device=tiles.face_tab.device)
    return big_face_bvh(padded, tiles.center, tiles.face_tab)


def _rays(origins, dirs, alive):
    origins = torch.atleast_2d(origins).to(torch.float32).contiguous()
    dirs = torch.atleast_2d(dirs).to(torch.float32).contiguous()
    return origins, dirs, None if alive is None else alive.to(torch.bool).contiguous()


def sorted_first_hit(tiles: SortedTiles, tree: FaceBVH, origins: torch.Tensor, dirs: torch.Tensor, alive=None):
    """First hit (t (R,), sorted face (R,) int32) of each ray against the
    Morton-sorted mesh; `tree` is `build_sorted_tree(tiles, ...)`, `alive`
    (R,) bool, all live by default. Dead rays and misses give (inf, -1). One
    launch of the K9 kernel on a CUDA device, its plain walk on the CPU;
    equals the dense big first hit over the sorted faces (`padded_sorted_tris`)
    bit for bit."""
    return first_hit_sorted(*_rays(origins, dirs, alive), tiles.center, tree)


def sorted_walk(tiles: SortedTiles, tree: FaceBVH, origins: torch.Tensor, dirs: torch.Tensor, alive=None):
    """`sorted_first_hit` through the kernel's plain walk (any device), with
    each ray's visits: (t, face, visits (R, 2) int32 = slab tests, leaves
    folded; 0 for a dead ray)."""
    return sorted_walk_plain(*_rays(origins, dirs, alive), tiles.center, tree)


__all__ = ["SortedTiles", "build_sorted_tiles", "sorted_first_hit", "TILE_FACES"]
