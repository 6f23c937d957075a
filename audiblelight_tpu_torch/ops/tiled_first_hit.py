"""First hit of a bounce wavefront on the full mesh in classic
Moller-Trumbore arithmetic (kernel K7).

Counterpart of audiblelight_tpu/ops/tiled_first_hit.py. The tracer's bounce
loop asks for the first hit of rays whose origins sit on the mesh and whose
directions leave it. The reference keeps the dense classic Moller-Trumbore
arithmetic and skips whole (ray block, face tile) pairs on the TPU; the port
keeps its contract (the dense first hit over the same faces, bit for bit)
and culls per ray:

- `build_tiled_tree`: the face tree the kernel walks, built once per mesh
  with torch ops on its device (`cuda_kernels.tiled_face_bvh`): the finite,
  non-degenerate faces' rows [a, e1, e2] in world coordinates.
- `tiled_first_hit`: one launch of the K7 kernel, each ray walking the tree
  (the walk of K1 big, csrc/first_hit_walk.cuh) with the classic
  Moller-Trumbore test at its leaves; no ray sort, no tile sort, no host
  read. The smallest original index wins a tie, so the result is the dense
  first hit over the mesh (`cuda_kernels.ray_first_hit_plain` with
  `cuda_kernels.dense_mt_table`).
- `tiled_walk`: the kernel's plain walk, with each ray's box tests and
  leaves.
- `build_mesh_tiles`: the reference's tile layout (the same faces sorted by
  centroid Morton code into tiles of TILE_FACES rows [a, e1, e2, original
  index], one tight AABB per tile), a numpy copy of its build whose tables
  equal the reference's bit for bit. The kernel reads none of it.

The reference runs this route only on a TPU and records it at par with its
dense kernel there (audiblelight_tpu/ops/tiled_first_hit.py:27-34); the port
takes it on every device when `config.USE_TILED_FIRST_HIT` is on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audiblelight_tpu_torch.ops.cuda_kernels import FaceBVH, first_hit_tiled, tiled_face_bvh, tiled_walk_plain
from audiblelight_tpu_torch.utils import resolve_device

TILE_FACES = 256  # Morton-sorted faces per tile of the reference's layout


@dataclass
class MeshTiles:
    """The reference's Morton-tiled face layout and per-tile AABBs, tensors on one device."""

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


def build_tiled_tree(tris, device=None) -> FaceBVH | None:
    """K7's face tree of `tris` (F, 3, 3), a tensor or an array, on `device`
    (the card unless the caller names one; a tensor's own device when it
    lies there already); None when no face is finite and non-degenerate."""
    tree = tiled_face_bvh(torch.as_tensor(tris, dtype=torch.float32, device=resolve_device(device)))
    return tree if bool((tree.face >= 0).any()) else None


def _rays(origins, dirs) -> tuple:
    return (torch.atleast_2d(origins).to(torch.float32).contiguous(),
            torch.atleast_2d(dirs).to(torch.float32).contiguous())


def tiled_first_hit(tree: FaceBVH, origins: torch.Tensor, dirs: torch.Tensor):
    """First hit (t (R,), original face (R,) int32) of each ray against the
    mesh of `tree` (`build_tiled_tree`): t = +inf and face = -1 where a ray
    escapes. Runs the K7 kernel on a CUDA device (one launch) and its plain
    walk on the CPU; equals the dense classic Moller-Trumbore first hit over
    the original faces."""
    return first_hit_tiled(*_rays(origins, dirs), tree)


def tiled_walk(tree: FaceBVH, origins: torch.Tensor, dirs: torch.Tensor):
    """`tiled_first_hit` through the kernel's plain walk (any device), with
    the walk's counts: (t, face, visits (R, 2) int32 = box tests, leaves
    folded per ray)."""
    return tiled_walk_plain(*_rays(origins, dirs), tree)


__all__ = ["MeshTiles", "build_mesh_tiles", "build_tiled_tree", "tiled_first_hit"]
