"""The tracer's kernels: wrappers for the CUDA kernels in `csrc/` and their
plain PyTorch versions.

Counterpart of audiblelight_tpu/ops/pallas_kernels.py and
audiblelight_tpu/ops/star_occlusion.py:

- `ray_first_hit`       <- ray_first_hit_pallas (big and small variants)
- `segments_occluded`   <- segments_occluded_pallas
- `deposit_histogram`   <- deposit_histogram_pallas
- `deposit_histogram_foa` <- deposit_histogram_foa_pallas
- `bin_histogram`       <- bin_histogram_pallas
- `star_any_hit`        <- star_segments_occluded's kernel (the glue around
  it, the segments toward the common end, is ops/star_occlusion.py)
- `first_hit_tiled`     <- tiled_first_hit's kernel (its face tree is
  `tiled_face_bvh`)
- `first_hit_mxu`       <- mxu_first_hit's kernel and its glue (the ray
  vectors and the exact plane re-evaluation run inside the launch; the
  tables and the face tree are built by ops/mxu_first_hit.py)
- `first_hit_sorted`    <- sorted_first_hit's kernel and its glue (a per-ray
  walk of the sorted faces' tree in one launch, the centring and the alive
  mask inside it; the tiles and the tree are built by
  ops/sorted_first_hit.py)
- `first_hit_pair`      <- pair_first_hit's kernel and its glue (the
  nearest-tile rounds of each ray, each live tile's subtree walked, in one
  launch; the tiles and their tree are built by ops/sorted_first_hit.py and
  ops/pair_first_hit.py)

Each wrapper prepares its inputs in PyTorch (the same preparation feeds the
kernel and the plain version), then runs the plain version when the tensors
lie on the CPU and launches the kernel when they lie on a CUDA device. There
is no fallback from one to the other. The plain versions write the
arithmetic out component by component, in the order of the Pallas bodies,
and chunk over faces so that no (rays, faces) temporary is built whole.

`launch_counts` counts kernel launches per kernel (only the CUDA branch
counts); `reset_launch_counts` zeroes it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from audiblelight_tpu_torch import config
from audiblelight_tpu_torch.utils import cross3, dot3, norm3

SMALL_F_MAX = 512  # face count at or below which the classic Moller-Trumbore variant runs
_EPS = 1e-9
_BIG = 3.0e38
_IDX_BIG = 1 << 30  # face of a miss in a lexicographic (t, face) fold
_MARGIN = 1e-4
# Elements of one (rays, faces) chunk in the plain versions
_CHUNK_ELEMS = 1 << 22

launch_counts = {"first_hit_big": 0, "first_hit_small": 0, "any_hit": 0, "deposit_histogram": 0,
                 "deposit_histogram_foa": 0, "bin_histogram": 0, "star_any_hit": 0, "first_hit_tiled": 0,
                 "first_hit_mxu": 0, "first_hit_sorted": 0, "first_hit_pair": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _face_chunk(n_rays: int, n_faces: int) -> int:
    return max(1, min(n_faces, _CHUNK_ELEMS // max(n_rays, 1)))


def _check(name: str, x: torch.Tensor, shape: tuple, dtype: torch.dtype, device) -> None:
    if x.dtype == dtype and x.device == device and x.shape == shape and x.is_contiguous():
        return
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _on_card(x: torch.Tensor) -> bool:
    """True when `x` lies on a CUDA device (the kernel route)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not config.USE_CUDA_KERNELS:
        raise RuntimeError("config.USE_CUDA_KERNELS is False: no kernel route for CUDA tensors")
    return True


def _ptr(x: torch.Tensor) -> int:
    """`x`'s address, for an argument that `_lib` declares `c_void_p`."""
    return x.data_ptr()


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on `x`'s card (its raw handle: a tenth of
    the host time of `torch.cuda.current_stream(...).cuda_stream`)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(x.device.index))


_FUNCTIONS: dict = {}


def _lib(name: str, fn: str, layout: list):
    """The ctypes function `fn` of kernel library `name`, with argtypes set."""
    f = _FUNCTIONS.get(fn)
    if f is None:
        from audiblelight_tpu_torch.ops.build import load

        f = getattr(load(name), fn)
        f.argtypes = layout
        f.restype = ctypes.c_int
        _FUNCTIONS[fn] = f
    return f


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# K1: first hit
# ---------------------------------------------------------------------------


def big_face_table(tris: torch.Tensor):
    """The centre and the (F, 16) face table of the big variant, built
    exactly as pallas_kernels.py:248-266 builds them; ray origins are moved
    by the same centre.

    The centre is the middle of the bounds of the REAL vertices: sentinel
    faces at PAD_DISTANCE (1e9) are left out, or they would drag the centre
    away and waste the precision the centring protects. Columns are
    [e2, w2, -e1, -w1, -n, -k] with w_i = A x e_i, n = e1 x e2, k = A . n.
    """
    tris32 = tris.to(torch.float32)
    verts = tris32.reshape(-1, 3)
    fake = ~(verts.abs() < 1.0e8).all(dim=-1, keepdim=True)
    vmin = verts.masked_fill(fake, math.inf).amin(dim=0)
    vmax = verts.masked_fill(fake, -math.inf).amax(dim=0)
    center = torch.where(torch.isfinite(vmin + vmax), 0.5 * (vmin + vmax), torch.zeros_like(vmin))
    av = tris32[:, 0] - center
    e1 = tris32[:, 1] - tris32[:, 0]
    e2 = tris32[:, 2] - tris32[:, 0]
    w1 = cross3(av, e1)
    w2 = cross3(av, e2)
    nrm = cross3(e1, e2)
    kk = dot3(av, nrm)
    tab = torch.cat([e2, w2, -e1, -w1, -nrm, -kk[:, None]], dim=1).contiguous()
    return center, tab


def mt_face_table(tris: torch.Tensor) -> torch.Tensor:
    """(F, 9) face table [a, e1, e2] of the classic Moller-Trumbore bodies."""
    tris32 = tris.to(torch.float32)
    return torch.cat(
        [tris32[:, 0], tris32[:, 1] - tris32[:, 0], tris32[:, 2] - tris32[:, 0]], dim=1
    ).contiguous()


# The face trees of the first hits K1 big, K7 and K8 (csrc/first_hit_walk.cuh)
# and of the any-hits K2 and K6 (csrc/any_hit_walk.cuh): leaves of
# BVH_LEAF_FACES consecutive Morton-sorted faces, a complete binary tree over
# them. Each box is padded by BVH_PAD metres plus BVH_PAD_REL of its
# coordinate's magnitude (~8 f32 ulps), so that a hit the pair arithmetic
# finds lies inside the boxes of its face's leaf and of every ancestor
# (tests/test_torch_{first_hit_accel,tiled_first_hit,mxu_first_hit,
# any_hit_accel}.py hold the margin for each kernel's arithmetic).
BVH_LEAF_FACES = 4  # small leaves: a box test costs less than a leaf row's pair test
BVH_MAX_DEPTH = 30  # kStack in csrc/face_tree.cuh: levels of internal nodes a walk can stack
BVH_PAD = 1.0e-3
BVH_PAD_REL = 1.0e-6
_SLAB_TINY = 1.0e-20  # a direction component under this in size counts as +-1e-20 in the slab test


@dataclass
class FaceBVH:
    """A face tree, tensors on one device, in the frame its walk uses (K1
    big's and K8's centred coordinates, K7's and the any-hits' world
    coordinates). Nodes are in
    heap order: node 1 is the root, node i has the children 2i and 2i + 1,
    and leaf j is node n_leaves + j; node 0 and the leaves past the last face
    are empty (lo = +inf, hi = -inf)."""

    rows: torch.Tensor  # (n_leaves * leaf_faces, W) the table's rows in leaf order; zero rows pad the last leaf
    face: torch.Tensor  # (n_leaves * leaf_faces,) int32 original face of each row, -1 on padding
    boxes: torch.Tensor  # (2 * n_leaves, 8) padded node boxes [lo x, y, z, 0, hi x, y, z, 0]
    n_leaves: int  # a power of two
    leaf_faces: int  # rows per leaf

    def __repr__(self):
        return f"FaceBVH(faces={int((self.face >= 0).sum())}, leaves={self.n_leaves} of {self.leaf_faces})"


def _morton_spread(v: torch.Tensor) -> torch.Tensor:
    """The 10 low bits of `v` (int64) spread to every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def build_face_bvh(verts: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor, ids: torch.Tensor = None,
                   in_order: bool = False) -> FaceBVH:
    """The face tree over the faces `keep` (F,) bool of the triangles `verts`
    (F, 3, 3), in the frame the walk uses, gathering their `rows` (F, W) of
    the kernel's face table; each row reports its index into `rows`, or its
    entry of `ids` (F,) int32 where given. Built with torch ops on the
    tensors' device, the same bits on every device.

    The kept faces are sorted by the 30-bit Morton code of their centroid
    (stable: ties keep the face order), cut into leaves of BVH_LEAF_FACES
    rows, and the leaf count padded to a power of two with empty leaves;
    boxes are the leaves' vertex bounds, padded, and each parent's the union
    of its children's. With `in_order` every row keeps its place (row j in
    leaf j // BVH_LEAF_FACES, no sort): a row left out by `keep` reports -1
    and adds nothing to its leaf's box."""
    dev, leaf_faces = rows.device, BVH_LEAF_FACES
    idx = torch.arange(rows.shape[0], device=dev) if in_order else torch.nonzero(keep).squeeze(1)
    vc = verts[idx]
    cen = vc[:, 0] + vc[:, 1] + vc[:, 2]  # 3x the centroid: the scale drops out of the grid
    if idx.numel() and not in_order:
        lo, hi = cen.amin(dim=0), cen.amax(dim=0)
        span = torch.clamp_min(hi - lo, 1e-6)
        q = torch.clamp((cen - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)
        code = _morton_spread(q[:, 0]) | (_morton_spread(q[:, 1]) << 1) | (_morton_spread(q[:, 2]) << 2)
        perm = torch.sort(code, stable=True).indices
        idx, vc = idx[perm], vc[perm]
    n = idx.numel()
    n_leaves = 1 << max(0, math.ceil(math.log2(max(1, -(-n // leaf_faces)))))
    cap = n_leaves * leaf_faces
    leaf_rows = torch.zeros((cap, rows.shape[1]), dtype=torch.float32, device=dev)
    leaf_rows[:n] = rows[idx]
    face = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    face[:n] = (idx if ids is None else ids[idx]).to(torch.int32)

    v_lo = torch.full((cap, 3), math.inf, dtype=torch.float32, device=dev)
    v_hi = torch.full((cap, 3), -math.inf, dtype=torch.float32, device=dev)
    v_lo[:n] = vc.amin(dim=1)
    v_hi[:n] = vc.amax(dim=1)
    if in_order:
        face[:n] = torch.where(keep, face[:n], -1)
        v_lo[:n] = torch.where(keep[:, None], v_lo[:n], math.inf)
        v_hi[:n] = torch.where(keep[:, None], v_hi[:n], -math.inf)
    lo = v_lo.view(n_leaves, leaf_faces, 3).amin(dim=1)
    hi = v_hi.view(n_leaves, leaf_faces, 3).amax(dim=1)
    full = torch.isfinite(lo)  # empty leaves stay (+inf, -inf)
    lo = torch.where(full, lo - (BVH_PAD + BVH_PAD_REL * lo.abs()), lo)
    hi = torch.where(full, hi + (BVH_PAD + BVH_PAD_REL * hi.abs()), hi)
    levels = [(lo, hi)]
    while levels[-1][0].shape[0] > 1:
        c_lo, c_hi = levels[-1]
        levels.append((c_lo.view(-1, 2, 3).amin(dim=1), c_hi.view(-1, 2, 3).amax(dim=1)))
    node_lo = torch.cat([torch.full((1, 3), math.inf, device=dev)] + [lv[0] for lv in reversed(levels)])
    node_hi = torch.cat([torch.full((1, 3), -math.inf, device=dev)] + [lv[1] for lv in reversed(levels)])
    zero = torch.zeros((2 * n_leaves, 1), dtype=torch.float32, device=dev)
    boxes = torch.cat([node_lo, zero, node_hi, zero], dim=1).contiguous()
    return FaceBVH(rows=leaf_rows, face=face, boxes=boxes, n_leaves=n_leaves, leaf_faces=leaf_faces)


def big_keep(tab: torch.Tensor) -> torch.Tensor:
    """(F,) bool the rows of a big table `tab` (F, 16) that can hit: not a
    zero normal (the 1e9 sentinels, degenerate faces, the zero rows that pad
    a table: a = 0 makes u infinite or NaN) and no non-finite entry."""
    return (tab[:, 12:15] != 0).any(dim=1) & torch.isfinite(tab).all(dim=1)


def big_face_bvh(tris: torch.Tensor, center: torch.Tensor, tab: torch.Tensor) -> FaceBVH:
    """K1 big's face tree over its table `tab` (`big_face_table`), in centred
    coordinates; the faces whose row can never hit (`big_keep`) are left out."""
    return build_face_bvh(tris.to(torch.float32) - center, tab, big_keep(tab))


def big_first_hit_table(tris: torch.Tensor) -> tuple:
    """("big", centre, face table, face tree) of `tris` at any face count."""
    center, tab = big_face_table(tris)
    return "big", center, tab, big_face_bvh(tris, center, tab)


def first_hit_table(tris: torch.Tensor, tree: "AnyHitTree" = None) -> tuple:
    """(variant, centre or None, face table, face tree) of the first-hit
    kernel for `tris` (F, 3, 3): for more than SMALL_F_MAX faces the big
    variant's table and `FaceBVH`; else the classic rows and the mesh's
    any-hit tree (`any_hit_tree(tris)`, or `tree` where the caller caches
    one), which K1 small walks. A caller that casts many rays at one mesh
    builds it once and passes it to every `ray_first_hit` call."""
    if tris.shape[0] <= SMALL_F_MAX:
        return "small", None, mt_face_table(tris), any_hit_tree(tris) if tree is None else tree
    return big_first_hit_table(tris)


def _first_hit_inputs(origins, dirs, tris, table):
    """(variant, origins, dirs, face table, face tree or None) for the
    first-hit kernel or plain body."""
    variant, center, tab, bvh = first_hit_table(tris) if table is None else table
    o = torch.atleast_2d(origins).to(torch.float32)
    if center is not None:
        o = o - center
    return variant, o.contiguous(), torch.atleast_2d(dirs).to(torch.float32).contiguous(), tab, bvh


def _fold_min(best_t, best_i, t_hit, f0):
    """Min over one face chunk; the first (smallest) face index wins ties,
    and an earlier chunk keeps a tie with a later one."""
    tmin, arg = t_hit.min(dim=1)
    better = tmin < best_t
    return torch.where(better, tmin, best_t), torch.where(better, arg.to(torch.int32) + f0, best_i)


def _plucker(o, d):
    """Ray components and the Plucker moment o x d, each (..., 1) of `o`, `d`
    (..., 3): (ox, oy, oz, dx, dy, dz, odx, ody, odz)."""
    ox, oy, oz = o[..., 0:1], o[..., 1:2], o[..., 2:3]
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    return ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx


def _bilinear_pair(ray, c):
    """The big variant's test of rays `ray` (from `_plucker`) against face
    rows c = (16, ...) that broadcast against them: (inside the window with
    t > 1e-9, t), as csrc/bilinear_pair.cuh writes it, term for term."""
    ox, oy, oz, dx, dy, dz, odx, ody, odz = ray
    u_num = (odx * c[0] + ody * c[1] + odz * c[2]) + (dx * c[3] + dy * c[4] + dz * c[5])
    v_num = (odx * c[6] + ody * c[7] + odz * c[8]) + (dx * c[9] + dy * c[10] + dz * c[11])
    a = dx * c[12] + dy * c[13] + dz * c[14]
    t_num = c[15] - (ox * c[12] + oy * c[13] + oz * c[14])
    inv = 1.0 / a
    u = u_num * inv
    v = v_num * inv
    t = t_num * inv
    return (u >= -_EPS) & (u <= 1.0 + _EPS) & (v >= -_EPS) & (u + v <= 1.0 + _EPS) & (t > _EPS), t


def _first_hit_big_plain(o, d, tab):
    """Plain version of _first_hit_big_kernel on centred origins `o`."""
    r, f = o.shape[0], tab.shape[0]
    ray = _plucker(o, d)
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    step = _face_chunk(r, f)
    for f0 in range(0, f, step):
        hit, t = _bilinear_pair(ray, tab[f0 : f0 + step].T[:, None, :])  # faces (16, 1, Fc)
        best_t, best_i = _fold_min(best_t, best_i, torch.where(hit, t, _BIG), f0)
    return best_t, best_i


def slab_inverse(d: torch.Tensor) -> torch.Tensor:
    """1 / d per component as the face tree's slab test takes it: a
    component under 1e-20 in size counts as +-1e-20 (its sign kept), so no
    product in the slab test is 0 * inf."""
    return 1.0 / torch.where(d.abs() < _SLAB_TINY, torch.copysign(torch.full_like(d, _SLAB_TINY), d), d)


def slab_entry_exit(o: torch.Tensor, inv: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> tuple:
    """(entry, exit) of rays o + s d, s >= 0, into boxes [lo, hi] (shapes
    (..., 3) that broadcast; `inv` from `slab_inverse`), as csrc/first_hit.cu's
    `slab` computes them, term for term: per axis the near and the far plane
    by the sign of inv, entry the largest near distance and 0, exit the
    smallest far one. The walk enters a node where entry <= exit and entry
    <= the ray's best t so far. An empty box (+inf, -inf) gives entry +inf."""
    pos = inv >= 0
    t_near = (torch.where(pos, lo, hi) - o) * inv
    t_far = (torch.where(pos, hi, lo) - o) * inv
    entry = torch.maximum(torch.maximum(t_near[..., 0], t_near[..., 1]),
                          torch.clamp_min(t_near[..., 2], 0.0))
    exit_ = torch.minimum(torch.minimum(t_far[..., 0], t_far[..., 1]), t_far[..., 2])
    return entry, exit_


def _first_hit_walk_plain(o, d, bvh: FaceBVH, pair, best: tuple = None, feed=None):
    """The face-tree walk of csrc/first_hit_walk.cuh for every ray at once,
    in the kernels' order (the nearer child first, the farther pushed with
    its entry and skipped at its pop once the best t precedes it; a leaf's
    rows folded by (t, original face)): (t, face, visits (R, 2) int32 = slab
    tests, leaves folded), a miss as (inf, -1). A ray with a non-finite
    component is a miss without a walk. `pair(rays, rows, faces)` is the
    kernel's leaf test of the rays `rays` (n,) (indices into `o`) against
    their leaf's rows (n, leaf_faces, W) of original faces `faces` (n,
    leaf_faces): (hit, t), each (n, leaf_faces). The fold starts from `best`
    ((t, face) (R,), 3e38 and 2**30 for none) where given. Each ray walks
    from node 1, or, with `feed`, from each root that `feed(rays, best_t,
    best_i)` gives the rays `rays` (n,) in turn ((n,) int64, 0 where a ray
    has none left), asked when a ray's walk from its last root is done:
    csrc/first_hit_walk.cuh's `walk_roots` (K10's tile subtrees)."""
    r, dev = o.shape[0], o.device
    n_leaves = bvh.n_leaves
    lo, hi = bvh.boxes[:, 0:3], bvh.boxes[:, 4:7]
    finite = torch.isfinite(o).all(dim=1) & torch.isfinite(d).all(dim=1)
    o = torch.where(finite[:, None], o, 0.0)
    d = torch.where(finite[:, None], d, 1.0)
    inv = slab_inverse(d)
    if best is None:
        best_t = torch.full((r,), _BIG, dtype=torch.float32, device=dev)
        best_i = torch.full((r,), _IDX_BIG, dtype=torch.int32, device=dev)
    else:
        best_t, best_i = (x.clone() for x in best)
    if feed is None:
        entry, exit_ = slab_entry_exit(o, inv, lo[1], hi[1])
        node = torch.where(finite & (entry <= exit_), 1, 0)
        nodes = finite.to(torch.int32)
    else:
        node = torch.zeros(r, dtype=torch.int64, device=dev)
        nodes = torch.zeros(r, dtype=torch.int32, device=dev)
        fed = finite.clone()  # rays that may have a root left
    leaves = torch.zeros(r, dtype=torch.int32, device=dev)
    stack_n = torch.zeros((r, BVH_MAX_DEPTH), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((r, BVH_MAX_DEPTH), dtype=torch.float32, device=dev)
    sp = torch.zeros(r, dtype=torch.int64, device=dev)
    lanes = torch.arange(bvh.leaf_faces, device=dev)
    while True:
        while True:  # pop until an entry does not pass the best t, or the stack is empty; then the next root
            pop = torch.nonzero((node == 0) & (sp > 0)).squeeze(1)
            if pop.numel():
                sp[pop] -= 1
                keep = stack_t[pop, sp[pop]] <= best_t[pop]
                node[pop] = torch.where(keep, stack_n[pop, sp[pop]], 0)
                continue
            if feed is None:
                break
            ask = torch.nonzero((node == 0) & fed).squeeze(1)
            if ask.numel() == 0:
                break
            root = feed(ask, best_t[ask], best_i[ask])
            fed[ask[root == 0]] = False
            ask, root = ask[root > 0], root[root > 0]
            entry, exit_ = slab_entry_exit(o[ask], inv[ask], lo[root], hi[root])
            nodes[ask] += 1
            node[ask] = torch.where(entry <= exit_, root, 0)
        leaf = torch.nonzero(node >= n_leaves).squeeze(1)
        inner = torch.nonzero((node > 0) & (node < n_leaves)).squeeze(1)
        if leaf.numel() == 0 and inner.numel() == 0:
            break
        if leaf.numel():
            row = (node[leaf] - n_leaves)[:, None] * bvh.leaf_faces + lanes  # (n, leaf_faces)
            f = bvh.face[row]
            hit, t = pair(leaf, bvh.rows[row], f)
            ok = hit & (t < _BIG) & (f >= 0)
            t = torch.where(ok, t, _BIG)
            f = torch.where(ok, f, _IDX_BIG)
            t_min = t.amin(dim=1)
            f_min = torch.where(t == t_min[:, None], f, _IDX_BIG).amin(dim=1)
            best_t[leaf], best_i[leaf] = _lex_min(best_t[leaf], best_i[leaf], t_min, f_min)
            leaves[leaf] += 1
            node[leaf] = 0
        if inner.numel():
            c0 = node[inner] * 2
            e0, x0 = slab_entry_exit(o[inner], inv[inner], lo[c0], hi[c0])
            e1, x1 = slab_entry_exit(o[inner], inv[inner], lo[c0 + 1], hi[c0 + 1])
            nodes[inner] += 2
            bt = best_t[inner]
            v0 = (e0 <= x0) & (e0 <= bt)
            v1 = (e1 <= x1) & (e1 <= bt)
            both = v0 & v1
            second = e1 < e0  # the nearer child first; child 2i on a tie
            push = inner[both]
            stack_n[push, sp[push]] = torch.where(second, c0, c0 + 1)[both]
            stack_t[push, sp[push]] = torch.where(second, e0, e1)[both]
            sp[push] += 1
            node[inner] = torch.where(both, torch.where(second, c0 + 1, c0),
                                      torch.where(v0, c0, torch.where(v1, c0 + 1, 0)))
    return (*_finish_first_hit(best_t, best_i), torch.stack([nodes, leaves], dim=1))


def _bilinear_leaf(o, d):
    """K1 big's leaf test (csrc/first_hit.cu:BilinearLeaf) for `_first_hit_walk_plain`."""
    ray = _plucker(o, d)

    def pair(rays, rows, faces):
        return _bilinear_pair(tuple(x[rays] for x in ray), rows.permute(2, 0, 1))

    return pair


def _mt_pair(o, d, c):
    """Classic Moller-Trumbore for rays (R, 1) x faces c = (9, 1, Fc):
    (inside the window, t), as the Pallas small and any-hit bodies write it."""
    return _mt_pair_xyz(o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3], c)


def _mt_pair_xyz(ox, oy, oz, dx, dy, dz, c):
    """`_mt_pair` on ray components and face rows c = (9, ...) that
    broadcast against them (csrc/mt_pair.cuh, term for term)."""
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = c[:9]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    valid_a = a.abs() > _EPS
    inv = 1.0 / torch.where(valid_a, a, torch.ones_like(a))
    sx = ox - ax
    sy = oy - ay
    sz = oz - az
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    in_tri = valid_a & (u >= -_EPS) & (u <= 1.0 + _EPS) & (v >= -_EPS) & (u + v <= 1.0 + _EPS)
    return in_tri, t


def _first_hit_small_plain(o, d, tab):
    """The dense classic Moller-Trumbore first hit over every row of `tab`
    (F, >= 9) in order, as the Pallas small body computes it: K1 small's
    exactness reference and its CPU path."""
    r, f = o.shape[0], tab.shape[0]
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    step = _face_chunk(r, f)
    for f0 in range(0, f, step):
        in_tri, t = _mt_pair(o, d, tab[f0 : f0 + step, :9].T[:, None, :])
        best_t, best_i = _fold_min(best_t, best_i, torch.where(in_tri & (t > _EPS), t, _BIG), f0)
    return best_t, best_i


def _finish_first_hit(best_t, best_i):
    miss = best_t >= _BIG
    return (
        torch.where(miss, torch.full_like(best_t, math.inf), best_t),
        torch.where(miss, torch.full_like(best_i, -1), best_i),
    )


def ray_first_hit_plain(origins, dirs, tris, table=None):
    """Plain PyTorch version of `ray_first_hit` (any device): the dense walk
    over every face in order."""
    variant, o, d, tab, _ = _first_hit_inputs(origins, dirs, tris, table)
    body = _first_hit_big_plain if variant == "big" else _first_hit_small_plain
    return _finish_first_hit(*body(o, d, tab))


def _launch_first_hit(variant, o, d, tree, visits=None):
    """One launch of the first-hit kernel of `variant` on card tensors:
    K1 big walks its `FaceBVH`, K1 small the mesh's `AnyHitTree`."""
    if tree is None:
        raise ValueError(f"the {variant} first hit on the card walks a face tree: the table carries none "
                         "(first_hit_table builds one; dense_mt_table is the plain oracle's)")
    if variant == "small":
        return _launch_small(o, d, tree, visits)
    return _launch_walk("first_hit_big", 16, o, d, tree, visits)


def _launch_small(o, d, tree: "AnyHitTree", visits=None) -> tuple:
    """One launch of K1 small on card tensors: the walk of the mesh's any-hit
    tree (each block staging it into shared memory), its always-tested rows
    folded first."""
    r, dev = o.shape[0], o.device
    bvh = tree.bvh
    n_leaves, n_always = bvh.n_leaves, tree.always.shape[0]
    if n_leaves.bit_length() - 1 > BVH_MAX_DEPTH:
        raise ValueError(f"first_hit_small: a tree of {n_leaves} leaves is deeper than {BVH_MAX_DEPTH} levels")
    _check("origins", o, (r, 3), torch.float32, dev)
    _check("dirs", d, (r, 3), torch.float32, dev)
    _check("tree rows", bvh.rows, (n_leaves * bvh.leaf_faces, MT_ROW), torch.float32, dev)
    _check("tree faces", bvh.face, (n_leaves * bvh.leaf_faces,), torch.int32, dev)
    _check("tree boxes", bvh.boxes, (2 * n_leaves, 8), torch.float32, dev)
    _check("always-tested rows", tree.always, (n_always, MT_ROW), torch.float32, dev)
    _check("always-tested faces", tree.always_face, (n_always,), torch.int32, dev)
    if visits is not None:
        _check("visits", visits, (r, 2), torch.int32, dev)
    t = o.new_empty(r)
    idx = o.new_empty(r, dtype=torch.int32)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("first_hit", "first_hit_small", [vp] * 7 + [ci] * 4 + [vp, vp, vp, vp])
    launch_counts["first_hit_small"] += 1
    err = fn(_ptr(o), _ptr(d), _ptr(bvh.rows), _ptr(bvh.face), _ptr(bvh.boxes), _ptr(tree.always),
             _ptr(tree.always_face), r, n_leaves, bvh.leaf_faces, n_always, _ptr(t), _ptr(idx),
             ctypes.c_void_p(0 if visits is None else visits.data_ptr()), _stream(o))
    _raise_on(err, "first_hit_small")
    return t, idx


_WALK_SOURCES = {"first_hit_big": "first_hit", "first_hit_tiled": "tiled_first_hit", "first_hit_mxu": "mxu_first_hit",
                 "first_hit_sorted": "sorted_first_hit"}


def _launch_walk(name: str, row_width: int, o, d, bvh: FaceBVH, visits, *head) -> tuple:
    """One launch of the first-hit walk kernel `name` (K1 big, K7 or K8,
    csrc/first_hit_walk.cuh) on card tensors, the tree's rows `row_width`
    floats wide: its C entry point takes the rays, `head` (pointers), then the
    tree, the counts and the outputs."""
    r, dev = o.shape[0], o.device
    n_leaves = bvh.n_leaves
    if n_leaves.bit_length() - 1 > BVH_MAX_DEPTH:
        raise ValueError(f"{name}: a tree of {n_leaves} leaves is deeper than {BVH_MAX_DEPTH} levels")
    _check("origins", o, (r, 3), torch.float32, dev)
    _check("dirs", d, (r, 3), torch.float32, dev)
    _check("tree rows", bvh.rows, (n_leaves * bvh.leaf_faces, row_width), torch.float32, dev)
    _check("tree faces", bvh.face, (n_leaves * bvh.leaf_faces,), torch.int32, dev)
    _check("tree boxes", bvh.boxes, (2 * n_leaves, 8), torch.float32, dev)
    if visits is not None:
        _check("visits", visits, (r, 2), torch.int32, dev)
    t = o.new_empty(r)
    idx = o.new_empty(r, dtype=torch.int32)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib(_WALK_SOURCES[name], name, [vp] * (2 + len(head)) + [vp, vp, vp, ci, ci, ci, vp, vp, vp, vp])
    launch_counts[name] += 1
    err = fn(_ptr(o), _ptr(d), *head, _ptr(bvh.rows), _ptr(bvh.face), _ptr(bvh.boxes), r, n_leaves,
             bvh.leaf_faces, _ptr(t), _ptr(idx), ctypes.c_void_p(0 if visits is None else visits.data_ptr()),
             _stream(o))
    _raise_on(err, name)
    return t, idx


def ray_first_hit(origins, dirs, tris, table=None):
    """First hit (t (R,), face (R,) int32) of each ray against `tris` (F, 3, 3).

    t = +inf and face = -1 where a ray escapes. On equal t the smallest face
    index wins. F > 512 runs the big-variant arithmetic (centred coordinates,
    precomputed face table), F <= 512 classic Moller-Trumbore, as the Pallas
    kernel does. `table` is `first_hit_table(tris)` where the caller keeps it.
    On the card each variant walks the table's face tree in one launch (K1
    big or K1 small; a table without a tree raises); the result is the dense
    walk's, bit for bit. On the CPU the dense walk runs.
    """
    variant, o, d, tab, tree = _first_hit_inputs(origins, dirs, tris, table)
    if not _on_card(o):
        body = _first_hit_big_plain if variant == "big" else _first_hit_small_plain
        return _finish_first_hit(*body(o, d, tab))
    return _launch_first_hit(variant, o, d, tree)


def _walk_inputs(origins, dirs, table):
    variant, o, d, _, tree = _first_hit_inputs(origins, dirs, None, table)
    if tree is None:
        raise ValueError("the tree walk takes a table with its face tree (first_hit_table)")
    return variant, o, d, tree


def _small_walk_plain(o, d, tree: "AnyHitTree"):
    """K1 small's walk (csrc/first_hit.cu) for every ray: the always-tested
    rows folded first by (t, original face), whatever the ray's components,
    then the walk of the tree's rows with the classic leaf test."""
    best_t = torch.full((o.shape[0],), _BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((o.shape[0],), _IDX_BIG, dtype=torch.int32, device=o.device)
    if tree.always.shape[0]:
        t, i = _first_hit_small_plain(o, d, tree.always)
        hit = t < _BIG
        best_t = torch.where(hit, t, best_t)
        best_i = torch.where(hit, tree.always_face[i.clamp_min(0).long()], best_i)
    return _first_hit_walk_plain(o, d, tree.bvh, _mt_leaf(o, d), (best_t, best_i))


def _plain_walk(variant, o, d, tree):
    return _small_walk_plain(o, d, tree) if variant == "small" else _first_hit_walk_plain(o, d, tree, _bilinear_leaf(o, d))


def first_hit_walk_plain(origins, dirs, table):
    """Plain PyTorch version of `first_hit_walk` (any device): the kernel's
    tree walk, every ray's steps in its order."""
    return _plain_walk(*_walk_inputs(origins, dirs, table))


def first_hit_walk(origins, dirs, table):
    """`ray_first_hit` through the table's tree with the walk's counts: (t,
    face, visits (R, 2) int32), visits = [boxes slab-tested, leaves folded]
    per ray. `table` is `first_hit_table(tris)` (K1 big's tree, or K1
    small's any-hit tree, whose always-tested rows are not counted).
    Launches the kernel on a CUDA device (one `first_hit_big` or
    `first_hit_small` launch) and its plain walk on the CPU."""
    variant, o, d, tree = _walk_inputs(origins, dirs, table)
    if not _on_card(o):
        return _plain_walk(variant, o, d, tree)
    visits = torch.empty((o.shape[0], 2), dtype=torch.int32, device=o.device)
    t, idx = _launch_first_hit(variant, o, d, tree, visits)
    return t, idx, visits


# ---------------------------------------------------------------------------
# K2: any hit (segment occlusion)
# ---------------------------------------------------------------------------


ANY_HIT_ROW = 12  # floats per any-hit tree row: [a, e1, e2, 0, 0, 0], three float4s
# Faces whose edges meet at under ~0.57 degrees (|e1 x e2| < FLAT_SIN |e1||e2|)
# are tested by every segment rather than through the tree: there the
# arithmetic's rounding can put a "hit" anywhere along the segment, outside
# any padded box (an exactly collinear zero-area face can still give
# |a| > 1e-9)
FLAT_SIN = 1.0e-2


@dataclass
class AnyHitTree:
    """The any-hit face tree of one mesh (csrc/any_hit_walk.cuh), tensors on
    one device, in world coordinates: `bvh` over the faces a query may
    report, each leaf row the dense table's row (`mt_face_table`) padded to
    ANY_HIT_ROW floats; `always` the rows every segment tests first (flat or
    non-finite faces), `always_face` their original faces."""

    bvh: FaceBVH
    always: torch.Tensor  # (n_always, ANY_HIT_ROW)
    always_face: torch.Tensor  # (n_always,) int32

    def __repr__(self):
        return f"AnyHitTree({self.bvh}, always-tested {self.always.shape[0]})"


def any_hit_tree(tris: torch.Tensor, faces: torch.Tensor = None) -> AnyHitTree:
    """The any-hit tree of `tris` (F, 3, 3) over the faces `faces` (F,) bool
    (default: every face), built with torch ops on the mesh's device, once
    per mesh.

    A face with a zero edge (e1 = 0 or e2 = 0, as the 1e9 sentinels have)
    is left out: its a = e1 . (d x e2) is 0 or NaN for every segment, so the
    dense test never passes. Every other face goes into the tree, or, where
    its row is not finite or it is flat (FLAT_SIN), into the always-tested
    rows; so every row the dense any-hit could report is walked or tested."""
    tab = mt_face_table(tris)
    e1, e2 = tab[:, 3:6], tab[:, 6:9]
    cand = (e1 != 0).any(dim=1) & (e2 != 0).any(dim=1)
    if faces is not None:
        cand &= faces.to(device=tab.device, dtype=torch.bool)
    e1d, e2d = e1.double(), e2.double()
    nrm = cross3(e1d, e2d)
    flat = dot3(nrm, nrm) < FLAT_SIN**2 * dot3(e1d, e1d) * dot3(e2d, e2d)
    odd = ~torch.isfinite(tab).all(dim=1) | flat
    rows = torch.nn.functional.pad(tab, (0, ANY_HIT_ROW - 9))
    bvh = build_face_bvh(tris.to(torch.float32), rows, cand & ~odd)
    always = torch.nonzero(cand & odd).squeeze(1)
    return AnyHitTree(bvh=bvh, always=rows[always].contiguous(), always_face=always.to(torch.int32))


def segment_inputs(starts, ends):
    """(origins, unit directions, lengths) of the segments, as the Pallas
    wrapper builds them (pallas_kernels.py:452-468)."""
    starts = torch.atleast_2d(starts).to(torch.float32)
    ends = torch.atleast_2d(ends).to(torch.float32)
    seg = ends - starts
    length = norm3(seg)
    dirs = seg / torch.clamp_min(length, _EPS)[:, None]
    return starts.contiguous(), dirs.contiguous(), length.contiguous()


def _mt_blocks(o, d, t_max, c):
    """The dense any-hit test of segments against face rows c = (9, ...) that
    broadcast against them (csrc/any_hit_walk.cuh:blocks, term for term)."""
    in_tri, t = _mt_pair_xyz(o[..., 0:1], o[..., 1:2], o[..., 2:3], d[..., 0:1], d[..., 1:2], d[..., 2:3], c)
    return in_tri & (t > _MARGIN) & (t < t_max[..., None])


def _any_hit_plain(o, d, length, tab):
    """The dense any-hit: every segment against every row of `tab` (F, >= 9)."""
    r, f = o.shape[0], tab.shape[0]
    t_max = length - _MARGIN
    blocked = torch.zeros(r, dtype=torch.bool, device=o.device)
    step = _face_chunk(r, f)
    for f0 in range(0, f, step):
        blocked |= _mt_blocks(o, d, t_max, tab[f0 : f0 + step, :9].T[:, None, :]).any(dim=1)
    return blocked


def segments_occluded_plain(starts, ends, tris):
    """The dense any-hit of the segments against every face of `tris` (any
    device): the exactness reference of both any-hit kernels."""
    return _any_hit_plain(*segment_inputs(starts, ends), mt_face_table(tris))


def any_hit_walk_plain(o, d, length, tree: AnyHitTree):
    """The walk of both any-hit kernels (K2 `any_hit`, K6 `star_any_hit`) for
    every segment at once, in the kernels' order: (blocked (R,) bool, visits
    (R, 2) int32 = slab tests, leaves tested).

    A segment whose window 1e-4 < t < length - 1e-4 is empty (zero length,
    NaN) is free without a test. The others test the always-tested rows,
    then, unless blocked or not finite (no finite row can block a segment
    with a non-finite component), walk the tree: a box is entered where the
    segment [0, length] meets it, the nearer child first and the farther
    pushed; the walk stops at the first leaf row that passes the dense test."""
    r, dev = o.shape[0], o.device
    bvh = tree.bvh
    n_leaves = bvh.n_leaves
    lo, hi = bvh.boxes[:, 0:3], bvh.boxes[:, 4:7]
    t_max = length - _MARGIN
    live = t_max > _MARGIN
    blocked = torch.zeros(r, dtype=torch.bool, device=dev)
    if tree.always.shape[0]:
        blocked = live & _any_hit_plain(o, d, length, tree.always)
    finite = torch.isfinite(o).all(dim=1) & torch.isfinite(d).all(dim=1)
    walk = live & ~blocked & finite
    o = torch.where(finite[:, None], o, 0.0)
    d = torch.where(finite[:, None], d, 1.0)
    inv = slab_inverse(d)
    entry, exit_ = slab_entry_exit(o, inv, lo[1], hi[1])
    node = torch.where(walk & (entry <= exit_) & (entry <= length), 1, 0)
    nodes = walk.to(torch.int32)
    leaves = torch.zeros(r, dtype=torch.int32, device=dev)
    stack = torch.zeros((r, BVH_MAX_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.zeros(r, dtype=torch.int64, device=dev)
    lanes = torch.arange(bvh.leaf_faces, device=dev)
    while True:
        pop = torch.nonzero((node == 0) & (sp > 0)).squeeze(1)
        sp[pop] -= 1
        node[pop] = stack[pop, sp[pop]]
        leaf = torch.nonzero(node >= n_leaves).squeeze(1)
        inner = torch.nonzero((node > 0) & (node < n_leaves)).squeeze(1)
        if leaf.numel() == 0 and inner.numel() == 0:
            break
        if leaf.numel():
            row = (node[leaf] - n_leaves)[:, None] * bvh.leaf_faces + lanes  # (n, leaf_faces)
            hit = _mt_blocks(o[leaf], d[leaf], t_max[leaf], bvh.rows[row].permute(2, 0, 1)).any(dim=1)
            blocked[leaf] = hit
            leaves[leaf] += 1
            node[leaf] = 0
            sp[leaf] = torch.where(hit, 0, sp[leaf])
        if inner.numel():
            c0 = node[inner] * 2
            e0, x0 = slab_entry_exit(o[inner], inv[inner], lo[c0], hi[c0])
            e1, x1 = slab_entry_exit(o[inner], inv[inner], lo[c0 + 1], hi[c0 + 1])
            nodes[inner] += 2
            ln = length[inner]
            v0 = (e0 <= x0) & (e0 <= ln)
            v1 = (e1 <= x1) & (e1 <= ln)
            both = v0 & v1
            second = e1 < e0  # the nearer child first; child 2i on a tie
            push = inner[both]
            stack[push, sp[push]] = torch.where(second, c0, c0 + 1)[both]
            sp[push] += 1
            node[inner] = torch.where(both, torch.where(second, c0 + 1, c0),
                                      torch.where(v0, c0, torch.where(v1, c0 + 1, 0)))
    return blocked, torch.stack([nodes, leaves], dim=1)


def _launch_any_hit(name: str, o, d, length, tree: AnyHitTree, visits=None):
    """One launch of the any-hit kernel `name` ("any_hit" or "star_any_hit",
    each its own source around csrc/any_hit_walk.cuh) on card tensors."""
    r, dev = o.shape[0], o.device
    bvh = tree.bvh
    n_leaves, n_always = bvh.n_leaves, tree.always.shape[0]
    if n_leaves.bit_length() - 1 > BVH_MAX_DEPTH:
        raise ValueError(f"{name}: a tree of {n_leaves} leaves is deeper than {BVH_MAX_DEPTH} levels")
    _check("starts", o, (r, 3), torch.float32, dev)
    _check("dirs", d, (r, 3), torch.float32, dev)
    _check("lengths", length, (r,), torch.float32, dev)
    _check("tree rows", bvh.rows, (n_leaves * bvh.leaf_faces, ANY_HIT_ROW), torch.float32, dev)
    _check("tree boxes", bvh.boxes, (2 * n_leaves, 8), torch.float32, dev)
    _check("always-tested rows", tree.always, (n_always, ANY_HIT_ROW), torch.float32, dev)
    if visits is not None:
        _check("visits", visits, (r, 2), torch.int32, dev)
    out = o.new_empty(r, dtype=torch.bool)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib(name, name, [vp, vp, vp, vp, vp, ci, ci, vp, ci, ci, vp, vp, vp])
    launch_counts[name] += 1
    err = fn(_ptr(o), _ptr(d), _ptr(length), _ptr(bvh.rows), _ptr(bvh.boxes), n_leaves, bvh.leaf_faces,
             _ptr(tree.always), n_always, r, _ptr(out), ctypes.c_void_p(0 if visits is None else visits.data_ptr()),
             _stream(o))
    _raise_on(err, name)
    return out


def any_hit(o, d, length, tree: AnyHitTree, visits=None):
    """(R,) bool any-hit of the segments (o, d, length) (`segment_inputs`)
    through `tree`: one launch of K2 on a CUDA device, its plain walk on the
    CPU. With `visits` (R, 2) int32 on the card, the kernel writes each
    segment's slab tests and leaves tested there."""
    if not _on_card(o):
        return any_hit_walk_plain(o, d, length, tree)[0]
    return _launch_any_hit("any_hit", o, d, length, tree, visits)


def segments_occluded(starts, ends, tris, tree: AnyHitTree = None):
    """(R,) bool: True where a face crosses the open segment start -> end,
    inside the window 1e-4 < t < length - 1e-4 (segments that end ON a
    surface do not count as blocked). Zero-length segments are never blocked.

    `tree` is `any_hit_tree(tris)`, which a caller that queries one mesh
    many times builds once (`MeshDeviceState.any_hit_tree`): on the card the
    query is then one K2 launch that walks it, on the CPU its plain walk.
    Without it, the card builds the tree for this one query (a few
    milliseconds for 100k faces) and the CPU runs the dense plain any-hit;
    the booleans are the same either way.
    """
    o, d, length = segment_inputs(starts, ends)
    if tree is None:
        if not _on_card(o):
            return _any_hit_plain(o, d, length, mt_face_table(tris))
        tree = any_hit_tree(tris)
    return any_hit(o, d, length, tree)


# ---------------------------------------------------------------------------
# The atomic-free histogram fold (csrc/hist_fold.cuh) of K3, K4 and K5
# ---------------------------------------------------------------------------

# The fold's shapes: up to _HIST_WARPS (K5) or _DEPOSIT_WARPS (K3, K4) warps
# a CTA, each with its own histogram of n_bins columns (16 bytes each with
# float4 columns, else 4) within _HIST_SMEM; clusters of up to 8 CTAs, the
# fewest that give _HIST_CTAS
_HIST_WARPS = 4
_DEPOSIT_WARPS = 8
_HIST_CLUSTER = 8
_HIST_CTAS = 2 * 132  # two per SM of an H100
_HIST_SMEM = 227 * 1024


@functools.lru_cache(maxsize=None)
def _fold_shape(what: str, max_warps: int, groups: int, cols: int, n_bins: int, vec4: bool) -> tuple:
    """(warps per CTA, CTAs per cluster) of a fold of `groups` x `cols`
    clusters into n_bins bins; raises where one warp's histogram does not
    fit the shared-memory budget (the card would refuse the launch)."""
    col_bytes = 16 if vec4 else 4
    warps = min(max_warps, _HIST_SMEM // (n_bins * col_bytes))
    if warps < 1:
        raise ValueError(f"{what}: {n_bins} bins of {col_bytes}-byte columns do not fit one warp's shared "
                         f"histogram ({_HIST_SMEM} bytes)")
    return warps, max(1, min(_HIST_CLUSTER, -(-_HIST_CTAS // (groups * cols))))


def deposit_histogram_shape(groups: int, channels: int, n_bands: int, n_bins: int, vec4: bool) -> tuple:
    """(warps per CTA, CTAs per cluster) of the K3 launch (groups = sources x
    capsules, one channel) or the K4 launch (groups = sources, 4 channels),
    with columns of 4 bands (`vec4`) or of one, into n_bins bins: the fold's
    warps sized to the shared-memory budget (opted in above 48 KiB by the
    launch), and clusters that give at least ~2 CTAs per SM."""
    return _fold_shape("deposit_histogram", _DEPOSIT_WARPS, groups, channels * (n_bands // 4 if vec4 else n_bands),
                       n_bins, vec4)


def bin_histogram_shape(g: int, k: int, n_bins: int, vec4: bool) -> tuple:
    """(warps per CTA, CTAs per cluster) of the K5 launch for G groups, K
    deposits per ray (K / 4 columns with `vec4`, else K) and n_bins bins."""
    return _fold_shape("bin_histogram", _HIST_WARPS, g, k // 4 if vec4 else k, n_bins, vec4)


# ---------------------------------------------------------------------------
# K3: fused deposit + histogram
# ---------------------------------------------------------------------------

HIST_LANES = 128  # the histogram is padded to a multiple of this many bins


def _f32(x: float) -> float:
    """`x` rounded to float32."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def _deposit_constants(n_bins: int, bin_dt: float, c_sound: float):
    """(n_bins_pad, 1/bin_dt, range limit, 1/c, 4 pi^2) as the f32 values the
    Pallas kernel uses: each is formed in double on the host, then rounded.

    The arrival time is (dist + d) * (1/c): XLA folds the kernel's division
    by the constant c into that multiply, and arrivals on a bin edge land in
    the bin it gives."""
    n_bins_pad = max(HIST_LANES, -(-n_bins // HIST_LANES) * HIST_LANES)
    return (
        n_bins_pad,
        _f32(1.0 / bin_dt),
        _f32(n_bins_pad * bin_dt),
        _f32(1.0 / c_sound),
        _f32(4.0 * math.pi**2),
    )


def _scene_listeners(listener_pos: torch.Tensor, tr: int) -> tuple:
    """(n_scenes, (C, 1 or TR, 3) listener point of each capsule and ray) of
    `listener_pos` (C, 3), or (n_scenes, C, 3) for a batch of scenes whose
    TR rays are scene-major: one scene broadcasts its capsules over the rays,
    a batch gathers each ray's scene's."""
    lis = listener_pos.to(torch.float32)
    if lis.dim() == 2 or lis.shape[0] == 1:
        return 1, lis.reshape(-1, 3)[:, None, :]
    n_scenes = lis.shape[0]
    scene = torch.arange(tr, device=lis.device) // (tr // n_scenes)
    return n_scenes, lis[scene].transpose(0, 1)


def deposit_fold_plain(hit, normal, e_refl, dist, occ, listener_pos,
                       n_sources: int, n_bins: int, bin_dt: float, c_sound: float) -> tuple:
    """The plain version of `deposit_histogram` up to its fold: (rows, dep),
    each deposit's row of the (C * E * n_bins_pad, B) histogram and the (C *
    TR, B) deposits, zero where the ray deposits nothing."""
    n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2 = _deposit_constants(n_bins, bin_dt, c_sound)
    dev = hit.device
    tr, n_bands = e_refl.shape
    cl = listener_pos.shape[-2]
    lis = _scene_listeners(listener_pos, tr)[1]
    vx = lis[..., 0] - hit[None, :, 0]
    vy = lis[..., 1] - hit[None, :, 1]
    vz = lis[..., 2] - hit[None, :, 2]
    d2 = vx * vx + vy * vy + vz * vz
    d = torch.sqrt(d2)
    cos_th = torch.clamp_min(
        (vx * normal[None, :, 0] + vy * normal[None, :, 1] + vz * normal[None, :, 2])
        / torch.clamp_min(d, 1e-9),
        0.0,
    )
    arrival = (dist[None] + d) * inv_c
    bins = (arrival * inv_bin_dt).to(torch.int32)
    visible = ~occ & (cos_th > 0.0) & (arrival < range_limit)
    m = torch.clamp_min(d, 1e-2)
    geom = torch.where(visible, cos_th / (four_pi2 * (m * m)), torch.zeros_like(d))
    dep = e_refl[None] * geom[..., None]  # (C, TR, B)
    bins = bins.clamp(0, n_bins_pad - 1)
    r = tr // n_sources
    group = (torch.arange(cl, device=dev)[:, None] * n_sources
             + torch.arange(tr, device=dev)[None] // r)  # (C, TR): c * E + e
    return (group * n_bins_pad + bins).reshape(-1), dep.reshape(-1, n_bands)


def deposit_histogram_plain(hit, normal, e_refl, dist, occ, listener_pos,
                            n_sources: int, n_bins: int, bin_dt: float, c_sound: float):
    """Plain PyTorch version of `deposit_histogram` (any device)."""
    n_bins_pad = _deposit_constants(n_bins, bin_dt, c_sound)[0]
    n_bands, cl = e_refl.shape[1], listener_pos.shape[-2]
    rows, dep = deposit_fold_plain(hit, normal, e_refl, dist, occ, listener_pos, n_sources, n_bins, bin_dt, c_sound)
    out = torch.zeros(cl * n_sources * n_bins_pad, n_bands, dtype=torch.float32, device=hit.device)
    out.index_add_(0, rows, dep)
    out = out.reshape(cl, n_sources, n_bins_pad, n_bands)[:, :, :n_bins]
    return out.permute(1, 0, 3, 2).contiguous()


_CP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DEPOSIT_ARGS = [_CP] * 6 + [_CI] * 7 + [_CF] * 4 + [_CI] * 3 + [_CP, _CP]
_DEPOSIT_FOA_ARGS = [_CP] * 6 + [_CI] * 6 + [_CF] * 4 + [_CI] * 3 + [_CP, _CP]


def _deposit_inputs(name: str, hit, normal, e_refl, dist, occ, listener_pos, n_sources: int, n_caps: int) -> tuple:
    """(TR, B, vec4, sources per scene) of a deposit kernel's inputs, each
    checked; `listener_pos` is (C, 3), or (n_scenes, C, 3) for a batch."""
    tr, n_bands = e_refl.shape
    n_scenes = listener_pos.shape[0] if listener_pos.dim() == 3 else 1
    if tr % n_sources or n_sources % n_scenes:
        raise ValueError(f"{name}: {tr} rays do not split into {n_sources} sources of {n_scenes} scenes")
    dev = hit.device
    _check("hit", hit, (tr, 3), torch.float32, dev)
    _check("normal", normal, (tr, 3), torch.float32, dev)
    _check("e_refl", e_refl, (tr, n_bands), torch.float32, dev)
    _check("dist", dist, (tr,), torch.float32, dev)
    _check("occ", occ, (n_caps, tr), torch.bool, dev)
    _check("listener_pos", listener_pos, (n_scenes, n_caps, 3)[3 - listener_pos.dim():], torch.float32, dev)
    # Columns of four bands where every row starts on 16 bytes
    return tr, n_bands, n_bands % 4 == 0 and e_refl.data_ptr() % 16 == 0, n_sources // n_scenes


def deposit_histogram(hit, normal, e_refl, dist, occ, listener_pos,
                      n_sources: int, n_bins: int, bin_dt: float, c_sound: float):
    """Fused diffuse-rain deposit + per-(source, capsule) arrival histogram.

    Arguments:
        hit, normal: (TR, 3) hit points and incoming-facing normals, TR =
            n_sources * rays, source-major.
        e_refl: (TR, B) reflected energies; dist: (TR,) path lengths so far.
        occ: (C, TR) bool, True where the capsule does not receive the ray.
        listener_pos: (C, 3) capsule positions, or (n_scenes, C, 3) for the
            sources of n_scenes scenes traced together (scene-major, each
            scene n_sources / n_scenes sources): each source reads its
            scene's capsules.

    Returns (n_sources, C, B, n_bins) f32 energy to add to the histograms.
    A batch gives each scene the bits of its own one-scene call: the fold's
    shape is sized for one scene's sources.
    """
    if not _on_card(hit):
        return deposit_histogram_plain(hit, normal, e_refl, dist, occ, listener_pos,
                                       n_sources, n_bins, bin_dt, c_sound)
    cl = listener_pos.shape[-2]
    tr, n_bands, vec4, per_scene = _deposit_inputs("deposit_histogram", hit, normal, e_refl, dist, occ,
                                                   listener_pos, n_sources, cl)
    n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2 = _deposit_constants(n_bins, bin_dt, c_sound)
    warps, cluster = deposit_histogram_shape(per_scene * cl, 1, n_bands, n_bins, vec4)
    out = torch.empty((n_sources, cl, n_bands, n_bins), dtype=torch.float32, device=hit.device)
    fn = _lib("deposit_histogram", "deposit_histogram", _DEPOSIT_ARGS)
    launch_counts["deposit_histogram"] += 1
    err = fn(_ptr(hit), _ptr(normal), _ptr(e_refl), _ptr(dist), _ptr(occ), _ptr(listener_pos),
             n_sources, per_scene, tr // n_sources, cl, n_bands, n_bins, n_bins_pad, inv_bin_dt, range_limit, inv_c,
             four_pi2, vec4, warps, cluster, _ptr(out), _stream(hit))
    _raise_on(err, "deposit_histogram")
    return out


# ---------------------------------------------------------------------------
# K4: fused deposit + AmbiX first-order encode + histogram
# ---------------------------------------------------------------------------


def deposit_foa_fold_plain(hit, normal, e_refl, dist, occ, listener_pos,
                           n_sources: int, n_bins: int, bin_dt: float, c_sound: float) -> tuple:
    """The plain version of `deposit_histogram_foa` up to its fold: (rows,
    w), each ray's row of the (E * n_bins_pad, 4 * B) histogram and its (TR,
    4 * B) encoded deposits, zero where the ray deposits nothing."""
    n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2 = _deposit_constants(n_bins, bin_dt, c_sound)
    tr, n_bands = e_refl.shape
    n_scenes, lis = _scene_listeners(listener_pos, tr)
    lis = lis.reshape(3) if n_scenes == 1 else lis[0].T  # (3,) or (3, TR)
    vx = lis[0] - hit[:, 0]
    vy = lis[1] - hit[:, 1]
    vz = lis[2] - hit[:, 2]
    d = torch.sqrt(vx * vx + vy * vy + vz * vz)
    inv_d = 1.0 / torch.clamp_min(d, 1e-9)
    cos_th = torch.clamp_min((vx * normal[:, 0] + vy * normal[:, 1] + vz * normal[:, 2]) * inv_d, 0.0)
    arrival = (dist + d) * inv_c
    bins = (arrival * inv_bin_dt).to(torch.int32).clamp(0, n_bins_pad - 1)
    visible = ~occ.reshape(tr) & (cos_th > 0.0) & (arrival < range_limit)
    m = torch.clamp_min(d, 1e-2)
    geom = torch.where(visible, cos_th / (four_pi2 * (m * m)), torch.zeros_like(d))
    dep = e_refl * geom[:, None]  # (TR, B)
    gains = torch.stack([-vx * inv_d, -vy * inv_d, -vz * inv_d], dim=1)  # (TR, 3)
    w = torch.cat([dep[:, None, :], dep[:, None, :] * gains[:, :, None]], dim=1)  # (TR, 4, B)
    r = tr // n_sources
    return torch.arange(tr, device=hit.device) // r * n_bins_pad + bins, w.reshape(tr, 4 * n_bands)


def deposit_histogram_foa_plain(hit, normal, e_refl, dist, occ, listener_pos,
                                n_sources: int, n_bins: int, bin_dt: float, c_sound: float):
    """Plain PyTorch version of `deposit_histogram_foa` (any device)."""
    n_bins_pad = _deposit_constants(n_bins, bin_dt, c_sound)[0]
    n_bands = e_refl.shape[1]
    rows, w = deposit_foa_fold_plain(hit, normal, e_refl, dist, occ, listener_pos, n_sources, n_bins, bin_dt,
                                     c_sound)
    out = torch.zeros(n_sources * n_bins_pad, 4 * n_bands, dtype=torch.float32, device=hit.device)
    out.index_add_(0, rows, w)
    out = out.reshape(n_sources, n_bins_pad, 4, n_bands)[:, :n_bins]
    return out.permute(0, 2, 3, 1).contiguous()


def deposit_histogram_foa(hit, normal, e_refl, dist, occ, listener_pos,
                          n_sources: int, n_bins: int, bin_dt: float, c_sound: float):
    """Fused diffuse-rain deposit + AmbiX order-1 encode + per-source arrival
    histogram for one listener point (the FOA rig).

    Arguments:
        hit, normal: (TR, 3) hit points and incoming-facing normals, TR =
            n_sources * rays, source-major.
        e_refl: (TR, B) reflected energies; dist: (TR,) path lengths so far.
        occ: (1, TR) bool, True where the listener does not receive the ray.
        listener_pos: (1, 3) the listener point, or (n_scenes, 1, 3) for
            the sources of n_scenes scenes traced together (scene-major):
            each source reads its scene's point.

    Returns (n_sources, 4, B, n_bins) f32 energy in channels [W, X, Y, Z]:
    W the deposit, X/Y/Z the deposit times the arrival direction's component.
    A batch gives each scene the bits of its own one-scene call.
    """
    if not _on_card(hit):
        return deposit_histogram_foa_plain(hit, normal, e_refl, dist, occ, listener_pos,
                                           n_sources, n_bins, bin_dt, c_sound)
    tr, n_bands, vec4, per_scene = _deposit_inputs("deposit_histogram_foa", hit, normal, e_refl, dist, occ,
                                                   listener_pos, n_sources, 1)
    n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2 = _deposit_constants(n_bins, bin_dt, c_sound)
    warps, cluster = deposit_histogram_shape(per_scene, 4, n_bands, n_bins, vec4)
    out = torch.empty((n_sources, 4, n_bands, n_bins), dtype=torch.float32, device=hit.device)
    fn = _lib("deposit_histogram_foa", "deposit_histogram_foa", _DEPOSIT_FOA_ARGS)
    launch_counts["deposit_histogram_foa"] += 1
    err = fn(_ptr(hit), _ptr(normal), _ptr(e_refl), _ptr(dist), _ptr(occ), _ptr(listener_pos),
             n_sources, per_scene, tr // n_sources, n_bands, n_bins, n_bins_pad, inv_bin_dt, range_limit, inv_c,
             four_pi2, vec4, warps, cluster, _ptr(out), _stream(hit))
    _raise_on(err, "deposit_histogram_foa")
    return out


# ---------------------------------------------------------------------------
# K5: grouped histogram
# ---------------------------------------------------------------------------


def bin_histogram_plain(bins, dep, n_bins: int):
    """Plain PyTorch version of `bin_histogram` (any device)."""
    g, r, k = dep.shape
    b = bins.to(torch.int64)
    keep = (b >= 0) & (b < n_bins)
    flat = (torch.arange(g, device=dep.device)[:, None] * n_bins + b.clamp(0, n_bins - 1)).reshape(-1)
    vals = torch.where(keep[..., None], dep.to(torch.float32), torch.zeros((), device=dep.device))
    out = torch.zeros(g * n_bins, k, dtype=torch.float32, device=dep.device)
    out.index_add_(0, flat, vals.reshape(-1, k))
    return out.reshape(g, n_bins, k)


def bin_histogram(bins, dep, n_bins: int):
    """Grouped histogram: out[g, bin, k] = sum over rays r of dep[g, r, k]
    where bins[g, r] == bin.

    Arguments:
        bins: (G, R) integer bin indices; bins outside [0, n_bins) deposit
            nowhere (the Pallas kernel's one-hot matches no bin for them).
        dep: (G, R, K) float32 deposits.

    Returns (G, n_bins, K) float32, summed in fp32.
    """
    if not _on_card(dep):
        return bin_histogram_plain(bins, dep, n_bins)
    g, r, k = dep.shape
    dev = dep.device
    if bins.dtype != torch.int32 or not bins.is_contiguous():
        bins = bins.to(torch.int32).contiguous()
    _check("bins", bins, (g, r), torch.int32, dev)
    _check("dep", dep, (g, r, k), torch.float32, dev)
    out = dep.new_empty((g, n_bins, k))
    # Columns of four deposits where every row starts on 16 bytes
    vec4 = k % 4 == 0 and dep.data_ptr() % 16 == 0
    warps, cluster = bin_histogram_shape(g, k, n_bins, vec4)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("bin_histogram", "bin_histogram", [vp, vp, ci, ci, ci, ci, ci, ci, ci, vp, vp])
    launch_counts["bin_histogram"] += 1
    err = fn(_ptr(bins), _ptr(dep), g, r, k, n_bins, int(vec4), warps, cluster, _ptr(out), _stream(dep))
    _raise_on(err, "bin_histogram")
    return out


# ---------------------------------------------------------------------------
# K6: star any-hit (segments toward one end point)
# ---------------------------------------------------------------------------


def star_any_hit(o, d, length, tree: AnyHitTree, visits=None):
    """`any_hit` through the K6 kernel: the any-hit of segments that all end
    near one point (ops/star_occlusion.py forms them) through the star's
    tree. One launch on a CUDA device, the plain walk on the CPU."""
    if not _on_card(o):
        return any_hit_walk_plain(o, d, length, tree)[0]
    return _launch_any_hit("star_any_hit", o, d, length, tree, visits)


# ---------------------------------------------------------------------------
# K7: the tiled first hit, as a per-ray walk of the mesh's face tree
# ---------------------------------------------------------------------------

MT_ROW = ANY_HIT_ROW  # floats per K7 tree row: [a, e1, e2, 0, 0, 0], three float4s


def _lex_min(best_t, best_i, t, i):
    """The smaller of (best_t, best_i) and (t, i), t first, then the index."""
    better = (t < best_t) | ((t == best_t) & (i < best_i))
    return torch.where(better, t, best_t), torch.where(better, i, best_i)


def tiled_face_bvh(tris: torch.Tensor) -> FaceBVH:
    """K7's face tree (csrc/tiled_first_hit.cu) over the faces of `tris`
    (F, 3, 3) that can hit, in world coordinates: finite (every coordinate
    under 1e8 in size, so the 1e9 sentinels stay out) and of nonzero area,
    the faces of the reference's tile layout. Each row is the face's classic
    Moller-Trumbore row [a, e1, e2] (`mt_face_table`) padded to MT_ROW
    floats, reporting its index into `tris`. Built with torch ops on the
    mesh's device, once per mesh."""
    tris32 = tris.to(torch.float32)
    rows = mt_face_table(tris32)
    keep = (tris32.abs() < 1.0e8).all(dim=2).all(dim=1) & (cross3(rows[:, 3:6], rows[:, 6:9]) != 0).any(dim=1)
    return build_face_bvh(tris32, torch.nn.functional.pad(rows, (0, MT_ROW - 9)), keep)


def _mt_leaf(o, d):
    """K7's leaf test (csrc/tiled_first_hit.cu:MtLeaf) for `_first_hit_walk_plain`."""
    comps = [o[:, k : k + 1] for k in range(3)] + [d[:, k : k + 1] for k in range(3)]

    def pair(rays, rows, faces):
        in_tri, t = _mt_pair_xyz(*(x[rays] for x in comps), rows.permute(2, 0, 1))
        return in_tri & (t > _EPS), t

    return pair


def tiled_walk_plain(o, d, bvh: FaceBVH):
    """Plain PyTorch version of `first_hit_tiled` (any device): the kernel's
    walk, every ray's steps in its order: (t, original face, visits (R, 2)
    int32 = slab tests, leaves folded)."""
    return _first_hit_walk_plain(o, d, bvh, _mt_leaf(o, d))


def first_hit_tiled(o, d, bvh: FaceBVH, visits=None):
    """First hit (t (R,), original face (R,) int32) of the rays `o`, `d`
    (R, 3) float32 against the faces of K7's tree `bvh` (`tiled_face_bvh`):
    the dense classic Moller-Trumbore first hit over the mesh
    (`ray_first_hit_plain` with `dense_mt_table`), t = +inf and face = -1 on
    a miss, the smallest original index on a tie. One launch of the K7
    kernel on a CUDA device (with `visits` (R, 2) int32 it writes each ray's
    slab tests and leaves folded there), its plain walk on the CPU."""
    if not _on_card(o):
        return tiled_walk_plain(o, d, bvh)[:2]
    return _launch_walk("first_hit_tiled", MT_ROW, o, d, bvh, visits)


def dense_mt_table(tris: torch.Tensor) -> tuple:
    """A `first_hit_table` that runs the classic Moller-Trumbore variant at
    any face count: the dense first hit with the tiled kernel's arithmetic
    (through `ray_first_hit_plain`, K7's exactness reference)."""
    return "small", None, mt_face_table(tris), None


# ---------------------------------------------------------------------------
# K8: the bilinear ("MXU") first hit with a launch-face mask, as a per-ray
# walk of the LOD's face tree
# ---------------------------------------------------------------------------

MXU_PACKED_COLS = 19  # u [e2, w2], v [-e1, -w1], a [-n], t [n, -k]
MXU_ROW = 20  # floats per K8 tree row: the packed columns and a zero, five float4s (kRowVecs)
MXU_EPS_UV = 0.02  # relative barycentric slop
MXU_T_EPS = 1.0e-4  # least hit distance (m)
_MXU_DET_EPS = 1.0e-6
_MXU_DENOM_EPS = 1.0e-9  # the exact plane re-evaluation's least |d . n|


def _dot_left(r, c, cols):
    """sum_k r[k] * c[cols[k]], summed left to right as the kernel sums it."""
    acc = r[0] * c[cols[0]]
    for k in range(1, len(cols)):
        acc = acc + r[k] * c[cols[k]]
    return acc


def _mxu_window(rv, c, lane, skip):
    """K8's pair test (csrc/mxu_first_hit.cu:WindowLeaf, term for term) of
    ray vectors `rv` (9 components) against face rows c = (>= 19, ...) of
    faces `lane`, that broadcast against them, each ray's face `skip` masked:
    (hit, t)."""
    u_num = _dot_left(rv[0:6], c, range(0, 6))
    v_num = _dot_left(rv[0:6], c, range(6, 12))
    det = _dot_left(rv[3:6], c, range(12, 15))
    t_num = _dot_left(rv[6:9], c, range(15, 18)) + c[18]
    valid = det.abs() > _MXU_DET_EPS
    inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
    u = u_num * inv
    v = v_num * inv
    t = t_num * inv
    hit = (valid & (u >= -MXU_EPS_UV) & (u <= 1.0 + MXU_EPS_UV) & (v >= -MXU_EPS_UV)
           & (u + v <= 1.0 + MXU_EPS_UV) & (t > MXU_T_EPS) & (lane != skip))
    return hit, t


def first_hit_mxu_plain(rvec, prev, packed):
    """The dense K8 selection over every face of `packed` (F, 19), in
    ascending face order (any device): (t (R,), face (R,) int32), t = 3e38
    and face = -1 on a miss, the smallest face index on a tie. `rvec` (R, 9)
    the ray vectors [o' x d, d, o'], `prev` (R,) int32 each ray's launch face
    (-1 for none). The exactness reference of K8, with the exact plane
    re-evaluation of ops/mxu_first_hit.py."""
    r, f = rvec.shape[0], packed.shape[0]
    rv = [rvec[:, k : k + 1] for k in range(9)]
    skip = prev[:, None]
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=rvec.device)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=rvec.device)
    step = _face_chunk(r, f)
    for f0 in range(0, f, step):
        c = packed[f0 : f0 + step].T[:, None, :]  # (19, 1, Fc)
        lane = torch.arange(f0, f0 + c.shape[2], device=rvec.device, dtype=torch.int32)
        hit, t = _mxu_window(rv, c, lane[None, :], skip)
        best_t, best_i = _fold_min(best_t, best_i, torch.where(hit, t, _BIG), f0)
    return best_t, torch.where(best_t >= _BIG, -1, best_i)


def mxu_face_bvh(tris: torch.Tensor, center: torch.Tensor, packed: torch.Tensor) -> FaceBVH:
    """K8's face tree (csrc/mxu_first_hit.cu) over the packed rows `packed`
    (F, 19) of `tris` (F, 3, 3), in the frame centred on `center`: each row
    padded to MXU_ROW floats, each leaf's box that of its faces' triangles
    widened by the window's slop (A + s e1 + t e2 at (-eps, -eps), (1 + 2
    eps, -eps), (-eps, 1 + 2 eps), eps = MXU_EPS_UV: the region the window
    accepts), padded as every face tree. Faces whose row can never pass the
    window are left out: a zero normal (|det| is 0) or a non-finite entry.
    Built with torch ops on the tables' device, once per mesh."""
    tris32 = tris.to(torch.float32)
    a = tris32[:, 0] - center
    e1, e2 = tris32[:, 1] - tris32[:, 0], tris32[:, 2] - tris32[:, 0]
    eps = MXU_EPS_UV
    widened = torch.stack([a + s * e1 + t * e2 for s, t in ((-eps, -eps), (1 + 2 * eps, -eps), (-eps, 1 + 2 * eps))],
                          dim=1)
    keep = (packed[:, 15:18] != 0).any(dim=1) & torch.isfinite(packed).all(dim=1)
    return build_face_bvh(widened, torch.nn.functional.pad(packed, (0, MXU_ROW - MXU_PACKED_COLS)), keep)


def mxu_ray_vectors(o_c, d):
    """The ray vectors [o' x d, d, o'] (R, 9) of centred origins `o_c`."""
    return torch.cat([cross3(o_c, d), d, o_c], dim=1)


def _mxu_leaf(o_c, d, prev):
    """K8's leaf test for `_first_hit_walk_plain`."""
    rvec = mxu_ray_vectors(o_c, d)
    rv = [rvec[:, k : k + 1] for k in range(9)]
    skip = (torch.full_like(rvec[:, 0], -1, dtype=torch.int32) if prev is None else prev)[:, None]

    def pair(rays, rows, faces):
        return _mxu_window([x[rays] for x in rv], rows.permute(2, 0, 1), faces, skip[rays])

    return pair


def _mxu_exact(o_c, d, t_sel, face, bvh: FaceBVH):
    """The exact f32 plane of each ray's selected face (the reference's
    :271-284, as csrc/mxu_first_hit.cu writes it): t = (k - o'.n) / (d.n)
    where |d.n| > 1e-9 and that t is positive, else the selected t; (inf, -1)
    on a miss. n and -k are columns 15-17 and 18 of the face's tree row."""
    real = torch.nonzero(bvh.face >= 0).squeeze(1)
    pos = torch.zeros(max(int(bvh.face.max()) + 1, 1), dtype=torch.int64, device=face.device)
    pos[bvh.face[real].long()] = real
    row = bvh.rows[pos[face.clamp_min(0).long()]]
    n_g, k = row[:, 15:18], -row[:, 18]
    denom = dot3(d, n_g)
    numer = k - dot3(o_c, n_g)
    t_exact = torch.where(denom.abs() > _MXU_DENOM_EPS, numer / denom, t_sel)
    t_exact = torch.where(t_exact > 0.0, t_exact, t_sel)
    hit = face >= 0
    return torch.where(hit, t_exact, math.inf), torch.where(hit, face, -1)


def mxu_walk_plain(o, d, prev, center, bvh: FaceBVH):
    """Plain PyTorch version of `first_hit_mxu` (any device): the centring,
    the kernel's walk (every ray's steps in its order) and the plane
    re-evaluation: (t, face, visits (R, 2) int32 = slab tests, leaves
    folded)."""
    o_c = o - center
    t_sel, face, visits = _first_hit_walk_plain(o_c, d, bvh, _mxu_leaf(o_c, d, prev))
    return (*_mxu_exact(o_c, d, t_sel, face, bvh), visits)


def first_hit_mxu(o, d, prev, center, bvh: FaceBVH, visits=None):
    """Bilinear first hit of rays against an acoustic LOD, the launch face
    masked, with the winner's plane re-evaluated exactly.

    Arguments:
        o, d: (R, 3) float32 origins (world coordinates) and directions.
        prev: (R,) int32 the face each ray may not hit (its launch face), -1
            for none; or None.
        center: (3,) the tables' centre; bvh: K8's face tree (`mxu_face_bvh`).

    Returns (t (R,), face (R,) int32): t = +inf and face = -1 on a miss; the
    window has the 2 % slop MXU_EPS_UV, t > 1e-4, |det| > 1e-6; on equal t
    the smallest face index wins; t is the exact f32 plane intersection of
    the selected face. Equals the dense selection (`first_hit_mxu_plain`)
    with its re-evaluation bit for bit. One launch of the K8 kernel on a
    CUDA device, the centring, the ray vector and the re-evaluation inside
    it (with `visits` (R, 2) int32 it writes each ray's slab tests and leaves
    folded there); its plain walk on the CPU.
    """
    if not _on_card(o):
        return mxu_walk_plain(o, d, prev, center, bvh)[:2]
    r, dev = o.shape[0], o.device
    if prev is not None:
        _check("launch faces", prev, (r,), torch.int32, dev)
    _check("centre", center, (3,), torch.float32, dev)
    return _launch_walk("first_hit_mxu", MXU_ROW, o, d, bvh, visits,
                        ctypes.c_void_p(0 if prev is None else prev.data_ptr()), _ptr(center))


# ---------------------------------------------------------------------------
# K9 and K10: the cone-sorted and the pair-walk first hits over Morton tiles
# of the big variant's face table
# ---------------------------------------------------------------------------

SORTED_TILE_FACES = 256  # Morton-sorted faces per tile (64 leaves of K10's tree: kTileLeaves in csrc/pair_first_hit.cu)
TILE_LEAVES = SORTED_TILE_FACES // BVH_LEAF_FACES  # leaves of one tile's subtree in K10's tree (kTileLeaves)
PFH_LANES = 512  # pair lanes per block of the reference-shaped round (ops/pair_first_hit.py:round_inputs)
_ENTRY_TINY = 1.0e-12  # a direction component under this in size counts as +-1e-12 in the tile entries


def _tile_fold(ray, faces, tl):
    """Each ray's smallest (t, sorted face index) over its tile: `ray` from
    `_plucker` with (A, L, 1) components, `faces` (A, 256, 16) the tiles'
    rows, `tl` (A,) their ids. (t (A, L), face (A, L)): 3e38 and 2**30 on a
    miss, the smallest index on equal t."""
    hit, t = _bilinear_pair(ray, faces.permute(2, 0, 1)[:, :, None, :])  # (A, L, 256)
    t_hit = torch.where(hit, t, _BIG)
    lane = torch.arange(SORTED_TILE_FACES, dtype=torch.int32, device=faces.device)
    f_hit = torch.where(hit, tl.to(torch.int32)[:, None, None] * SORTED_TILE_FACES + lane, _IDX_BIG)
    t_min = t_hit.amin(dim=2)
    return t_min, torch.where(t_hit == t_min[..., None], f_hit, _IDX_BIG).amin(dim=2)


def sorted_walk_plain(o, d, alive, center, bvh: FaceBVH):
    """Plain PyTorch version of `first_hit_sorted` (any device): the
    centring, then K1 big's walk of the sorted faces' tree, every live ray's
    steps in the kernel's order: (t, sorted face, visits (R, 2) int32 = slab
    tests, leaves folded). A dead ray walks as a non-finite one does: no
    walk, (inf, -1), no visits."""
    o_c = o - center
    if alive is not None:
        o_c = torch.where(alive[:, None], o_c, math.nan)
    return _first_hit_walk_plain(o_c, d, bvh, _bilinear_leaf(o_c, d))


def first_hit_sorted(o, d, alive, center, bvh: FaceBVH, visits=None):
    """First hit of a ray wavefront against the Morton-sorted faces (K9).

    Arguments:
        o, d: (R, 3) float32 origins (world coordinates) and directions.
        alive: (R,) bool, True for a live ray; or None (all live).
        center: (3,) the tiles' centre; bvh: the sorted faces' tree
            (ops/sorted_first_hit.py:build_sorted_tree), each row reporting
            its sorted index.

    Returns (t (R,), sorted face (R,) int32): t = +inf and face = -1 on a
    miss or a dead ray, the smallest sorted index on equal t: the dense big
    first hit over the sorted faces, bit for bit. One launch of the K9
    kernel on a CUDA device, the centring and the alive mask inside it (with
    `visits` (R, 2) int32 it writes each ray's slab tests and leaves folded
    there); its plain walk on the CPU.
    """
    if not _on_card(o):
        return sorted_walk_plain(o, d, alive, center, bvh)[:2]
    r, dev = o.shape[0], o.device
    if alive is not None:
        _check("alive", alive, (r,), torch.bool, dev)
    _check("centre", center, (3,), torch.float32, dev)
    return _launch_walk("first_hit_sorted", 16, o, d, bvh, visits,
                        ctypes.c_void_p(0 if alive is None else alive.data_ptr()), _ptr(center))


def pair_tile_plain(o, d, blk_tile, face_tab):
    """One round of the reference's pair layout (ops/pair_first_hit.py:
    `round_inputs`): each block of PFH_LANES lanes against its tile's 256
    faces, vectorised over blocks: (t (n_lanes,), sorted face (n_lanes,)
    int32), 3e38 and -1 on a miss or a block without a tile (-1)."""
    n_lanes = o.shape[0]
    nb, n_tiles = n_lanes // PFH_LANES, face_tab.shape[0] // SORTED_TILE_FACES
    ray = _plucker(o.reshape(nb, PFH_LANES, 3), d.reshape(nb, PFH_LANES, 3))
    faces = face_tab.reshape(n_tiles, SORTED_TILE_FACES, 16)
    best_t = torch.full((nb, PFH_LANES), _BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((nb, PFH_LANES), _IDX_BIG, dtype=torch.int32, device=o.device)
    blocks = torch.nonzero((blk_tile >= 0) & (blk_tile < n_tiles)).flatten()
    per_chunk = max(1, _CHUNK_ELEMS // (PFH_LANES * SORTED_TILE_FACES))
    for b0 in range(0, blocks.numel(), per_chunk):
        b = blocks[b0 : b0 + per_chunk]
        tl = blk_tile[b].long()
        best_t[b], best_i[b] = _tile_fold(tuple(x[b] for x in ray), faces[tl], tl)
    t = best_t.reshape(-1)
    return t, torch.where(t >= _BIG, -1, best_i.reshape(-1))


def tile_entries(o_c: torch.Tensor, d: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(R, T) entry distance of each ray (centred origins `o_c`, directions
    `d`, (R, 3)) into each tile's box [lo, hi] (T, 3), +inf where the ray's
    line misses it, as the reference's `_tile_entries` computes it, axis by
    axis: a direction component under 1e-12 in size counts as +-1e-12 (-0 as
    +1e-12); entry max(0, near distances), exit min(far distances)."""
    tiny = torch.where(d < 0, -_ENTRY_TINY, _ENTRY_TINY)
    inv = 1.0 / torch.where(d.abs() < _ENTRY_TINY, tiny, d)
    r, n_t = o_c.shape[0], lo.shape[0]
    ent = torch.zeros((r, n_t), dtype=torch.float32, device=o_c.device)
    exi = torch.full((r, n_t), math.inf, dtype=torch.float32, device=o_c.device)
    for ax in range(3):
        t0 = (lo[None, :, ax] - o_c[:, ax, None]) * inv[:, ax, None]
        t1 = (hi[None, :, ax] - o_c[:, ax, None]) * inv[:, ax, None]
        ent = torch.maximum(ent, torch.minimum(t0, t1))
        exi = torch.minimum(exi, torch.maximum(t0, t1))
    return torch.where(exi >= ent, ent, math.inf)


def pair_walk_plain(o, d, alive, center, tile_lo, tile_hi, bvh: FaceBVH, k: int):
    """Plain PyTorch version of `first_hit_pair` (any device), every ray's
    steps in the kernel's order: (t, sorted face, counts (R, 4) int32 =
    rounds, live (ray, tile) pairs, subtree box tests, leaves folded).

    Each ray's tiles are taken in (entry, tile id) order (a stable sort of
    `tile_entries`). A round takes the next `k`; a candidate is live where
    its entry is finite and no later than the ray's best t at the round's
    start (+inf before a hit), and a live one's subtree (node n_leaves /
    TILE_LEAVES + tile) is walked from the ray's best so far, as soon as the
    walk is done with the tile before. The first candidate that is not live
    ends the ray (every later one enters later); so does the end of a round
    whose next candidate enters after the best t. A dead ray or one with a
    non-finite component takes one round and walks nothing."""
    r, dev = o.shape[0], o.device
    o_c = o - center
    walked = torch.isfinite(o_c).all(dim=1) & torch.isfinite(d).all(dim=1)
    if alive is not None:
        walked &= alive
    n_tiles = tile_lo.shape[0]
    enter = torch.where(walked[:, None], tile_entries(o_c, d, tile_lo, tile_hi), math.inf)
    ent_s, tile_s = torch.sort(enter, dim=1, stable=True)
    base = bvh.n_leaves // TILE_LEAVES
    counts = torch.zeros((r, 4), dtype=torch.int32, device=dev)
    counts[:, 0] = 1
    pos = torch.zeros(r, dtype=torch.int64, device=dev)
    slots = torch.full((r,), k, dtype=torch.int64, device=dev)
    round_best = torch.full((r,), math.inf, dtype=torch.float32, device=dev)

    def feed(rays, best_t, best_i):
        # The ray's next candidate; a round ends after k of them, and the next
        # starts where its first candidate enters no later than the best t
        p = pos[rays].clamp_max(n_tiles - 1)
        e = torch.where(pos[rays] < n_tiles, ent_s[rays, p], math.inf)
        now = torch.where(best_t >= _BIG, math.inf, best_t)
        fin = torch.isfinite(e)
        boundary = slots[rays] == 0
        start = boundary & fin & (e <= now)
        nxt = rays[start]
        counts[nxt, 0] += 1
        round_best[nxt], slots[nxt] = now[start], k
        live = fin & (~boundary | start) & (e <= round_best[rays])
        go = rays[live]
        counts[go, 1] += 1
        slots[go] -= 1
        pos[go] += 1
        return torch.where(live, base + tile_s[rays, p], 0)

    t, face, visits = _first_hit_walk_plain(o_c, d, bvh, _bilinear_leaf(o_c, d), feed=feed)
    counts[:, 2:] = visits
    return t, face, counts


def first_hit_pair(o, d, alive, center, tile_lo, tile_hi, bvh: FaceBVH, k_slots: int, counts=None):
    """The pair-walk first hit (K10): each ray through its nearest tiles in
    rounds of `k_slots`, every round in one launch.

    Arguments:
        o, d: (R, 3) float32 origins (world coordinates) and directions.
        alive: (R,) bool, True for a live ray; or None (all live).
        center: (3,) the tiles' centre; tile_lo, tile_hi: (T, 3) the tiles'
            tight boxes, centred.
        bvh: the tiles' face tree (ops/pair_first_hit.py:build_pair_tree):
            the sorted rows in their own order, tile t's 256 rows in the
            subtree of node n_leaves / TILE_LEAVES + t.
        k_slots: candidates per round, >= 1; above T it counts as T.
        counts: (R, 4) int32 or None: where given, each ray's rounds, live
            (ray, tile) pairs, subtree box tests and leaves folded.

    Returns (t (R,), sorted face (R,) int32): t = +inf and face = -1 on a
    miss or a dead ray, the smallest sorted index on equal t: the (t, face)
    of the reference's rounds, which test each live tile whole, and the
    dense big first hit over the sorted faces, bit for bit. One launch of
    the K10 kernel on a CUDA device, its plain walk on the CPU.
    """
    n_tiles = tile_lo.shape[0]
    if k_slots < 1:
        raise ValueError(f"first_hit_pair: k_slots must be >= 1, got {k_slots}")
    k = min(int(k_slots), n_tiles)
    if not _on_card(o):
        t, idx, c = pair_walk_plain(o, d, alive, center, tile_lo, tile_hi, bvh, k)
        if counts is not None:
            counts.copy_(c)
        return t, idx
    r, dev = o.shape[0], o.device
    n_leaves = bvh.n_leaves
    if n_tiles == 0 or bvh.leaf_faces != BVH_LEAF_FACES or n_leaves // TILE_LEAVES < n_tiles:
        raise ValueError(f"first_hit_pair: {bvh} is not the pair tree of {n_tiles} tiles (build_pair_tree)")
    if n_leaves.bit_length() - 1 > BVH_MAX_DEPTH:
        raise ValueError(f"first_hit_pair: a tree of {n_leaves} leaves is deeper than {BVH_MAX_DEPTH} levels")
    _check("origins", o, (r, 3), torch.float32, dev)
    _check("dirs", d, (r, 3), torch.float32, dev)
    if alive is not None:
        _check("alive", alive, (r,), torch.bool, dev)
    _check("centre", center, (3,), torch.float32, dev)
    _check("tile minima", tile_lo, (n_tiles, 3), torch.float32, dev)
    _check("tile maxima", tile_hi, (n_tiles, 3), torch.float32, dev)
    _check("tree rows", bvh.rows, (n_leaves * BVH_LEAF_FACES, 16), torch.float32, dev)
    _check("tree faces", bvh.face, (n_leaves * BVH_LEAF_FACES,), torch.int32, dev)
    _check("tree boxes", bvh.boxes, (2 * n_leaves, 8), torch.float32, dev)
    if counts is not None:
        _check("counts", counts, (r, 4), torch.int32, dev)
    t = o.new_empty(r)
    idx = o.new_empty(r, dtype=torch.int32)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("pair_first_hit", "first_hit_pair", [vp] * 9 + [ci] * 4 + [vp] * 4)
    launch_counts["first_hit_pair"] += 1
    err = fn(_ptr(o), _ptr(d), ctypes.c_void_p(0 if alive is None else alive.data_ptr()), _ptr(center),
             _ptr(tile_lo), _ptr(tile_hi), _ptr(bvh.rows), _ptr(bvh.face), _ptr(bvh.boxes), r, n_tiles, n_leaves, k,
             _ptr(t), _ptr(idx), ctypes.c_void_p(0 if counts is None else counts.data_ptr()), _stream(o))
    _raise_on(err, "first_hit_pair")
    return t, idx
