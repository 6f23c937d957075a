"""Bilinear first hit of a bounce wavefront against an acoustic LOD (kernel K8).

Counterpart of audiblelight_tpu/ops/mxu_first_hit.py. Moller-Trumbore's
triple products are written as bilinear forms of one ray vector against
per-face columns. With e1 = B - A, e2 = C - A, n = e1 x e2, A' = A - centre,
k = A'.n, w1 = A' x e1, w2 = A' x e2 and o' = o - centre:

    u_num =  (o' x d).e2 + d.w2        v_num = -(o' x d).e1 - d.w1
    det   = -d.n                       t_num =  o'.n - k

The reference runs the four as (R, 16) x (16, F) matrix products on the
TPU's matrix unit; the window has a relative slop EPS_UV (2 %) so adjacent
faces overlap at shared edges, each ray's launch face is masked out, and the
winner's plane is re-evaluated exactly in f32 (outside the reference's
kernel, inside the port's).

- `build_mxu_face_tables`: the 19 non-zero entries per face of the
  reference's 16-row operands (`packed`), the planes of the exact
  re-evaluation, and the LOD's face tree over the packed rows (boxes of the
  slop-widened triangles), built once per mesh.
- `mxu_first_hit`: one launch of the K8 kernel, which centres each origin,
  forms its ray vector, walks the face tree and re-evaluates the winner's
  plane (the reference's :271-284); its plain walk on the CPU.
- `mxu_walk`: the plain walk on any device, with each ray's box tests and
  leaves.
- `mxu_first_hit_plain`: the dense selection over every face in ascending
  order and the plane re-evaluation, in plain PyTorch: the exactness
  reference, which the kernel and the walk equal bit for bit.

Precision on the card: all four products run in fp32 on the CUDA cores,
each summed left to right over its non-zero terms (the kernel and the plain
versions alike, so they agree bit for bit). The TPU ran det and t_num at
its DEFAULT precision, which rounds the inputs to bf16, and u_num and v_num
at HIGHEST; fp32 for all four is what the reference computes in interpret
mode on a CPU, and the reference records that bf16 selection noise moved
rays to false hits and cut the decay time (mxu_first_hit.py:43-55 there).
The route stays off by default (`config.USE_MXU_FIRST_HIT`); the port takes
it on every device when the flag is on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from audiblelight_tpu_torch.ops.cuda_kernels import (
    FaceBVH,
    big_face_table,
    first_hit_mxu,
    first_hit_mxu_plain,
    mxu_face_bvh,
    mxu_ray_vectors,
    mxu_walk_plain,
)
from audiblelight_tpu_torch.utils import dot3

MXU_F_TILE = 1024  # the reference's face columns come in multiples of this
MXU_F_MAX = 8192  # the reference's table bound; bigger meshes keep the dense kernel


class MxuFaceTables(NamedTuple):
    """Per-mesh operands, built once and reused every bounce."""

    normal: torch.Tensor  # (F_pad, 3) unnormalised plane normals
    plane_k: torch.Tensor  # (F_pad,) plane offsets A'.n
    center: torch.Tensor  # (3,) the translation baked into the tables
    # (F, 19) the kernel's rows [e2, w2, -e1, -w1, -n, n, -k]: the non-zero
    # entries of the reference's four (16, F_pad) operands, rows 0-5 of
    # face_u and of face_v, 3-5 of face_a and 6-9 of face_t
    packed: torch.Tensor
    n_faces: int
    bvh: FaceBVH  # the face tree of the kernel's walk over `packed`, in the centred frame

    def __repr__(self):
        return f"MxuFaceTables(faces={self.n_faces}, {self.bvh})"


def build_mxu_face_tables(tris: torch.Tensor) -> MxuFaceTables:
    """The tables for `tris` (F, 3, 3), on its device. The centre is the
    middle of the bounds of the real vertices (sentinel faces left out), as
    for the dense kernel's big variant (`cuda_kernels.big_face_table`)."""
    f = int(tris.shape[0])
    if f > MXU_F_MAX:
        raise ValueError(f"{f} faces exceeds MXU_F_MAX={MXU_F_MAX}")
    f_pad = max(MXU_F_TILE, -(-f // MXU_F_TILE) * MXU_F_TILE)
    center, tab = big_face_table(tris)  # (F, 16): [e2, w2, -e1, -w1, -n, -k]
    n, mk = -tab[:, 12:15], tab[:, 15:16]
    packed = torch.cat([tab[:, 0:15], n, mk], dim=1).contiguous()
    return MxuFaceTables(
        normal=torch.nn.functional.pad(n, (0, 0, 0, f_pad - f)).contiguous(),
        plane_k=torch.nn.functional.pad(-mk[:, 0], (0, f_pad - f)).contiguous(),
        center=center,
        packed=packed,
        n_faces=f,
        bvh=mxu_face_bvh(tris, center, packed),
    )


def mxu_inputs(tables: MxuFaceTables, origins, dirs, prev_face=None) -> tuple:
    """(centred origins o', directions, ray vectors [o' x d, d, o'] (R, 9),
    launch faces (R,) int32) of the dense selection."""
    o_c = torch.atleast_2d(origins).to(torch.float32) - tables.center
    d = torch.atleast_2d(dirs).to(torch.float32)
    if prev_face is None:
        prev = torch.full((o_c.shape[0],), -1, dtype=torch.int32, device=o_c.device)
    else:
        prev = prev_face.to(torch.int32).contiguous()
    return o_c, d, mxu_ray_vectors(o_c, d).contiguous(), prev


def _walk_inputs(origins, dirs, prev_face) -> tuple:
    """(origins, dirs, launch faces or None) as the kernel takes them."""
    o = torch.atleast_2d(origins).to(torch.float32).contiguous()
    d = torch.atleast_2d(dirs).to(torch.float32).contiguous()
    return o, d, None if prev_face is None else prev_face.to(torch.int32).contiguous()


def mxu_first_hit(tables: MxuFaceTables, origins: torch.Tensor, dirs: torch.Tensor, prev_face=None):
    """First hit (t (R,), face (R,) int32) through the K8 kernel on a CUDA
    device (one launch) and its plain walk on the CPU.

    `prev_face` (R,) int32 excludes each ray's launch face (the bounce loop
    passes the previous hit; -1 = no exclusion). t = +inf and face = -1
    where a ray escapes; t is the exact f32 plane intersection of the
    selected face, and near an edge either adjacent face may be selected
    (the window's 2 % slop)."""
    o, d, prev = _walk_inputs(origins, dirs, prev_face)
    return first_hit_mxu(o, d, prev, tables.center, tables.bvh)


def mxu_walk(tables: MxuFaceTables, origins: torch.Tensor, dirs: torch.Tensor, prev_face=None):
    """`mxu_first_hit` through the kernel's plain walk (any device), with
    the walk's counts: (t, face, visits (R, 2) int32 = box tests, leaves
    folded per ray)."""
    return mxu_walk_plain(*_walk_inputs(origins, dirs, prev_face), tables.center, tables.bvh)


def mxu_first_hit_plain(tables: MxuFaceTables, origins: torch.Tensor, dirs: torch.Tensor, prev_face=None):
    """The dense selection over every face (`cuda_kernels.first_hit_mxu_plain`)
    and the exact plane re-evaluation, in plain PyTorch (any device): what
    `mxu_first_hit` returns, bit for bit."""
    o_c, d, rvec, prev = mxu_inputs(tables, origins, dirs, prev_face)
    t_sel, idx = first_hit_mxu_plain(rvec, prev, tables.packed)

    # Exact f32 re-evaluation of the winner's plane, so hit points land on
    # the true surface (the reference's :271-284)
    safe = torch.clamp_min(idx, 0).long()
    n_g = tables.normal[safe]
    denom = dot3(d, n_g)
    numer = tables.plane_k[safe] - dot3(o_c, n_g)
    t_exact = torch.where(denom.abs() > 1.0e-9, numer / denom, t_sel)
    t_exact = torch.where(t_exact > 0.0, t_exact, t_sel)
    hit = idx >= 0
    return torch.where(hit, t_exact, torch.full_like(t_exact, float("inf"))), torch.where(hit, idx, -1)
