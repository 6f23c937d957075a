"""The face tree of the big first hit (K1 big, csrc/first_hit.cu) on the CPU.

The kernel walks a tree of padded boxes over Morton-sorted leaves of 16
faces and must return the dense walk's bits. These tests hold, without the
card:

- the build: every face that can hit lies in exactly one leaf, the 1e9
  sentinels and degenerate faces in none; the gathered rows equal the dense
  table's rows bit for bit; every box holds its children's boxes, and each
  leaf's box its faces' vertices with the pad;
- a cull certificate: for each ray, every ancestor of the leaf that holds the
  dense walk's hit face has a slab entry (the kernel's predicate, term for
  term: `cuda_kernels.slab_entry_exit`) no later than its exit and than the
  dense t, so no node on the path to the true hit can be skipped;
- the kernel's walk order in its plain version (`first_hit_walk_plain`)
  equal to the dense walk bit for bit (t and face) on the same rays;
- against the Pallas kernel in interpret mode, faces identical and t within
  rtol 1e-4 (XLA:CPU contracts the interpret-mode body's multiply-adds into
  FMAs; the port does not), as tests/test_torch_kernels.py holds the dense
  walk.

The rays: interior rays and second-bounce surface rays (the tracer's 1e-4 m
offset and on the surface itself) in a subdivided `scanned_like_room` and
on its LOD, rays grazing a face within 1e-6 rad toward a point on it,
axis-aligned directions with zero components, origins on vertices and edge
midpoints, rays with NaN or inf components, and a sentinel-padded mesh.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.ops.pallas_kernels import ray_first_hit_pallas
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from test_torch_cuda import _dense, _with_sentinels, accel_meshes, ray_set


@pytest.fixture(scope="module")
def meshes():
    return accel_meshes()


def certificate(table, o, d, t_star, f_star):
    """(held (R,) bool, smallest slack): a ray holds where it misses or every
    ancestor of the leaf holding its dense hit face enters (entry <= exit)
    no later than t*; the slack is the least t* - entry over the rays."""
    _, center, _, bvh = table
    o_c = torch.from_numpy(o) - center
    inv = ck.slab_inverse(torch.from_numpy(d))
    pos = torch.full((int(bvh.face.max()) + 1,), -1, dtype=torch.int64)
    real = bvh.face >= 0
    pos[bvh.face[real].long()] = torch.nonzero(real).squeeze(1)
    hit = torch.from_numpy(f_star >= 0)
    node = bvh.n_leaves + pos[torch.from_numpy(f_star)[hit].long()] // bvh.leaf_faces
    t = torch.from_numpy(t_star)[hit]
    held = torch.ones(len(o), dtype=torch.bool)
    ok, slack = torch.ones(len(t), dtype=torch.bool), np.inf
    while True:
        entry, exit_ = ck.slab_entry_exit(o_c[hit], inv[hit], bvh.boxes[node, 0:3], bvh.boxes[node, 4:7])
        ok &= (entry <= exit_) & (entry <= t)
        slack = min(slack, float((t - entry).min()))
        if int(node.max()) == 1:
            held[hit] = ok
            return held.numpy(), slack
        node = node // 2


def off_face(tris, o, d, t_star, f_star):
    """(R,) metres by which each dense hit point lies outside its face's box (0 on a miss)."""
    hit = f_star >= 0
    t = np.where(hit, t_star, 0.0).astype(np.float64)
    p = np.where(hit[:, None], o.astype(np.float64) + t[:, None] * np.where(hit[:, None], d, 0.0), 0.0)
    tri = tris[np.maximum(f_star, 0)].astype(np.float64)
    off = np.maximum(np.maximum(tri.min(1) - p, p - tri.max(1)), 0.0).max(1)
    return np.where(hit, off, 0.0)


@pytest.mark.parametrize("which", ["room", "lod", "room_sentinels"])
def test_face_tree_build(meshes, which):
    tris = _with_sentinels(meshes["room"], 3) if which == "room_sentinels" else meshes[which]
    tris_t = torch.from_numpy(tris)
    variant, center, tab, bvh = ck.first_hit_table(tris_t)
    assert variant == "big" and bvh.n_leaves & (bvh.n_leaves - 1) == 0
    sentinel = (np.abs(tris) >= 1e8).any(axis=(1, 2))
    real = np.flatnonzero(~sentinel)
    face = bvh.face.numpy()
    # Each real face in exactly one leaf, no sentinel; padding only at the end
    np.testing.assert_array_equal(np.sort(face[face >= 0]), real)
    n = len(real)
    assert (face[:n] >= 0).all() and (face[n:] == -1).all()
    assert bvh.n_leaves == 1 << int(np.ceil(np.log2(-(-n // bvh.leaf_faces))))
    # Rows are the dense table's, bit for bit; padding rows are zero
    assert torch.equal(bvh.rows[:n].view(torch.int32), tab[bvh.face[:n].long()].view(torch.int32))
    assert not bvh.rows[n:].any()
    # Boxes: each parent holds its children; each leaf its faces' vertices with the pad
    lo, hi = bvh.boxes[:, 0:3].double().numpy(), bvh.boxes[:, 4:7].double().numpy()
    kids = np.arange(2, 2 * bvh.n_leaves)
    assert (lo[kids // 2] <= lo[kids]).all() and (hi[kids // 2] >= hi[kids]).all()
    verts = (tris_t.double() - center.double()).numpy()[np.maximum(face, 0)]  # (L * 16, 3, 3)
    leaf = bvh.n_leaves + np.arange(len(face)) // bvh.leaf_faces
    live = face >= 0
    assert (lo[leaf][live][:, None] <= verts[live] - ck.BVH_PAD).all()
    assert (hi[leaf][live][:, None] >= verts[live] + ck.BVH_PAD).all()
    empty = np.flatnonzero(np.isinf(lo[:, 0]))
    assert (lo[empty] == np.inf).all() and (hi[empty] == -np.inf).all()


CASES = [("room", k) for k in ("interior", "surface", "on_surface", "grazing", "axis", "vertex_edge", "nonfinite")]
CASES += [("lod", k) for k in ("interior", "surface", "grazing", "axis")] + [("room_sentinels", "surface")]


def _case(meshes, which, kind):
    base = meshes["room" if which == "room_sentinels" else which]
    tris = _with_sentinels(base, 5) if which == "room_sentinels" else base
    o, d = ray_set(kind, base, seed=zlib.crc32(f"{which} {kind}".encode()))
    table = ck.first_hit_table(torch.from_numpy(tris))
    return tris, o, d, table, *_dense(tris, o, d)


@pytest.mark.parametrize("which,kind", CASES)
def test_walk_certificate_and_equality(meshes, which, kind):
    """Every ancestor of the dense hit's leaf is entered no later than the
    dense t, and the kernel's walk gives the dense bits."""
    tris, o, d, table, t_star, f_star = _case(meshes, which, kind)
    if kind == "nonfinite":
        bad = ~np.isfinite(np.concatenate([o, d], axis=1)).all(axis=1)
        assert bad.any() and np.isinf(t_star[bad]).all() and (f_star[bad] == -1).all()
    else:
        assert (f_star >= 0).mean() > 0.9
    held, slack = certificate(table, o, d, t_star, f_star)
    print(f"{which} {kind}: {len(o)} rays, {(f_star >= 0).sum()} hits, smallest t* - ancestor entry {slack:.3e}, "
          f"largest dense hit off its face {off_face(tris, o, d, t_star, f_star).max():.3e} m")
    assert held.all()
    t_w, f_w, visits = ck.first_hit_walk_plain(torch.from_numpy(o), torch.from_numpy(d), table)
    np.testing.assert_array_equal(f_w.numpy(), f_star)
    np.testing.assert_array_equal(t_w.numpy().view(np.int32), t_star.view(np.int32))
    assert float(visits[:, 1].double().mean()) < 0.25 * table[3].n_leaves


def test_near_plane_rays_only_miss_noise_hits(meshes):
    """Rays that run within microns of a face's plane at 0-1e-6 rad: there
    the dense walk's own hits are rounding noise (t_num and a both ~1 ulp,
    the hit point metres off the face). The certificate holds wherever the
    dense hit lies within half the pad of its face's box, and the walk gives
    the dense bits on every ray the certificate holds for."""
    tris, o, d, table, t_star, f_star = _case(meshes, "room", "near_plane")
    held, _ = certificate(table, o, d, t_star, f_star)
    off = off_face(tris, o, d, t_star, f_star)
    print(f"near-plane rays: {len(o)}, certificate fails on {(~held).sum()}, dense hits off their face by more "
          f"than half the pad {(off > ck.BVH_PAD / 2).sum()} (largest {off.max():.3f} m)")
    assert (off[~held] > ck.BVH_PAD / 2).all()
    t_w, f_w, _ = ck.first_hit_walk_plain(torch.from_numpy(o), torch.from_numpy(d), table)
    np.testing.assert_array_equal(f_w.numpy()[held], f_star[held])
    np.testing.assert_array_equal(t_w.numpy()[held].view(np.int32), t_star[held].view(np.int32))


@pytest.mark.parametrize("which,kind", [("lod", "interior"), ("room", "interior"), ("lod", "surface")])
def test_walk_matches_pallas(meshes, which, kind):
    """The walk against the Pallas kernel in interpret mode: faces identical
    on interior rays; on surface rays a face may differ only at a shared
    edge, where both arithmetics hit two faces at t within rtol 1e-5 and
    break the tie by their own rounding (XLA:CPU's FMAs). Grazing rays are
    left to the certificate above: there the FMAs move t by ~1e-6 m / sin of
    the angle, past rtol 1e-4 at 3e-3 rad, in the dense walk as much as in
    the tree's."""
    tris = meshes[which]
    o, d = ray_set(kind, tris, seed=11, n=256)
    t_p, i_p = map(np.asarray, ray_first_hit_pallas(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris),
                                                    interpret=True))
    t_w, i_w, _ = ck.first_hit_walk(torch.from_numpy(o), torch.from_numpy(d), ck.first_hit_table(torch.from_numpy(tris)))
    t_w, i_w = t_w.numpy(), i_w.numpy()
    np.testing.assert_array_equal(np.isinf(t_w), np.isinf(t_p))
    np.testing.assert_allclose(t_w, t_p, rtol=1e-4, atol=2e-5)
    edge = i_w != i_p
    print(f"{which} {kind}: faces differ from Pallas on {edge.sum()} of {len(o)} rays")
    if kind == "interior":
        assert not edge.any()
    assert edge.mean() <= 0.02 and (np.abs(t_w[edge] - t_p[edge]) <= 1e-5 * t_p[edge]).all()


def test_small_variant_has_no_tree(meshes):
    """F <= 512 keeps the classic variant and no tree; the walk refuses it."""
    tris = torch.from_numpy(meshes["lod"][:500])
    small = ck.first_hit_table(tris)
    assert small[0] == "small" and small[3] is None
    o, d = ray_set("interior", meshes["lod"], seed=2, n=64)
    with pytest.raises(ValueError):
        ck.first_hit_walk(torch.from_numpy(o), torch.from_numpy(d), small)
