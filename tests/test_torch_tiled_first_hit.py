"""The port's tiled first hit (K7) against the JAX package and the dense walk.

- `build_mesh_tiles`: both builds are numpy, so the face table and the tile
  boxes are bit-equal on the 110,592-face `scanned_like_room(seed=4)`.
- `tiled_first_hit` (the plain walk of `build_tiled_tree`'s tree here)
  against the reference's
  interpret-mode Pallas kernel on the rays of tests/test_tiled_first_hit.py:
  1,200 interior rays, and 600 surface-origin reflected rays on `seed=5`.
  Face indices identical; t within rtol 2e-6 on the interior rays, as that
  file holds the kernel to the dense XLA path (XLA:CPU contracts
  multiply-adds in the interpret-mode body, the port never does, so t
  differs by a few ulps), and within 1e-4 on the surface rays, as
  tests/test_torch_kernels.py holds the dense first hit: one of them hits a
  face 1.1e-5 m away, where the contracted rounding moves t by 4e-5 of
  itself.
- The kernel's walk of the mesh's face tree (its plain version,
  `tiled_walk`) against the dense classic Moller-Trumbore first hit (the same
  arithmetic over every face: `ray_first_hit_plain` with `dense_mt_table`)
  on a 6,912-face room: t and faces bit for bit, a few leaves per ray;
  escaping rays.
- The cull certificate for the classic Moller-Trumbore rounding (the pad was
  first certified for K1 big's bilinear arithmetic): on the rays of
  tests/test_torch_first_hit_accel.py (interior, surface, grazing,
  axis-aligned, vertex and edge, non-finite, sentinel-padded), every ancestor
  of the leaf holding the dense hit enters no later than the dense t, and
  the walk equals the dense walk; on rays within microns of a face's plane
  the certificate fails only for dense hits that are rounding noise off
  their face.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.mesh import scanned_like_room
from audiblelight_tpu.geometry.queries import _ray_mesh_first_hit_xla
from audiblelight_tpu.ops import tiled_first_hit as jtiled
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.ops import tiled_first_hit as ttiled
from test_torch_cuda import _with_sentinels, accel_meshes, ray_set
from test_torch_first_hit_accel import CASES, off_face, tree_certificate

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def room4():
    return np.asarray(scanned_like_room(seed=4).triangles, np.float32)


@pytest.fixture(scope="module")
def small_room():
    """6,912 faces (27 tiles): the dense comparisons stay quick."""
    return np.asarray(scanned_like_room(seed=4, subdivision_levels=3).triangles, np.float32)


def _interior_rays(n=1200, seed=3):
    rng = np.random.default_rng(seed)
    o = np.float32(rng.uniform([0.3, 0.3, 0.2], [6.7, 4.7, 2.8], size=(n, 3)))
    d = rng.normal(size=(n, 3))
    return o, np.float32(d / np.linalg.norm(d, axis=-1, keepdims=True))


def _surface_rays(tris, n=600, seed=4):
    """Rays launched 1e-4 off the faces that interior rays hit, along their
    specular reflections (tests/test_tiled_first_hit.py's recipe)."""
    rng = np.random.default_rng(seed)
    o0 = np.float32(rng.uniform([0.4, 0.4, 0.3], [6.6, 4.6, 2.7], size=(n, 3)))
    d0 = rng.normal(size=(n, 3))
    d0 = np.float32(d0 / np.linalg.norm(d0, axis=-1, keepdims=True))
    t0, f0 = map(np.asarray, _ray_mesh_first_hit_xla(jnp.asarray(o0), jnp.asarray(d0), jnp.asarray(tris)))
    hit = o0 + t0[:, None] * d0
    v = tris[np.maximum(f0, 0)]
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    nrm = np.where((np.sum(nrm * d0, axis=-1) > 0)[:, None], -nrm, nrm)
    refl = d0 - 2 * np.sum(d0 * nrm, axis=-1, keepdims=True) * nrm
    return np.float32(hit + 1e-4 * nrm), np.float32(refl)


def _point_source_rays(n=2048, seed=6):
    """A bounce-0 wavefront: n directions from one interior point."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    o = np.broadcast_to(np.float32([2.1, 1.7, 1.3]), (n, 3)).copy()
    return o, np.float32(d / np.linalg.norm(d, axis=-1, keepdims=True))


def _dense_mt(tris, o, d):
    tt = torch.from_numpy(tris)
    t, i = ck.ray_first_hit(torch.from_numpy(o), torch.from_numpy(d), tt, table=ck.dense_mt_table(tt))
    return t.numpy(), i.numpy()


def test_build_mesh_tiles_matches_reference(room4):
    want = jtiled.build_mesh_tiles(room4)
    got = ttiled.build_mesh_tiles(room4, device="cpu")
    assert (got.n_tiles, got.n_faces) == (want.n_tiles, want.n_faces) == (432, 110592)
    np.testing.assert_array_equal(got.face_tab.numpy(), np.asarray(want.face_tab))
    np.testing.assert_array_equal(got.tile_aabb.numpy(), np.asarray(want.tile_aabb))


def test_build_mesh_tiles_none_without_faces():
    empty = np.full((4, 3, 3), 1.0e9, np.float32)
    assert jtiled.build_mesh_tiles(empty) is None and ttiled.build_mesh_tiles(empty, device="cpu") is None


@pytest.mark.parametrize("kind", ["interior", "surface"])
def test_tiled_first_hit_matches_reference(kind):
    tris = np.asarray(scanned_like_room(seed=4 if kind == "interior" else 5).triangles, np.float32)
    o, d = _interior_rays() if kind == "interior" else _surface_rays(tris)
    t_j, i_j = map(np.asarray, jtiled.tiled_first_hit(jtiled.build_mesh_tiles(tris), jnp.asarray(o),
                                                      jnp.asarray(d), interpret=True))
    t_p, i_p = ttiled.tiled_first_hit(ttiled.build_tiled_tree(tris, device="cpu"), torch.from_numpy(o), torch.from_numpy(d))
    t_p, i_p = t_p.numpy(), i_p.numpy()
    np.testing.assert_array_equal(i_p, i_j)
    np.testing.assert_array_equal(np.isfinite(t_p), np.isfinite(t_j))
    fin = np.isfinite(t_j)
    assert fin.mean() > 0.99
    np.testing.assert_allclose(t_p[fin], t_j[fin], rtol=2e-6 if kind == "interior" else 1e-4)


@pytest.mark.parametrize("kind", ["interior", "surface", "point source"])
def test_walk_equals_dense_mt(small_room, kind):
    """The walk gives the dense first hit's bits on every ray
    (`dense_mt_table` over the mesh), and folds a few leaves of 4 faces per
    ray where a dense walk tests all 6,912 faces."""
    rays = {"interior": _interior_rays, "point source": _point_source_rays}
    o, d = rays[kind]() if kind in rays else _surface_rays(small_room)
    tree = ttiled.build_tiled_tree(small_room, device="cpu")
    t_p, i_p, visits = ttiled.tiled_walk(tree, torch.from_numpy(o), torch.from_numpy(d))
    t_d, i_d = _dense_mt(small_room, o, d)
    np.testing.assert_array_equal(i_p.numpy(), i_d)
    np.testing.assert_array_equal(t_p.numpy().view(np.int32), t_d.view(np.int32))
    tests, leaves = visits.double().mean(dim=0).tolist()
    print(f"{kind}: per ray {tests:.1f} box tests and {leaves:.2f} leaves of {tree.leaf_faces} faces")
    assert 0 < leaves * tree.leaf_faces < 0.02 * len(small_room)
    assert (visits[:, 0] > 0).all()


def test_escaping_rays_and_ragged_last_block(small_room):
    """513 rays (the old design's block of 512 and one ray over): a third
    start outside the room and point away from it (they escape: t = inf,
    face = -1), the rest are interior rays; all equal the dense first hit."""
    o, d = _interior_rays(513, seed=9)
    o[::3] = np.float32([-5.0, -5.0, -5.0]) + o[::3]
    d[::3] = -np.abs(d[::3])
    tree = ttiled.build_tiled_tree(small_room, device="cpu")
    t_p, i_p = ttiled.tiled_first_hit(tree, torch.from_numpy(o), torch.from_numpy(d))
    t_d, i_d = _dense_mt(small_room, o, d)
    np.testing.assert_array_equal(i_p.numpy(), i_d)
    np.testing.assert_array_equal(t_p.numpy(), t_d)
    assert np.isinf(t_p.numpy()[::3]).all() and (i_p.numpy()[::3] == -1).all()
    assert np.isfinite(t_p.numpy()[1::3]).all()


@pytest.fixture(scope="module")
def meshes():
    return accel_meshes()


def _mt_case(meshes, which, kind):
    """(tris, o, d, K7's tree of the mesh, dense t, dense face) of one ray
    family of tests/test_torch_first_hit_accel.py."""
    base = meshes["room" if which == "room_sentinels" else which]
    tris = _with_sentinels(base, 5) if which == "room_sentinels" else base
    o, d = ray_set(kind, base, seed=zlib.crc32(f"mt {which} {kind}".encode()))
    return (tris, o, d, ttiled.build_tiled_tree(tris, device="cpu"), *_dense_mt(tris, o, d))


@pytest.mark.parametrize("which,kind", CASES)
def test_mt_walk_certificate_and_equality(meshes, which, kind):
    """Every ancestor of the leaf holding the dense classic Moller-Trumbore
    hit is entered no later than the dense t, and K7's walk gives the dense
    bits."""
    tris, o, d, tree, t_star, f_star = _mt_case(meshes, which, kind)
    if kind == "nonfinite":
        bad = ~np.isfinite(np.concatenate([o, d], axis=1)).all(axis=1)
        assert bad.any() and np.isinf(t_star[bad]).all() and (f_star[bad] == -1).all()
    else:
        assert (f_star >= 0).mean() > 0.8
    held, slack = tree_certificate(tree, torch.from_numpy(o), torch.from_numpy(d), t_star, f_star)
    print(f"{which} {kind}: {len(o)} rays, {(f_star >= 0).sum()} hits, smallest t* - ancestor entry {slack:.3e}, "
          f"largest dense hit off its face {off_face(tris, o, d, t_star, f_star).max():.3e} m")
    assert held.all()
    t_w, f_w, visits = ttiled.tiled_walk(tree, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(f_w.numpy(), f_star)
    np.testing.assert_array_equal(t_w.numpy().view(np.int32), t_star.view(np.int32))
    assert float(visits[:, 1].double().mean()) < 0.25 * tree.n_leaves


def test_mt_near_plane_rays_only_miss_noise_hits(meshes):
    """Rays that run within microns of a face's plane at 0-1e-6 rad: the
    certificate holds wherever the dense hit lies within half the pad of its
    face's box, and the walk gives the dense bits on every such ray."""
    tris, o, d, tree, t_star, f_star = _mt_case(meshes, "room", "near_plane")
    held, _ = tree_certificate(tree, torch.from_numpy(o), torch.from_numpy(d), t_star, f_star)
    off = off_face(tris, o, d, t_star, f_star)
    print(f"near-plane rays: {len(o)}, certificate fails on {(~held).sum()}, dense hits off their face by more "
          f"than half the pad {(off > ck.BVH_PAD / 2).sum()} (largest {off.max():.3f} m)")
    assert (off[~held] > ck.BVH_PAD / 2).all()
    t_w, f_w, _ = ttiled.tiled_walk(tree, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(f_w.numpy()[held], f_star[held])
    np.testing.assert_array_equal(t_w.numpy()[held].view(np.int32), t_star[held].view(np.int32))
