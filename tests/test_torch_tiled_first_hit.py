"""The port's reachability-culled first hit (K7) against the JAX package.

- `build_mesh_tiles`: both builds are numpy, so the face table and the tile
  boxes are bit-equal on the 110,592-face `scanned_like_room(seed=4)`.
- `tiled_first_hit` (the plain walk here) against the reference's
  interpret-mode Pallas kernel on the rays of tests/test_tiled_first_hit.py:
  1,200 interior rays, and 600 surface-origin reflected rays on `seed=5`.
  Face indices identical; t within rtol 2e-6 on the interior rays, as that
  file holds the kernel to the dense XLA path (XLA:CPU contracts
  multiply-adds in the interpret-mode body, the port never does, so t
  differs by a few ulps), and within 1e-4 on the surface rays, as
  tests/test_torch_kernels.py holds the dense first hit: one of them hits a
  face 1.1e-5 m away, where the contracted rounding moves t by 4e-5 of
  itself.
- The walk against the port's dense classic Moller-Trumbore first hit (the
  same arithmetic without the cull) on a 6,912-face room: t and faces bit
  for bit, with fewer (block, tile) pairs tested than a dense walk where the
  blocks are coherent (one point source); escaping rays and a ragged last
  block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.mesh import scanned_like_room
from audiblelight_tpu.geometry.queries import _ray_mesh_first_hit_xla
from audiblelight_tpu.ops import tiled_first_hit as jtiled
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.ops import tiled_first_hit as ttiled

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
    t_p, i_p = ttiled.tiled_first_hit(ttiled.build_mesh_tiles(tris, device="cpu"), torch.from_numpy(o), torch.from_numpy(d))
    t_p, i_p = t_p.numpy(), i_p.numpy()
    np.testing.assert_array_equal(i_p, i_j)
    np.testing.assert_array_equal(np.isfinite(t_p), np.isfinite(t_j))
    fin = np.isfinite(t_j)
    assert fin.mean() > 0.99
    np.testing.assert_allclose(t_p[fin], t_j[fin], rtol=2e-6 if kind == "interior" else 1e-4)


@pytest.mark.parametrize("kind", ["interior", "surface", "point source"])
def test_walk_equals_dense_mt(small_room, kind):
    """The culled walk gives the dense first hit's bits on every ray. From
    one point source (four blocks of coherent rays) it tests fewer (block,
    tile) pairs than a dense walk; the scattered interior and surface rays
    make two or three blocks whose origins span the room, so their walk
    stays dense."""
    rays = {"interior": _interior_rays, "point source": _point_source_rays}
    o, d = rays[kind]() if kind in rays else _surface_rays(small_room)
    tiles = ttiled.build_mesh_tiles(small_room, device="cpu")
    t_p, i_p, visited = ttiled.tiled_walk(tiles, torch.from_numpy(o), torch.from_numpy(d))
    t_d, i_d = _dense_mt(small_room, o, d)
    np.testing.assert_array_equal(i_p.numpy(), i_d)
    np.testing.assert_array_equal(t_p.numpy(), t_d)
    tested, dense = int(visited.sum()), visited.shape[0] * tiles.n_tiles
    print(f"{kind}: {tested} of {dense} (block, tile) pairs tested, share {tested / dense:.3f}")
    assert 0 < tested <= dense
    if kind == "point source":
        assert tested < dense


def test_escaping_rays_and_ragged_last_block(small_room):
    """513 rays (one block and one ray over): a third start outside the room
    and point away from it (they escape: t = inf, face = -1), the rest are
    interior rays; all equal the dense first hit."""
    o, d = _interior_rays(513, seed=9)
    o[::3] = np.float32([-5.0, -5.0, -5.0]) + o[::3]
    d[::3] = -np.abs(d[::3])
    tiles = ttiled.build_mesh_tiles(small_room, device="cpu")
    t_p, i_p = ttiled.tiled_first_hit(tiles, torch.from_numpy(o), torch.from_numpy(d))
    t_d, i_d = _dense_mt(small_room, o, d)
    np.testing.assert_array_equal(i_p.numpy(), i_d)
    np.testing.assert_array_equal(t_p.numpy(), t_d)
    assert np.isinf(t_p.numpy()[::3]).all() and (i_p.numpy()[::3] == -1).all()
    assert np.isfinite(t_p.numpy()[1::3]).all()
