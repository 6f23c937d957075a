"""The tracer's two optional first-hit routes: K7 (`config.USE_TILED_FIRST_HIT`,
the face tree of a traced full mesh) and K8 (`config.USE_MXU_FIRST_HIT`, a
mesh of at most MXU_F_MAX faces).

- With both flags off the tracer is the one it was before the routes
  existed: its histograms hash to the values the previous tree gave (same
  generator, one thread), in the face rain mode with decimation and in the
  exact mode with the star.
- K7 in the exact mode on a 27,648-face room (64 rays x 4 bounces): the
  histogram equals, bit for bit, the trace whose bounce first hit is the
  port's dense classic Moller-Trumbore first hit (the same arithmetic
  without the cull); against the default route (K1, whose centred Plucker
  form may send an edge ray to the other face) per-band energy within 1 %.
- K8 on a 2,000-face LOD against the JAX tracer on the CPU (which never
  takes the route): per (source, capsule, band) energy and per-source T30
  within the 5 % of tests/test_torch_raytracer.py.
- Where each route applies: `MeshDeviceState.tiled_tree` and the tree
  `trace_rirs` passes, `_mxu_tables_for`.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.rir import raytracer as jrt
from audiblelight_tpu_torch import config
from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
from audiblelight_tpu_torch.micarrays import ambeovr_capsules
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.ops.star_occlusion import build_star_accel
from audiblelight_tpu_torch.ops.cuda_kernels import FaceBVH
from audiblelight_tpu_torch.ops.tiled_first_hit import build_tiled_tree
from audiblelight_tpu_torch.rir import raytracer as trt
from audiblelight_tpu_torch.worldstate.mesh_backend import MeshDeviceState
from test_torch_raytracer import _t, _t30

torch.set_num_threads(1)

CENTRE = np.array([3.5, 2.5, 1.5])
CAPS = ambeovr_capsules(CENTRE).astype(np.float32)
# sha256 of the float32 histogram bytes of `_default_trace(case)` on the tree
# before the routes were added (commit 0681318), with one torch thread and
# the PyTorch CPU build these tests run on; another build may round a random
# draw differently, and then the hashes are recomputed on that tree
GOLDEN = {
    "face": "e63067112a16cad1c2380727e20c969c61e104b69f037fcc95937395c8cbd0ee",
    "exact": "c1b87ca7579958ade8759bc9885a6a2519bd5f10db7406c7a6ece6424942563d",
}


@pytest.fixture(autouse=True)
def routes_off(monkeypatch):
    """Both flags off unless a test turns one on; monkeypatch restores them."""
    monkeypatch.setattr(config, "USE_TILED_FIRST_HIT", False)
    monkeypatch.setattr(config, "USE_MXU_FIRST_HIT", False)


def _room(levels=None, lod_faces=None):
    """(tris, normals, absorption, scattering) of the flagship-shaped room at
    `levels` subdivisions, or of its `lod_faces`-face LOD."""
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=levels or 5, seed=0)
    if lod_faces is not None:
        mesh = mesh.simplified(target_faces=lod_faces)
    f = len(mesh.faces)
    return (mesh.triangles.astype(np.float32), mesh.face_normals.astype(np.float32),
            np.tile(np.array([[0.10, 0.15, 0.20, 0.30]], np.float32), (f, 1)), np.full(f, 0.4, np.float32))


@pytest.fixture(scope="module")
def exact_room():
    tris, normals, ab, sc = _room(4)
    assert len(tris) == 27648
    return tris, normals, ab, sc, build_star_accel(tris, CAPS.mean(axis=0), 0.02, device="cpu")


def _exact_trace(exact_room, **kw):
    tris, normals, ab, sc, star = exact_room
    return trt.trace_energy_histogram_multi(
        torch.Generator().manual_seed(0), _t(tris), _t(ab), _t(sc), _t([[1.5, 1.2, 1.4]]), _t(CAPS), n_rays=64,
        max_depth=4, n_bins=64, bin_dt=0.002, tri_normals=_t(normals), star=star, **kw).numpy()


def _default_trace(case, exact_room):
    if case == "exact":
        return _exact_trace(exact_room)
    tris, normals, ab, sc = _room(1)
    occ = trt.face_rain_occlusion(_t(tris), _t(normals), _t(CAPS.mean(axis=0, keepdims=True)))
    return trt.trace_energy_histogram_multi(
        torch.Generator().manual_seed(0), _t(tris), _t(ab), _t(sc), _t([[1.5, 1.2, 1.4], [5.6, 3.9, 1.1]]),
        _t(CAPS), n_rays=2048, max_depth=24, n_bins=64, bin_dt=0.002, tri_normals=_t(normals), decimate=True,
        face_occlusion=occ).numpy()


@pytest.mark.parametrize("case", ["face", "exact"])
def test_default_trace_unchanged(case, exact_room):
    hist = _default_trace(case, exact_room)
    assert hist.dtype == np.float32
    assert hashlib.sha256(hist.tobytes()).hexdigest() == GOLDEN[case], float(hist.astype(np.float64).sum())


def _counting(monkeypatch, name):
    """Wrap raytracer.<name> to count its calls."""
    calls = []
    inner = getattr(trt, name)

    def wrapped(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(trt, name, wrapped)
    return calls


def test_tiled_route_equals_dense_mt(exact_room, monkeypatch):
    tris = _t(exact_room[0])
    tree = build_tiled_tree(exact_room[0], device="cpu")
    calls = _counting(monkeypatch, "tiled_first_hit")
    tiled = _exact_trace(exact_room, tiled_tree=tree)
    assert len(calls) == 4
    dense = ck.dense_mt_table(tris)
    monkeypatch.setattr(trt, "tiled_first_hit", lambda _tree, o, d: ck.ray_first_hit(o, d, tris, dense))
    np.testing.assert_array_equal(tiled, _exact_trace(exact_room, tiled_tree=tree))
    k1 = _exact_trace(exact_room)
    assert tiled.sum() > 0
    np.testing.assert_allclose(tiled.sum(axis=(0, 1, 3)), k1.sum(axis=(0, 1, 3)), rtol=0.01)


def test_mxu_route_statistics(monkeypatch):
    """K8 against the JAX tracer's dense first hit on a 2,000-face LOD with
    per-face rain visibility: per (source, capsule, band) energy and
    per-source T30 within 5 %."""
    tris, normals, ab, sc = _room(lod_faces=2000)
    assert len(tris) <= 2000
    src = np.array([[1.5, 1.2, 1.4], [5.6, 3.9, 1.1]], np.float32)
    kw = dict(n_rays=2048, max_depth=24, n_bins=150, bin_dt=0.002, decimate=True)
    centre = CAPS.mean(axis=0, keepdims=True)
    occ_j = jrt.face_rain_occlusion(jnp.asarray(tris), jnp.asarray(normals), jnp.asarray(centre))
    want = np.asarray(jrt.trace_energy_histogram_multi(
        jax.random.PRNGKey(0), jnp.asarray(tris), jnp.asarray(ab), jnp.asarray(sc), jnp.asarray(src),
        jnp.asarray(CAPS), n_sources=2, tri_normals=jnp.asarray(normals), face_occlusion=occ_j, **kw))
    monkeypatch.setattr(config, "USE_MXU_FIRST_HIT", True)
    calls = _counting(monkeypatch, "mxu_first_hit")
    occ_t = trt.face_rain_occlusion(_t(tris), _t(normals), _t(centre))
    got = trt.trace_energy_histogram_multi(
        torch.Generator().manual_seed(0), _t(tris), _t(ab), _t(sc), _t(src), _t(CAPS), tri_normals=_t(normals),
        face_occlusion=occ_t, **kw).numpy()
    assert len(calls) == 24
    assert got.shape == want.shape == (2, 4, 4, 150)
    np.testing.assert_allclose(got.sum(-1), want.sum(-1), rtol=0.05)
    for e in range(2):
        t_got, t_want = _t30(got[e].sum(axis=(0, 1)), 0.002), _t30(want[e].sum(axis=(0, 1)), 0.002)
        assert abs(t_got / t_want - 1) < 0.05, (t_got, t_want)


def test_mesh_tiles_where_the_route_applies(monkeypatch):
    big = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=4, seed=0)
    small = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=3, seed=0)
    st_big = MeshDeviceState.from_mesh(big, device="cpu")
    assert st_big.tiled_tree is None  # flag off
    monkeypatch.setattr(config, "USE_TILED_FIRST_HIT", True)
    assert MeshDeviceState.from_mesh(small, device="cpu").tiled_tree is None  # 6,912 < 16,384 faces
    tree = st_big.tiled_tree
    assert isinstance(tree, FaceBVH) and int((tree.face >= 0).sum()) == 27648 and st_big.tiled_tree is tree

    passed = []
    monkeypatch.setattr(trt, "trace_rirs_multi", lambda *a, **kw: passed.append(kw["tiled_tree"]))
    src, lis = _t([[1.5, 1.2, 1.4]]), _t(CAPS)
    rain = dict(face_occlusion=None, star=None, occlusion=True, shared_visibility=True)
    st_big.trace_rirs(torch.Generator(), src, lis, "omni", rain)
    st_lod = MeshDeviceState.from_mesh(big, cfg=dict(mesh_simplification=True), device="cpu")
    st_lod.trace_rirs(torch.Generator(), src, lis, "omni", rain)
    assert passed[0] is tree and passed[1] is None  # the LOD is traced: no K7 tree


def test_mxu_tables_where_the_route_applies(monkeypatch):
    tris = _t(_room(1)[0])
    assert trt._mxu_tables_for(tris, None) is None  # flag off
    monkeypatch.setattr(config, "USE_MXU_FIRST_HIT", True)
    assert trt._mxu_tables_for(tris, None).n_faces == len(tris)
    assert trt._mxu_tables_for(tris, build_tiled_tree(tris, device="cpu")) is None  # K7's tree wins
    too_many = torch.rand((trt.MXU_F_MAX + 1, 3, 3))
    assert trt._mxu_tables_for(too_many, None) is None
