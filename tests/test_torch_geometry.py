"""The port's mesh and spatial queries against the JAX package's.

The port keeps its own copy of geometry/mesh.py: the same room generators and
the same vertex-clustering LOD must come out of both, bit for bit, and the
queries over them must agree (booleans identical; first-hit t to the f32
tolerance of tests/test_pallas.py, face indices identical).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry import mesh as jmesh
from audiblelight_tpu.geometry import queries as jq
from audiblelight_tpu_torch.geometry import mesh as tmesh
from audiblelight_tpu_torch.geometry import queries as tq
from audiblelight_tpu_torch.micarrays import ambeovr_capsules

torch.set_num_threads(1)


def _rooms():
    return {
        "box": (jmesh.box_mesh(extents=[6.0, 4.0, 3.0], center=[3.0, 2.0, 1.5]),
                tmesh.box_mesh(extents=[6.0, 4.0, 3.0], center=[3.0, 2.0, 1.5])),
        "scanned": (jmesh.scanned_like_room(extents=(7, 5, 3), subdivision_levels=2, seed=3),
                    tmesh.scanned_like_room(extents=(7, 5, 3), subdivision_levels=2, seed=3)),
    }


@pytest.fixture(scope="module")
def rooms():
    return _rooms()


@pytest.mark.parametrize("name", ["box", "scanned"])
def test_same_triangles_and_derived_quantities(rooms, name):
    j, t = rooms[name]
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_array_equal(t.triangles, j.triangles)
    np.testing.assert_array_equal(t.face_normals, j.face_normals)
    assert t.area == j.area
    assert t.is_watertight == j.is_watertight
    assert t.is_convex == j.is_convex == (name == "box")


@pytest.mark.parametrize("kw", [dict(target_faces=400), dict(voxel=0.3)])
def test_same_acoustic_lod(rooms, kw):
    j, t = rooms["scanned"]
    lj, lt = j.simplified(**kw), t.simplified(**kw)
    np.testing.assert_array_equal(lt.vertices, lj.vertices)
    np.testing.assert_array_equal(lt.faces, lj.faces)
    assert lt.metadata == lj.metadata
    assert t.simplified(**kw) is lt  # memoised


def test_ambeovr_capsules_match_reference():
    from audiblelight_tpu.micarrays import AmbeoVR

    center = np.array([3.1, 2.2, 1.4])
    np.testing.assert_allclose(
        ambeovr_capsules(center), AmbeoVR().coordinates_cartesian + center, atol=1e-12
    )


@pytest.mark.parametrize("name", ["box", "scanned"])
def test_queries_match_reference(rooms, rng, name):
    j, t = rooms[name]
    tris = j.triangles.astype(np.float32)
    lo, hi = j.bounds
    pts = rng.uniform(lo - 0.5, hi + 0.5, (400, 3)).astype(np.float32)
    ends = rng.uniform(lo, hi, (400, 3)).astype(np.float32)
    dirs = rng.standard_normal((400, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    tt = torch.from_numpy(t.triangles.astype(np.float32))
    P, E, D = map(torch.from_numpy, (pts, ends, dirs))

    inside_j = np.asarray(jq.points_inside_mesh(jnp.asarray(pts), jnp.asarray(tris)))
    inside_t = tq.points_inside_mesh(P, tt).numpy()
    np.testing.assert_array_equal(inside_t, inside_j)
    assert 0 < inside_t.sum() < len(inside_t)

    occ_j = np.asarray(jq.segments_occluded(jnp.asarray(pts), jnp.asarray(ends), jnp.asarray(tris)))
    np.testing.assert_array_equal(tq.segments_occluded(P, E, tt).numpy(), occ_j)

    t_j, i_j = map(np.asarray, jq.ray_mesh_first_hit(jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(tris)))
    t_t, i_t = (x.numpy() for x in tq.ray_mesh_first_hit(P, D, tt))
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-4, atol=2e-5)
