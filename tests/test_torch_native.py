"""The port's host BVH (`geometry/native.py`, its copy of cpp/geomlib.cpp)
against the JAX package's NativeBVH and the port's torch queries, and rlr
placement through it.

On a scanned room the port's library, built with the reference's flags,
answers point in mesh, nearest-surface distance, first hit and segment
occlusion with the reference library's bits; its booleans equal the port's
torch queries (the CPU path of the card's) and its distances are within
1e-5 m of them. A scene placed under a seed gives the reference's `to_dict`
(but for the creation time) and DCASE CSV bytes with the host BVH, and the
same with the BVH taken away (the torch queries, with the reference's
warning).
"""

import json
import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene as JaxScene
from audiblelight_tpu import utils as jutils
from audiblelight_tpu.geometry.native import NativeBVH as JaxBVH
from audiblelight_tpu.synthesize import generate_dcase2024_metadata as jax_dcase
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.geometry import native
from audiblelight_tpu_torch.geometry.mesh import save_obj, scanned_like_room
from audiblelight_tpu_torch.geometry.queries import nearest_surface_distance, points_inside_mesh, segments_occluded
from audiblelight_tpu_torch.synthesize import dcase_csv_text, generate_dcase2024_metadata
from audiblelight_tpu_torch.worldstate.mesh_backend import WorldStateRLR

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


@pytest.fixture(scope="module")
def room():
    """A nonconvex scanned room (6,912 faces) and its bounds."""
    mesh = scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=2, seed=0)
    return mesh.triangles.astype(np.float32), mesh.bounds


@pytest.fixture(scope="module")
def queries(room):
    """Random points around the room, unit directions and segment ends inside its box."""
    _, (lo, hi) = room
    rng = np.random.default_rng(0)
    pts = rng.uniform(lo - 0.3, hi + 0.3, (1500, 3)).astype(np.float32)
    dirs = rng.standard_normal((1500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ends = rng.uniform(lo, hi, (1500, 3)).astype(np.float32)
    return pts, dirs, ends


def test_build_is_keyed_and_uses_the_reference_flags():
    assert native.native_available()
    assert native.CXX_FLAGS == ["-O3", "-shared", "-fPIC"]
    path = native.lib_path()
    assert path.exists() and path.parent.parent == native.BUILD_DIR


def test_native_bvh_equals_the_reference_bit_for_bit(room, queries):
    tris, _ = room
    pts, dirs, ends = queries
    port, ref = native.NativeBVH(tris), JaxBVH(tris)
    np.testing.assert_array_equal(port.contains(pts), ref.contains(pts))
    np.testing.assert_array_equal(port.nearest_surface_distance(pts).view(np.int32),
                                  ref.nearest_surface_distance(pts).view(np.int32))
    t_p, f_p = port.ray_first_hit(pts, dirs)
    t_r, f_r = ref.ray_first_hit(pts, dirs)
    np.testing.assert_array_equal(t_p.view(np.int32), t_r.view(np.int32))
    np.testing.assert_array_equal(f_p, f_r)
    np.testing.assert_array_equal(port.segments_occluded(pts, ends), ref.segments_occluded(pts, ends))
    assert port.contains(pts).any() and not port.contains(pts).all()
    assert port.segments_occluded(pts, ends).any()


def test_native_bvh_equals_the_torch_queries(room, queries):
    """Booleans equal, distances within 1e-5 m."""
    tris, _ = room
    pts, _, ends = queries
    bvh, t = native.NativeBVH(tris), torch.as_tensor(tris)
    p, e = torch.as_tensor(pts), torch.as_tensor(ends)
    np.testing.assert_array_equal(bvh.contains(pts), points_inside_mesh(p, t).numpy())
    np.testing.assert_array_equal(bvh.segments_occluded(pts, ends), segments_occluded(p, e, t).numpy())
    gap = np.abs(bvh.nearest_surface_distance(pts) - nearest_surface_distance(p, t).numpy()).max()
    print(f"nearest-surface distance: host BVH against the torch query, max gap {gap:.3e} m")
    assert gap <= 1e-5


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    obj = save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")
    return root / "fg", obj


def _scene(scene_cls, seed_everything, fg, obj, **device):
    seed_everything(7)
    scene = scene_cls(
        duration=8.0, sample_rate=24000, backend="rlr", fg_path=fg, max_overlap=2,
        backend_kwargs=dict(mesh=str(obj), seed=11, add_to_context=False,
                            rlr_kwargs=dict(indirect_ray_count=64, indirect_ray_depth=4, max_ir_length=0.1,
                                            mesh_simplification=True)),
        **device,
    )
    scene.add_microphone(microphone_type="ambeovr")
    for event_type in ("static", "static", "moving"):
        scene.add_event(event_type=event_type, max_place_attempts=100)
    return scene


def _metadata(scene, csv_text) -> tuple:
    d = json.loads(json.dumps(scene.to_dict()))
    d.pop("creation_time")
    return d, csv_text(scene)


@pytest.mark.parametrize("bvh", ["host", "torch"])
def test_placement_matches_reference(assets, bvh, monkeypatch, caplog):
    """The same seed places the reference's scene, through the host BVH and
    through the torch queries with the BVH taken away."""
    fg, obj = assets
    want = _metadata(_scene(JaxScene, jutils.seed_everything, fg, obj),
                     lambda s: jax_dcase(s)["mic000"].to_csv(sep=",", encoding="utf-8", header=None))
    calls = []
    real = WorldStateRLR.native_bvh.fget

    def counted(self):
        out = real(self) if bvh == "host" else None
        calls.append(out is not None)
        return out

    monkeypatch.setattr(WorldStateRLR, "native_bvh", property(counted))
    got = _metadata(_scene(PortScene, tutils.seed_everything, fg, obj, device="cpu"),
                    lambda s: dcase_csv_text(generate_dcase2024_metadata(s)["mic000"]))
    assert calls and all(calls) == (bvh == "host")
    assert got == want


def test_native_unavailable_warns_and_falls_back(monkeypatch, caplog, tmp_path):
    """Without the library the world state answers through the torch queries
    and the loader logs the reference's warning. The build is pointed at a
    missing source in the test's own directory, so it fails there."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_FAILED", False)
    monkeypatch.setattr(native, "SRC", tmp_path / "missing.cpp")
    monkeypatch.setattr(native, "lib_path", lambda: tmp_path / "build" / "libgeom.so")
    with caplog.at_level("WARNING"):
        assert not native.native_available()
    assert "Native geometry library unavailable" in caplog.text
    ws = WorldStateRLR(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), device="cpu")
    assert ws.native_bvh is None
    assert ws.path_exists_between_points(np.array([3.0, 2.0, 1.5]), np.array([2.0, 1.5, 1.2]))
