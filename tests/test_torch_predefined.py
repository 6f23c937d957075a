"""Predefined-trajectory events, navigation waypoints and file-based ambience
in the port (core.py, worldstate/mesh_backend.py, ambience.py), against the
JAX package's.

- Predefined events (the reference's tests/test_placement.py cases): from a
  given trajectory on the shoebox, the event's emitters equal the
  trajectory and its draws (scene start, duration, SNR) and derived
  velocity and resolution equal the reference's for the same seeds; without
  waypoints or a trajectory, and with a trajectory that leaves the room, the
  reference's errors are raised.
- Waypoints: a JSON named by `waypoints_json` and the default
  `resources/waypoints/gibson/<mesh>.json` (Oyens, in a room that holds its
  routes) load to the reference's waypoints, invalid routes dropped; a
  predefined event on the waypoints starts on the same route with the same
  emitters; `to_dict`/`from_dict` carry `waypoints_json` and
  `repair_threshold`.
- File ambience (the reference's tests/test_ambience.py cases and more): a
  mono file tiled over the channels, a file with the bed's channel count, a
  file with another channel count (a random channel by Python's `random`),
  resampled to the scene's rate, equal to the reference's bed bit for bit;
  `Scene.add_ambience(filepath=...)` and the background folder's random pick
  choose the reference's file; a scene with a file bed renders through the
  plan path with that bed in its mix.
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene as JaxScene
from audiblelight_tpu import utils as jutils
from audiblelight_tpu.ambience import Ambience as JaxAmbience
from audiblelight_tpu.worldstate import WorldStateRLR as JaxRLR
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.ambience import Ambience
from audiblelight_tpu_torch.core import Scene
from audiblelight_tpu_torch.geometry.mesh import box_mesh, save_obj
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.worldstate.mesh_backend import WorldStateRLR

torch.set_num_threads(1)

SR = 44100
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
def fg(tmp_path_factory):
    root = tmp_path_factory.mktemp("fg")
    d = root / "fg" / "music"
    d.mkdir(parents=True)
    t = np.arange(SR * 2) / SR
    wav_write(d / "tone.wav", (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), SR)
    return root / "fg"


def _on_shoebox_scenes(fg, action) -> list:
    """`action(scene)` on a port and a reference shoebox scene, each built
    and acted on after seeding its package's global streams alike."""
    kw = dict(duration=10.0, backend="shoebox", fg_path=fg,
              backend_kwargs=dict(dimensions=[6, 4, 3], max_order=2, max_ir_length=0.1, seed=0))
    out = []
    for cls, seed_everything, device in ((Scene, tutils.seed_everything, dict(device="cpu")),
                                         (JaxScene, jutils.seed_everything, {})):
        seed_everything(4)
        scene = cls(**kw, **device)
        scene.add_microphone(microphone_type="monocapsule", position=[3, 2, 1.5])
        out.append(action(scene))
    return out


def _event_fields(ev) -> dict:
    d = json.loads(json.dumps(ev.to_dict()))
    return {k: d[k] for k in ("scene_start", "scene_end", "event_start", "event_end", "duration", "snr",
                              "spatial_velocity", "spatial_resolution", "shape", "is_moving", "filepath",
                              "class_id", "class_label", "num_emitters")}


@pytest.mark.parametrize("overrides", [dict(scene_start=1.0, event_start=0.0, duration=2.0, snr=5.0), dict()],
                         ids=["overrides", "drawn"])
def test_predefined_event_from_trajectory_matches_reference(fg, overrides):
    traj = np.array([[1.5, 1.5, 1.5], [2.5, 2.0, 1.5], [3.5, 2.5, 1.5]])
    got, want = _on_shoebox_scenes(fg, lambda s: s.add_event(event_type="predefined", trajectory=traj, **overrides))
    assert got.is_moving and len(got.emitters) == 3
    np.testing.assert_allclose(got.start_coordinates_absolute, traj[0])
    np.testing.assert_allclose(got.end_coordinates_absolute, traj[-1])
    np.testing.assert_array_equal(np.stack([e.coordinates_absolute for e in got.emitters]), traj)
    assert _event_fields(got) == _event_fields(want)


def test_predefined_event_errors_match_reference(fg):
    bad = np.array([[1.0, 1.0, 1.0], [99.0, 99.0, 99.0]])  # leaves the room
    for kwargs in ({}, dict(trajectory=bad, scene_start=1.0, event_start=0.0, duration=2.0, snr=5.0)):
        def action(scene):
            with pytest.raises(ValueError) as err:
                scene.add_event(event_type="predefined", **kwargs)
            return str(err.value)

        got, want = _on_shoebox_scenes(fg, action)
        assert got == want
    assert got == "Provided trajectory is invalid"


def _obj_room(path: Path, extents, center) -> Path:
    return save_obj(box_mesh(extents=extents, center=center), path)


@pytest.fixture(scope="module")
def waypoint_room(tmp_path_factory):
    root = tmp_path_factory.mktemp("wp")
    obj = _obj_room(root / "room.obj", [6.0, 4.0, 3.0], [3.0, 2.0, 1.5])
    wps = [
        {"waypoints": [[1.5, 1.5, 1.5], [2.5, 2.0, 1.5], [3.5, 2.5, 1.5]]},
        {"waypoints": [[4.5, 3.0, 1.5], [4.0, 2.0, 1.5]]},
        {"waypoints": [[90.0, 90.0, 90.0], [91.0, 91.0, 91.0]]},  # invalid, dropped
    ]
    (root / "room_waypoints.json").write_text(json.dumps(wps))
    return obj, root / "room_waypoints.json"


def _states(obj, wp_json, **kw):
    rlr = dict(indirect_ray_count=256, indirect_ray_depth=8)
    return (WorldStateRLR(mesh=obj, waypoints_json=wp_json, rlr_kwargs=rlr, device="cpu", **kw),
            JaxRLR(mesh=obj, waypoints_json=wp_json, rlr_kwargs=rlr, **kw))


def test_waypoints_load_as_reference(waypoint_room):
    got, want = _states(*waypoint_room)
    assert len(got.waypoints) == len(want.waypoints) == 2
    for a, b in zip(got.waypoints, want.waypoints):
        np.testing.assert_array_equal(a, b)
    assert got.waypoints[0].shape == (3, 3)


def test_default_waypoints_of_a_named_mesh(tmp_path):
    """Oyens.json of resources/waypoints/gibson, for a mesh named Oyens."""
    obj = _obj_room(tmp_path / "Oyens.obj", [9.0, 11.0, 3.0], [1.65, -4.15, 1.4])
    got, want = WorldStateRLR(mesh=obj, device="cpu"), JaxRLR(mesh=obj)
    assert len(got.waypoints) == len(want.waypoints) > 50
    for a, b in zip(got.waypoints, want.waypoints):
        np.testing.assert_array_equal(a, b)
    assert WorldStateRLR(mesh=_obj_room(tmp_path / "Elsewhere.obj", [6, 4, 3], [3, 2, 1.5]),
                         device="cpu").waypoints == []


def test_predefined_event_from_waypoints_matches_reference(fg, waypoint_room):
    states = _states(*waypoint_room)
    events = []
    for cls, state, seed_everything, device in zip(
        (Scene, JaxScene), states, (tutils.seed_everything, jutils.seed_everything), (dict(device="cpu"), {}),
    ):
        seed_everything(2)
        scene = cls(duration=10.0, backend=state, fg_path=fg, **device)
        scene.add_microphone(microphone_type="monocapsule", position=[3, 2, 1.5])
        events.append(scene.add_event(event_type="predefined", scene_start=1.0, event_start=0.0, duration=2.0,
                                      snr=5.0))
    got, want = events
    np.testing.assert_array_equal(np.stack([e.coordinates_absolute for e in got.emitters]),
                                  np.stack([e.coordinates_absolute for e in want.emitters]))
    assert any(np.allclose(got.start_coordinates_absolute, w[0]) for w in states[0].waypoints)
    assert _event_fields(got) == _event_fields(want)


def test_serialisation_carries_waypoints_and_repair_threshold(waypoint_room):
    obj, wp_json = waypoint_room
    state = WorldStateRLR(mesh=obj, waypoints_json=wp_json, repair_threshold=0.25, device="cpu")
    d = state.to_dict()
    assert d["waypoints_json"] == str(wp_json) and d["repair_threshold"] == 0.25
    back = WorldStateRLR.from_dict(json.loads(json.dumps(d)), device="cpu")
    assert back.repair_threshold == 0.25 and back.waypoints_json == str(wp_json)
    for a, b in zip(back.waypoints, state.waypoints):
        np.testing.assert_array_equal(a, b)
    # Without waypoints the dict is the reference's, key for key
    plain, ref = WorldStateRLR(mesh=obj, device="cpu"), JaxRLR(mesh=obj)
    assert sorted(plain.to_dict()) == sorted(ref.to_dict())


# ---------------------------------------------------------------------------
# File-based ambience
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bed_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("amb")
    rng = np.random.default_rng(0)
    wav_write(root / "mono.wav", (0.3 * rng.standard_normal(SR)).astype(np.float32), SR, subtype="float32")
    wav_write(root / "four.wav", (0.3 * rng.standard_normal((4, 30000))).astype(np.float32), 24000)
    wav_write(root / "stereo.wav", (0.3 * rng.standard_normal((2, 20000))).astype(np.float32), 48000)
    return root


@pytest.mark.parametrize("name,channels,duration,sr", [
    ("mono.wav", 4, 2.5, SR), ("mono.wav", 4, 1.3, 24000), ("four.wav", 4, 3.0, 24000),
    ("stereo.wav", 4, 1.5, 24000), ("stereo.wav", 1, 0.7, 48000),
], ids=["mono tiled", "mono resampled", "channels match", "random channel", "random channel mono bed"])
def test_file_bed_matches_reference(bed_files, name, channels, duration, sr):
    beds = []
    for cls, seed_everything in ((Ambience, tutils.seed_everything), (JaxAmbience, jutils.seed_everything)):
        seed_everything(9)
        amb = cls(channels=channels, duration=duration, alias="a", filepath=bed_files / name, sample_rate=sr)
        beds.append(amb.load_ambience())
        assert amb.is_audio_loaded and amb.load_ambience() is beds[-1]
        assert amb.to_dict()["filepath"] == str(bed_files / name) and amb.beta is None
    got, want = beds
    assert got.shape == want.shape == (channels, round(duration * sr)) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.abs(got).max(axis=1), 1.0, atol=1e-6)
    back = Ambience.from_dict(json.loads(json.dumps(Ambience(
        channels=channels, duration=duration, alias="a", filepath=bed_files / name, sample_rate=sr).to_dict())))
    assert back.filepath == bed_files / name


def test_file_bed_tiling(bed_files):
    audio = Ambience(channels=4, duration=2.5, alias="a", filepath=bed_files / "mono.wav",
                     sample_rate=SR).load_ambience()
    np.testing.assert_array_equal(audio[0, :100], audio[0, SR:SR + 100])
    np.testing.assert_array_equal(audio[0], audio[3])
    with pytest.raises(AttributeError, match="Only one of"):
        Ambience(channels=1, duration=1, alias="a", noise="pink", filepath=bed_files / "mono.wav")


def test_scene_file_ambience_matches_reference(fg, bed_files):
    """add_ambience(filepath=...) and the background folder's random pick."""
    picked = []
    for cls, seed_everything, device in ((Scene, tutils.seed_everything, dict(device="cpu")),
                                         (JaxScene, jutils.seed_everything, {})):
        seed_everything(6)
        scene = cls(duration=3.0, backend="shoebox", fg_path=fg, bg_path=bed_files, sample_rate=24000,
                    backend_kwargs=dict(dimensions=[6, 4, 3], max_order=2, max_ir_length=0.1, seed=0), **device)
        scene.add_microphone(microphone_type="ambeovr", position=[3, 2, 1.5])
        scene.add_ambience()  # a random file of the background folder
        scene.add_ambience(filepath=bed_files / "stereo.wav", alias="named")
        picked.append([(a.filepath.name, a.channels, a.load_ambience()) for a in scene.ambience.values()])
    for (gn, gc, gb), (wn, wc, wb) in zip(*picked):
        assert gn == wn and gc == wc == 4
        np.testing.assert_array_equal(gb, wb)


def test_scene_with_file_bed_renders_through_the_plan_path(fg, bed_files, tmp_path):
    """The fused renderer draws only noise beds: a scene with a file bed
    renders through the plan path, its host mix holding that bed."""
    from audiblelight_tpu_torch import pipeline

    tutils.seed_everything(1)
    obj = _obj_room(tmp_path / "room.obj", [6.0, 4.0, 3.0], [3.0, 2.0, 1.5])
    scene = Scene(duration=2.0, backend="rlr", fg_path=fg, sample_rate=24000, device="cpu",
                  backend_kwargs=dict(mesh=str(obj), seed=3, add_to_context=False,
                                      rlr_kwargs=dict(indirect_ray_count=64, indirect_ray_depth=4,
                                                      max_ir_length=0.1)))
    scene.add_microphone(microphone_type="ambeovr")
    scene.add_event(event_type="static", duration=1.0, scene_start=0.5, max_place_attempts=100)
    scene.add_ambience(filepath=bed_files / "four.wav", ref_db=-20)
    assert not pipeline.FusedSceneRenderer.mix_eligible(scene)
    done = {}
    assert pipeline.render_scenes_pipelined([scene], lambda s, audio: done.update(audio)) == 1
    mix = done["mic000"]
    assert mix.shape == (4, 2 * 24000) and mix.dtype == np.float32
    # Before the event starts the mix is the bed alone, at ref_db
    bed = scene.ambience["ambience000"].load_ambience()
    head, big = slice(0, 6000), np.abs(bed[:, :6000]) > 1e-2
    ratio = mix[:, head][big] / bed[:, head][big]
    np.testing.assert_allclose(ratio, np.full_like(ratio, ratio[0]), rtol=1e-4)
