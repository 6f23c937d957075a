"""The port's Scene against the JAX package's: placement, metadata, plans and
the JSON round trip.

The same Scene is built in both packages from the same seeds, calls, OBJ
room and folder of WAVs. Placement draws only from host streams (Python
`random`, numpy's global stream through scipy, the world state's Generator),
so both place the same events at the same positions: the mic and emitter
positions agree to 1e-6 m (the validity masks agree exactly; the positions
are the same draws), the events' timing, files and classes are identical,
`to_dict` is identical (but for the creation time), and the DCASE CSV is
byte-identical. `build_scene_plan(trace=False)` agrees: audio exactly, the
other fields to 1e-6. A scene's JSON loads into the other package and gives
the same dict back.
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
from audiblelight_tpu.render import build_scene_plan as jax_build_scene_plan
from audiblelight_tpu.synthesize import generate_dcase2024_metadata as jax_dcase
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.geometry.mesh import save_obj, scanned_like_room
from audiblelight_tpu_torch.render import build_scene_plan
from audiblelight_tpu_torch.synthesize import dcase_csv_text, generate_dcase2024_metadata

torch.set_num_threads(1)

SR = 24000
REPO = Path(__file__).resolve().parents[1]
PLAN_KW = dict(max_static=4, max_moving=1, max_traj=32, pad_audio_seconds=2.0)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them, so the test files that run after it in
    the same process draw what they would have drawn without it."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The repo's WAVs (four DCASE2023 classes) and a 6 x 4 x 3 m nonconvex
    room as an OBJ."""
    root = tmp_path_factory.mktemp("assets")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    obj = save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")
    return root / "fg", obj


def _build(scene_cls, seed_everything, fg, obj, mic, **device):
    seed_everything(7)
    scene = scene_cls(
        duration=8.0, sample_rate=SR, backend="rlr", fg_path=fg, max_overlap=2,
        backend_kwargs=dict(mesh=str(obj), seed=11, add_to_context=False,
                            rlr_kwargs=dict(indirect_ray_count=64, indirect_ray_depth=4, max_ir_length=0.1,
                                            mesh_simplification=True)),
        **device,
    )
    scene.add_microphone(microphone_type=mic)
    for event_type in ("static", "static", "static", "moving"):
        try:
            scene.add_event(event_type=event_type, max_place_attempts=100)
        except ValueError:
            pass
    scene.add_ambience(noise="gaussian")
    return scene


def _canon(d: dict) -> dict:
    d = json.loads(json.dumps(d))
    d.pop("creation_time")
    return d


@pytest.fixture(scope="module", params=["ambeovr", "foalistener"])
def scenes(request, assets):
    fg, obj = assets
    want = _build(JaxScene, jutils.seed_everything, fg, obj, request.param)
    got = _build(PortScene, tutils.seed_everything, fg, obj, request.param, device="cpu")
    return got, want


def test_placement_matches_reference(scenes):
    got, want = scenes
    assert len(want.events) >= 3 and any(e.is_moving for e in want.events.values())
    (m_got,), (m_want,) = got.state.microphones.values(), want.state.microphones.values()
    np.testing.assert_allclose(m_got.coordinates_absolute, m_want.coordinates_absolute, rtol=0, atol=1e-6)
    assert list(got.state.emitters) == list(want.state.emitters)
    for alias, ems in want.state.emitters.items():
        pos_want = np.stack([e.coordinates_absolute for e in ems])
        pos_got = np.stack([e.coordinates_absolute for e in got.state.emitters[alias]])
        np.testing.assert_allclose(pos_got, pos_want, rtol=0, atol=1e-6)
    assert list(got.events) == list(want.events)
    for alias, ev in want.events.items():
        mine = got.events[alias]
        for k in ("scene_start", "duration", "event_start", "filepath", "class_id", "class_label",
                  "is_moving", "snr", "shape"):
            assert getattr(mine, k) == getattr(ev, k), (alias, k)


def test_to_dict_and_dcase_csv_match_reference(scenes):
    got, want = scenes
    assert _canon(got.to_dict()) == _canon(want.to_dict())
    rows = generate_dcase2024_metadata(got)
    frames = jax_dcase(want)
    assert list(rows) == list(frames) == ["mic000"]
    text = frames["mic000"].to_csv(sep=",", encoding="utf-8", header=None)
    assert len(text.splitlines()) > 10
    assert dcase_csv_text(rows["mic000"]) == text


def test_scene_plan_matches_reference(scenes):
    got, want = scenes
    plan_w = jax_build_scene_plan(want, trace=False, device=False, build_ambience=False, **PLAN_KW)
    plan_g = build_scene_plan(got, **PLAN_KW)
    assert plan_g.n_scene_samples == plan_w.n_scene_samples and plan_g.ambience is None
    for name in ("static_audio", "moving_audio"):
        np.testing.assert_array_equal(getattr(plan_g, name).numpy(), np.asarray(getattr(plan_w, name)))
    for name in ("static_irs", "moving_irs", "static_mask", "static_snr", "static_start", "static_len",
                 "static_place_len", "moving_w", "moving_mask", "moving_snr", "moving_start", "moving_len",
                 "moving_place_len", "ref_db"):
        g, w = getattr(plan_g, name).numpy(), np.asarray(getattr(plan_w, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)
    assert plan_g.moving_mask.sum() == 1


def test_scene_json_carries_both_ways(scenes, tmp_path):
    """The reference's JSON (written as its CLI writes it) loads into the
    port, and the port's into the reference, with the same emitters, events
    and microphone."""
    got, want = scenes
    for src, loader, kw in ((want, PortScene, dict(device="cpu")), (got, JaxScene, {})):
        path = tmp_path / "scene.json"
        with open(path, "w") as f:
            json.dump(src.to_dict(), f, indent=4, ensure_ascii=False)
        loaded = loader.from_json(path, **kw)
        assert _canon(loaded.to_dict()) == _canon(src.to_dict())
        assert loaded.state.num_emitters == src.state.num_emitters
        assert [e.is_moving for e in loaded.events.values()] == [e.is_moving for e in src.events.values()]


def test_generate_writes_the_reference_files(scenes, tmp_path):
    """`Scene.generate` renders through the fused renderer and writes the
    reference's file names: an int16 WAV of the rig's 4 channels, the JSON
    and the DCASE CSV, the CSV byte-identical to the reference's."""
    got, want = scenes
    got.generate(output_dir=tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "audio_out_mic000.wav", "metadata_out.json", "metadata_out_mic000.csv"]
    with open(tmp_path / "audio_out_mic000.wav", "rb") as f:
        header = f.read(44)
    assert header[20:24] == b"\x01\x00\x04\x00" and header[34:36] == b"\x10\x00"  # PCM, 4 channels, 16-bit
    assert got.audio["mic000"].shape == (4, 8 * SR) and np.abs(got.audio["mic000"]).max() > 100
    assert _canon(json.loads((tmp_path / "metadata_out.json").read_text())) == _canon(want.to_dict())
    text = jax_dcase(want)["mic000"].to_csv(sep=",", encoding="utf-8", header=None)
    assert (tmp_path / "metadata_out_mic000.csv").read_text() == text


def test_generate_signature_matches_reference(scenes, tmp_path):
    """`generate` takes the reference's parameters in the reference's order
    (`video_fname` before `compiled`), accepts `video_fname`, and still
    refuses `video=True`."""
    import inspect

    def params(fn):
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]

    assert params(PortScene.generate) == params(JaxScene.generate)
    got, _ = scenes
    got.generate(tmp_path, False, True, True, "audio_out", "metadata_out", False, "clip")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["metadata_out.json", "metadata_out_mic000.csv"]
    with pytest.raises(NotImplementedError, match="1.8"):
        got.generate(output_dir=tmp_path, audio=False, video=True, video_fname="clip")


def _box_state(faces, **kwargs):
    from audiblelight_tpu_torch.geometry.mesh import TriMesh, box_mesh
    from audiblelight_tpu_torch.worldstate.mesh_backend import WorldStateRLR

    box = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25])
    return WorldStateRLR(TriMesh(box.vertices, box.faces[faces]), seed=1, device="cpu",
                         rlr_kwargs=dict(indirect_ray_count=32, indirect_ray_depth=3, max_ir_length=0.05), **kwargs)


@pytest.mark.parametrize("faces,warns", [(slice(None), False), ([0, 2, 4, 6, 8, 10], True)],
                         ids=["watertight", "leaky"])
def test_simulate_checks_and_ray_efficiency(caplog, faces, warns):
    """`simulate` runs the reference's sanity checks, traces, and sets the
    context's ray efficiency from the mesh's broken faces, warning below
    WARN_WHEN_RAY_EFFICIENCY_BELOW; half a box (every face broken) has
    efficiency 0."""
    ws = _box_state(faces)
    ws.add_microphone(microphone_type="ambeovr", position=[2.0, 1.5, 1.2])
    ws.add_emitter(position=[1.0, 2.0, 1.5])
    with caplog.at_level("WARNING"):
        ws.simulate()
    assert ws.irs["mic000"].shape[:2] == (4, 1)
    want = 1.0 - len(ws.mesh.broken_faces()) / len(ws.mesh.faces)
    assert ws.ctx.get_indirect_ray_efficiency() == pytest.approx(want)
    assert want == (0.0 if warns else 1.0)
    assert ("Ray efficiency is below 50%" in caplog.text) == warns


def test_simulate_empty_scene_asserts():
    ws = _box_state(slice(None))
    with pytest.raises(AssertionError, match="emitters"):
        ws.simulate()
    ws.add_emitter(position=[1.0, 2.0, 1.5])
    with pytest.raises(AssertionError, match="microphones"):
        ws.simulate()
