"""The slice as a whole: the JAX FusedSceneRenderer's render_mix against the
port's, on one small ray-traced scene carried across with
`renderer_from_numpy`.

The scene is tests/test_pipeline.py's rlr scene moved into a nonconvex
scanned room (1,728 faces) with per-face rain visibility, diffraction on and
an AmbeoVR rig, with noise bursts for event audio. The traces draw
different random numbers, so the WAVs agree where they are deterministic:
the same shape and dtype, the same direct-path onset sample per event and
capsule, and the same energy within 10 %. Each capsule's tail has its own
noise carrier (diffuse-field decorrelation), which moves the split of that
energy across capsules by ~8 % per render, so each channel is held within
25 %.

A scene with two microphones (an AmbeoVR and a FOA listener, in a shoebox
and in the 432-face scanned room) goes through both packages'
render_scenes_pipelined, which send it to the plan path: the port, given the
reference's IR banks, writes the reference's five files (two WAVs, two CSVs,
the JSON), the CSVs equal, the JSON equal but for the creation time, the
WAVs within 1 LSB; with its own banks it renders both microphones.

Also here: the import guard (the port and chip_smoke.py import neither JAX,
pandas nor the JAX package) and the no-card guard of the entry points
(renderer, device state, Scene and the SELD CLI).
"""

import ast
import json
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene
from audiblelight_tpu.geometry.mesh import scanned_like_room
from audiblelight_tpu.io.audio import wav_read, wav_write
from audiblelight_tpu.pipeline import FusedSceneRenderer
from audiblelight_tpu.render import build_scene_plan
from audiblelight_tpu_torch.geometry.queries import segments_occluded
from audiblelight_tpu_torch.pipeline import renderer_from_numpy, write_wav

torch.set_num_threads(1)

SR = 24000
REPO = Path(__file__).resolve().parents[1]
PLAN_KW = dict(max_static=2, max_moving=1, max_traj=4, pad_audio_seconds=1.5)
AMBIENCE = (1.0, 0.0, -80.0)  # on, white, -80 dB: a bed below the onsets


@pytest.fixture(scope="module")
def fg_dir(tmp_path_factory):
    rng = np.random.default_rng(1)
    root = tmp_path_factory.mktemp("fg")
    for cls in ("maleSpeech", "music"):
        d = root / cls
        d.mkdir()
        t = np.arange(SR * 2) / SR
        sig = 0.3 * rng.standard_normal(len(t)) * np.exp(-t * 0.5)
        wav_write(d / f"{cls}.wav", sig.astype(np.float32), SR)
    return root


@pytest.fixture(scope="module")
def renders(fg_dir):
    scene = Scene(
        duration=4.0, sample_rate=SR, backend="rlr", fg_path=fg_dir, ref_db=-40,
        backend_kwargs=dict(
            mesh=scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=2, seed=0), seed=0,
            rlr_kwargs=dict(indirect_ray_count=512, indirect_ray_depth=8, max_ir_length=0.15,
                            rain_visibility="face", diffraction=True, max_diffraction_order=1),
        ),
    )
    scene.add_microphone(microphone_type="ambeovr", alias="m")
    scene.add_event(
        event_type="static", alias="s0", scene_start=0.5, event_start=0.0, duration=1.0,
        snr=10.0, filepath=fg_dir / "maleSpeech" / "maleSpeech.wav", max_place_attempts=200,
    )
    scene.add_event(
        event_type="moving", alias="m0", shape="linear", scene_start=2.0, event_start=0.0,
        duration=1.0, snr=8.0, spatial_velocity=1.0, spatial_resolution=2.0,
        filepath=fg_dir / "music" / "music.wav", max_place_attempts=200,
    )
    ws = scene.state
    assert not ws.mesh.is_convex and len(ws.mesh.faces) == 1728
    plan = build_scene_plan(scene, trace=False, **PLAN_KW)
    ref = FusedSceneRenderer(scene, plan)
    key, src, caps, face_occ, s_idx, m_idx = ref.scene_inputs(scene, device=False)
    starts = FusedSceneRenderer.mix_args(scene, plan)[0]
    want = np.asarray(ref._render_mix(key, src, caps, face_occ, s_idx, m_idx,
                                      *ref.plan_args(plan), starts, *map(np.float32, AMBIENCE)))

    absorption, scattering, _ = ws.face_props_device
    graph = ws.diffraction_graph_tris
    world = dict(
        tris=ws.mesh.triangles, acoustic_tris=ws.acoustic_mesh.triangles,
        acoustic_normals=ws.acoustic_mesh.face_normals, absorption=np.asarray(absorption),
        scattering=np.asarray(scattering), convex=ws.mesh.is_convex,
        diffraction_graph_tris=None if graph is None else np.asarray(graph),
    )
    fields = {k: (v if k in ("ambience", "n_scene_samples") else np.asarray(v)) for k, v in vars(plan).items()}
    port, inputs = renderer_from_numpy(
        world, ws.cfg.to_dict(), fields, (src, caps, np.asarray(face_occ), s_idx, m_idx),
        ref._t_scene, device="cpu",
    )
    got = port.render_mix(torch.Generator().manual_seed(0), *inputs, *AMBIENCE)
    # (capsule, event start, direct arrival) where the direct path is free:
    # the onset there is deterministic in both packages
    onsets = []
    for start, source in ((plan.static_start[0], s_idx[0]), (plan.moving_start[0], m_idx[0, 0])):
        pos = inputs[0][int(source)]
        blocked = segments_occluded(inputs[1], pos.expand(4, 3), port.state.tris)
        arrival = start + (inputs[1] - pos).norm(dim=1) * SR / 343.0
        onsets += [(ch, int(start), int(arrival[ch])) for ch in range(4) if not blocked[ch]]
    return got, want, onsets


def _onset(x: np.ndarray, start: int, arrival: int) -> int:
    """First sample after the event's start reaching 10 % of the peak of the
    millisecond after the direct arrival, before any reflection. The level
    chain normalises each event by its whole IR, whose tail is random, so
    the threshold is relative."""
    peak = np.abs(x[arrival : arrival + SR // 1000].astype(np.float64)).max()
    return start + int(np.argmax(np.abs(x[start:].astype(np.float64)) >= 0.1 * peak))


def test_render_mix_matches_reference(renders):
    got, want, onsets = renders
    assert got.dtype == torch.int16 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (4, 4 * SR) and want.dtype == np.int16
    assert onsets
    for ch, start, arrival in onsets:
        assert _onset(got[ch], start, arrival) == _onset(want[ch], start, arrival)
    e_got = (got.astype(np.float64) ** 2).sum(-1)
    e_want = (want.astype(np.float64) ** 2).sum(-1)
    assert e_want.min() > 0
    np.testing.assert_allclose(e_got.sum(), e_want.sum(), rtol=0.10)
    np.testing.assert_allclose(e_got, e_want, rtol=0.25)


def test_write_wav_round_trip(renders, tmp_path):
    got, _, _ = renders
    path = write_wav(tmp_path / "scene.wav", got, SR)
    data, sr = wav_read(path)
    assert sr == SR and data.shape == tuple(got.shape)
    np.testing.assert_allclose(data, got.numpy() / 32768.0, atol=1.0 / 32768.0)


def _port_sources():
    return sorted((REPO / "audiblelight_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "pandas", "audiblelight_tpu"), f"{path}: imports {name}"


def test_entry_points_raise_without_a_card(monkeypatch):
    """Without `device`, an entry point runs on `cuda`; with no card it raises
    instead of running on the CPU."""
    from audiblelight_tpu_torch.geometry.mesh import box_mesh
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer as PortRenderer
    from audiblelight_tpu_torch.worldstate.mesh_backend import MeshDeviceState

    from audiblelight_tpu_torch import seld
    from audiblelight_tpu_torch.core import Scene as PortScene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    room = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25])
    caps = np.zeros((4, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortRenderer.from_mesh(room, {}, caps, (1, 1, 2, 100), 2, 1000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshDeviceState.from_mesh(room)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortScene(duration=5.0, backend="rlr", backend_kwargs=dict(mesh=room))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seld.main(["--fg-dir", str(REPO), "--output-dir", str(REPO / "never"), "--backend", "rlr",
                   "--mesh", "room.obj"])
    assert not (REPO / "never").exists()
    assert PortRenderer.from_mesh(room, {}, caps, (1, 1, 2, 100), 2, 1000, device="cpu").device.type == "cpu"
    assert PortScene(duration=5.0, backend="rlr", backend_kwargs=dict(mesh=room), device="cpu").state.device.type == "cpu"


# ---------------------------------------------------------------------------
# A scene with two microphones through the dispatch-ahead loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_mic_assets(tmp_path_factory):
    """The repo's sound events and the 432-face scanned room as an OBJ."""
    import shutil

    from audiblelight_tpu_torch.geometry.mesh import save_obj
    from audiblelight_tpu_torch.geometry.mesh import scanned_like_room as port_room

    root = tmp_path_factory.mktemp("two_mics")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    save_obj(port_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")
    return root


def _two_mic_scene(scene_cls, seed_everything, root, backend: str, **device):
    """An AmbeoVR and a FOA listener, two static events and a moving one."""
    seed_everything(9)
    if backend == "shoebox":
        kw = dict(backend="shoebox", backend_kwargs=dict(dimensions=[6.0, 4.5, 3.0], max_order=2,
                                                         max_ir_length=0.1, seed=3))
    else:
        kw = dict(backend="rlr", backend_kwargs=dict(
            mesh=str(root / "room.obj"), seed=11, add_to_context=False,
            rlr_kwargs=dict(indirect_ray_count=128, indirect_ray_depth=4, max_ir_length=0.1)))
    scene = scene_cls(duration=4.0, sample_rate=SR, fg_path=root / "fg", max_overlap=3, **kw, **device)
    scene.add_microphone(microphone_type="ambeovr")
    scene.add_microphone(microphone_type="foalistener")
    for event_type in ("static", "static", "moving"):
        scene.add_event(event_type=event_type, max_place_attempts=100)
    scene.add_ambience(noise="gaussian")
    return scene


@pytest.fixture(scope="module", params=["shoebox", "rlr"])
def two_mics(request, two_mic_assets, tmp_path_factory):
    """The same two-microphone scene through both packages'
    render_scenes_pipelined (the fused loop, which sends it to the plan
    path), the port given the reference's IR banks; then the port's scene
    again with its own banks. Returns (backend, port folder, reference
    folder, the port's own audio)."""
    import importlib
    import random
    import sys

    from audiblelight_tpu import utils as jutils
    from audiblelight_tpu.pipeline import render_scenes_pipelined as jax_pipelined
    from audiblelight_tpu_torch import utils as tutils
    from audiblelight_tpu_torch.core import Scene as PortScene
    from audiblelight_tpu_torch.core import write_outputs
    from audiblelight_tpu_torch.pipeline import render_scenes_pipelined

    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    sys.path.insert(0, str(REPO / "scripts" / "seld"))
    try:
        sys.modules.pop("generate_dataset", None)  # the other script of that name, if a test loaded it
        gd = importlib.import_module("generate_dataset")
    finally:
        sys.path.remove(str(REPO / "scripts" / "seld"))
    backend, root = request.param, two_mic_assets
    pk = dict(max_static=2, max_moving=1, max_traj=32, pad_audio_seconds=4.0)
    out_w, out_g = tmp_path_factory.mktemp(f"ref_{backend}"), tmp_path_factory.mktemp(f"port_{backend}")
    try:
        want = _two_mic_scene(Scene, jutils.seed_everything, root, backend)
        got = _two_mic_scene(PortScene, tutils.seed_everything, root, backend, device="cpu")

        def complete(write, out):
            def run(scene, audio):
                scene.audio = audio
                write(scene, out / "scene", out / "scene")
            return run

        for seed in (jutils.seed_everything, tutils.seed_everything):
            seed(5)
        # The reference's fused loop refuses a shoebox outright (its plans
        # need a device trace), so its shoebox scenes take fused=False: the
        # plan path, where its fused loop sends a two-microphone rlr scene
        assert jax_pipelined([want], complete(gd.write_outputs, out_w), plan_kwargs=pk, fused=backend == "rlr",
                             device_mix=True, overlap_io=False) == 1  # pandas' writes off a thread
        if backend == "shoebox":
            got.state._irs = OrderedDict((k, np.array(v)) for k, v in want.state.irs.items())
        else:
            banks = OrderedDict((k, torch.from_numpy(np.array(v))) for k, v in want.state.trace_irs_device().items())
            ws = got.state

            def trace_irs_device():  # the reference's banks; a trace refreshes the relative coordinates
                ws._update()
                return banks

            ws.trace_irs_device = trace_irs_device
        for seed in (jutils.seed_everything, tutils.seed_everything):
            seed(5)
        assert render_scenes_pipelined([got], complete(write_outputs, out_g), plan_kwargs=pk, device_mix=True) == 1
        own = _two_mic_scene(PortScene, tutils.seed_everything, root, backend, device="cpu")
        audio = {}
        assert render_scenes_pipelined([own], lambda s, a: audio.update(a), plan_kwargs=pk) == 1
    finally:
        random.setstate(states[0])
        np.random.set_state(states[1])
        torch.random.set_rng_state(states[2])
    return backend, out_g, out_w, audio


def test_two_microphone_scene_writes_the_reference_files(two_mics):
    backend, out_g, out_w, _ = two_mics
    names = ["scene.json", "scene_mic000.csv", "scene_mic000.wav", "scene_mic001.csv", "scene_mic001.wav"]
    assert sorted(p.name for p in out_g.iterdir()) == sorted(p.name for p in out_w.iterdir()) == names
    for mic in ("mic000", "mic001"):
        assert (out_g / f"scene_{mic}.csv").read_text() == (out_w / f"scene_{mic}.csv").read_text()
        w_got, w_want = wav_read(out_g / f"scene_{mic}.wav")[0], wav_read(out_w / f"scene_{mic}.wav")[0]
        assert w_got.shape == w_want.shape == (4, 4 * SR)
        lsb = np.abs(np.round(w_got * 32768).astype(np.int64) - np.round(w_want * 32768).astype(np.int64)).max()
        assert lsb <= 1 and np.abs(w_got).max() > 100 / 32768, (backend, mic, lsb)
    got_json, want_json = (json.loads((d / "scene.json").read_text()) for d in (out_g, out_w))
    got_json.pop("creation_time"), want_json.pop("creation_time")
    assert got_json == want_json


def test_two_microphone_scene_with_the_ports_own_banks(two_mics):
    """The port's own trace (or image sources) of the scene, one per
    microphone, renders both microphones' float32 mixes with sound."""
    _, _, _, audio = two_mics
    assert list(audio) == ["mic000", "mic001"]
    for mix in audio.values():
        assert mix.dtype == np.float32 and mix.shape == (4, 4 * SR) and np.abs(mix).max() > 1e-3
