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

Also here: the import guard (the port and chip_smoke.py import neither JAX
nor the JAX package) and the no-card guard of the entry points.
"""

import ast
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
            assert root not in ("jax", "jaxlib", "audiblelight_tpu"), f"{path}: imports {name}"


def test_entry_points_raise_without_a_card(monkeypatch):
    """Without `device`, an entry point runs on `cuda`; with no card it raises
    instead of running on the CPU."""
    from audiblelight_tpu_torch.geometry.mesh import box_mesh
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer as PortRenderer
    from audiblelight_tpu_torch.worldstate.mesh_backend import MeshDeviceState

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    room = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25])
    caps = np.zeros((4, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortRenderer.from_mesh(room, {}, caps, (1, 1, 2, 100), 2, 1000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshDeviceState.from_mesh(room)
    assert PortRenderer.from_mesh(room, {}, caps, (1, 1, 2, 100), 2, 1000, device="cpu").device.type == "cpu"
