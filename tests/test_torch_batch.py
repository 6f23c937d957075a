"""Batched traces and renders against one scene at a time (CPU).

K3 and K4 take a scene axis: their plain versions on n_scenes = 3 scenes'
bounces equal per-scene calls bit for bit. `trace_rirs_batch` traces B
scenes of one room in one bounce loop, one generator per scene: each
scene's RIRs and generator state equal its one-scene trace bit for bit, in
an open-topped room where one scene's rays all escape at the first bounce
(that scene stops drawing while the others go on). `render_mix_batch` and
`render_batch` of three placed scenes equal `render_mix` and the quantised
stems of each scene (int16 within 1 LSB; the test prints the largest gap).
"""

import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene
from audiblelight_tpu_torch.geometry.mesh import box_mesh, load_mesh, save_obj, scanned_like_room
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.pipeline import FusedSceneRenderer
from audiblelight_tpu_torch.render import build_scene_plan, quantize_stems
from audiblelight_tpu_torch.rir import raytracer as rt
from test_torch_cuda import deposit_inputs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PLAN_KW = dict(max_static=2, max_moving=1, max_traj=32, pad_audio_seconds=4.0)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


@pytest.mark.parametrize("foa", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("dist_max", [30.0, (10.0, 30.0, 100.0)], ids=["spread", "crowded"])
def test_deposit_plain_with_a_scene_axis_equals_per_scene_calls(foa, dist_max):
    """Three scenes' bounces in one call (listener points (3, C, 3)) equal
    three one-scene calls bit for bit."""
    rng = np.random.default_rng(1)
    n_scenes, e, r, c, b, n_bins = 3, 4, 250, 1 if foa else 4, 4, 501
    scenes = [[torch.as_tensor(x) for x in deposit_inputs(rng, e, r, c, b, dist_max)] for _ in range(n_scenes)]
    fn = ck.deposit_histogram_foa if foa else ck.deposit_histogram
    kw = dict(n_bins=n_bins, bin_dt=0.002, c_sound=343.0)
    want = torch.cat([fn(*x, n_sources=e, **kw) for x in scenes])
    hit, normal, e_refl, dist = (torch.cat([x[i] for x in scenes]) for i in range(4))
    occ = torch.cat([x[4] for x in scenes], dim=1)
    lis = torch.stack([x[5] for x in scenes])
    got = fn(hit, normal, e_refl, dist, occ, lis, n_sources=n_scenes * e, **kw)
    assert got.shape == want.shape and torch.count_nonzero(want) > 0
    assert torch.equal(got, want)
    # One scene in the batched form is the one-scene call
    assert torch.equal(fn(*scenes[0][:5], scenes[0][5][None], n_sources=e, **kw), want[:e])


def _open_room():
    """A 6 x 4 x 3 m box without its ceiling: rays escape upward."""
    box = box_mesh(extents=[6.0, 4.0, 3.0], center=[3.0, 2.0, 1.5])
    tris = box.triangles.astype(np.float32)
    return torch.as_tensor(tris[tris[:, :, 2].min(axis=1) < 2.99])


@pytest.mark.parametrize("encoding", ["omni", "foa", "sh3"])
def test_batched_trace_equals_per_scene_traces(encoding):
    tris = _open_room()
    normals = rt.cross3(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    normals = normals / rt.norm3(normals, keepdim=True)
    f = tris.shape[0]
    absorption = torch.full((f, 4), 0.2)
    scattering = torch.full((f,), 0.3)
    # Scene 1's sources sit far outside the room: every ray misses at once
    sources = torch.tensor([[[1.0, 1.0, 1.0], [4.0, 3.0, 2.0]],
                            [[300.0, 300.0, 300.0], [310.0, 290.0, 305.0]],
                            [[5.0, 1.0, 0.5], [2.0, 2.0, 1.0]]])
    caps = 4 if encoding == "omni" else 1
    listeners = torch.as_tensor(np.random.default_rng(0).uniform([1, 1, 0.5], [5, 3, 2], (3, caps, 3)),
                                dtype=torch.float32)
    occ = torch.stack([rt.face_rain_occlusion(tris, normals, lis.mean(dim=0, keepdim=True)) for lis in listeners])
    kw = dict(n_samples=2400, sr=24000, n_rays=64, max_depth=12, tri_normals=normals, diffraction=True,
              encoding=encoding, sh_order_indirect=3 if encoding == "sh3" else 1)
    bounces = []
    bounce = rt._bounce

    def counted(draws, state, *args):
        bounces.append(list(draws.live))
        return bounce(draws, state, *args)

    gens = [torch.Generator().manual_seed(s) for s in (11, 12, 13)]
    want = [rt.trace_rirs_multi(g, tris, absorption, scattering, src, lis, face_occlusion=o, **kw)
            for g, src, lis, o in zip(gens, sources, listeners, occ)]
    states = [g.get_state() for g in gens]
    gens = [torch.Generator().manual_seed(s) for s in (11, 12, 13)]
    rt._bounce = counted
    try:
        got = rt.trace_rirs_batch(gens, tris, absorption, scattering, sources, listeners, face_occlusion=occ, **kw)
    finally:
        rt._bounce = bounce
    # Scene 1 traced its first bounce only; the others went on
    assert bounces[0] == [True, True, True] and all(live == [True, False, True] for live in bounces[1:])
    assert len(bounces) > 2
    for b in range(3):
        assert torch.equal(got[b], want[b]), f"scene {b}"
        assert torch.equal(gens[b].get_state(), states[b]), f"scene {b}'s generator"
    assert torch.count_nonzero(want[0]) > 0 and torch.count_nonzero(want[2]) > 0


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    obj = save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")
    return root / "fg", load_mesh(obj)


def placed_scene(fg, mesh, seed: int, mic: str = "ambeovr") -> Scene:
    """A tiny rlr scene: two static events and one moving, 64 rays x 4
    bounces, 0.1 s IRs, gaussian ambience."""
    tutils.seed_everything(seed)
    scene = Scene(duration=4.0, sample_rate=24000, backend="rlr", fg_path=fg, max_overlap=3, device="cpu",
                  backend_kwargs=dict(mesh=mesh, seed=seed, add_to_context=False,
                                      rlr_kwargs=dict(indirect_ray_count=64, indirect_ray_depth=4,
                                                      max_ir_length=0.1, mesh_simplification=True)))
    scene.add_microphone(microphone_type=mic)
    for event_type in ("static", "static", "moving"):
        scene.add_event(event_type=event_type, max_place_attempts=100)
    scene.add_ambience(noise="gaussian")
    return scene


@pytest.mark.parametrize("mic", ["ambeovr", "foalistener"])
def test_render_mix_batch_equals_render_mix(assets, mic):
    fg, mesh = assets
    scenes = [placed_scene(fg, mesh, s, mic) for s in (1, 2, 3)]
    plans = [build_scene_plan(s, **PLAN_KW) for s in scenes]
    r = FusedSceneRenderer.from_scene(scenes[0], plans[0], 4)
    want = [r.render_mix(*r.scene_inputs(s), p, *r.mix_args(s)) for s, p in zip(scenes, plans)]
    for s in scenes:  # the same trace seeds again
        s.state._trace_count -= 1
    # Host plans and inputs, in one upload
    host = [build_scene_plan(s, device=False, **PLAN_KW) for s in scenes]
    got = r.render_mix_batch([r.scene_inputs(s, device=False) for s in scenes], host,
                             [r.mix_args(s) for s in scenes])
    assert got.shape == (3, *want[0].shape) and got.dtype == torch.int16
    gap = max(int((got[b].int() - want[b].int()).abs().max()) for b in range(3))
    print(f"{mic}: render_mix_batch against render_mix, max {gap} LSB")
    assert gap <= 1
    assert all(int(w.abs().max()) > 100 for w in want)


def test_render_batch_equals_per_scene_stems(assets):
    fg, mesh = assets
    scenes = [placed_scene(fg, mesh, s) for s in (4, 5)]
    plans = [build_scene_plan(s, **PLAN_KW) for s in scenes]
    r = FusedSceneRenderer.from_scene(scenes[0], plans[0], 4)
    want = [quantize_stems(r.stems(*r.scene_inputs(s), p)) for s, p in zip(scenes, plans)]
    for s in scenes:
        s.state._trace_count -= 1
    q, scales = r.render_batch([r.scene_inputs(s, device=False) for s in scenes], plans)
    assert q.shape == (2, *want[0][0].shape) and scales.shape == (2, want[0][1].shape[0])
    for b in range(2):
        assert int((q[b].int() - want[b][0].int()).abs().max()) <= 1
        torch.testing.assert_close(scales[b], want[b][1], rtol=1e-6, atol=0)
