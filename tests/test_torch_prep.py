"""The pooled SELD driver on the CPU: `prep.py`, `render_scenes_pipelined`
and `seld.generate_pooled`.

`prep_scene` packs the reference's CSV text, scene JSON (but for the
creation time), tracer inputs and per-face rain table for the same placed
scene. A 2-worker `ScenePrepPool` (spawned, the card hidden, builder
`seld.make_pooled_prep`) gives the PreppedScenes of `workers=0`, and its
rain tables equal the main process's. `render_prepped_scenes` gives the payloads
of `render_scenes_pipelined(device_mix=True)` over the same scenes;
`fused_batch=2` over three scenes (a pair and a trailing partial) gives
`fused_batch=1`'s; a scene that overflows the pinned buckets keeps every
event. The CLI's `--placement-workers 2 --fused-batch 2` writes the CSVs of
`--placement-workers 1 --fused-batch 1` byte for byte, its JSONs byte for
byte but for the creation-time line, and its WAVs within 1 LSB (0 workers
is the serial loop, as in the reference script). The multi-device runs
write the same files: `--mesh-devices 2 --device cpu` (two gloo ranks, each
rendering its share of the jobs), also with two prep workers, `--coordinator`
with a world of one, and two ranks resuming a run.
"""

import json
import pickle
import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene as JaxScene
from audiblelight_tpu import utils as jutils
from audiblelight_tpu.prep import prep_scene as jax_prep_scene
from audiblelight_tpu_torch import pipeline, seld
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene
from audiblelight_tpu_torch.geometry.mesh import save_obj, scanned_like_room
from audiblelight_tpu_torch.io.audio import wav_read
from audiblelight_tpu_torch.pipeline import FusedSceneRenderer, render_scenes_pipelined
from audiblelight_tpu_torch.prep import ScenePrepPool, prep_scene, render_prepped_scenes
from audiblelight_tpu_torch.render import build_scene_plan

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = 5


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
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("pooled")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")
    return root


def _argv(root: Path, out: str, *flags) -> list:
    return ["--fg-dir", str(root / "fg"), "--output-dir", str(root / out), "--backend", "rlr",
            "--mesh", str(root / "room.obj"), "--channel-layout", "mic", "--n-scenes", "3", "--train-frac", "0.5",
            "--duration", "4", "--rays", "128", "--ray-depth", "4", "--ir-seconds", "0.1",
            "--max-events-static", "2", "--max-events-moving", "1", "--seed", str(SEED), "--device", "cpu", *flags]


def _jobs():
    return [("train", 1, 0), ("train", 1, 1), ("test", 1, 0)]


def _without_creation_time(text: str) -> str:
    return "".join(line for line in text.splitlines(True) if '"creation_time"' not in line)


def _scene(scene_cls, seed_everything, root, **device):
    seed_everything(7)
    scene = scene_cls(
        duration=8.0, sample_rate=24000, backend="rlr", fg_path=root / "fg", max_overlap=2,
        backend_kwargs=dict(mesh=str(root / "room.obj"), seed=11, add_to_context=False,
                            rlr_kwargs=dict(indirect_ray_count=64, indirect_ray_depth=4, max_ir_length=0.1,
                                            mesh_simplification=True)),
        **device,
    )
    scene.add_microphone(microphone_type="ambeovr")
    for event_type in ("static", "static", "moving"):
        scene.add_event(event_type=event_type, max_place_attempts=100)
    scene.add_ambience(noise="gaussian")
    return scene


def test_prep_scene_matches_reference(assets):
    pk = dict(max_static=2, max_moving=1, max_traj=32, pad_audio_seconds=4.0)
    want = jax_prep_scene(_scene(JaxScene, jutils.seed_everything, assets), 3, pk)
    got = prep_scene(_scene(Scene, tutils.seed_everything, assets, device="cpu"), 3, pk)
    assert got.csv_texts == want.csv_texts
    w, g = json.loads(want.scene_json), json.loads(got.scene_json)
    w.pop("creation_time"), g.pop("creation_time")
    assert g == w
    assert got.index == 3 and got.bucket_sources == want.bucket_sources and got.mic_alias == want.mic_alias
    for a, b in zip(got.inputs[1:], want.inputs[1:]):  # sources, listener points, s_idx, m_idx
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(got.mic_pts, want.mic_pts, atol=1e-6)
    np.testing.assert_array_equal(got.face_occ, np.asarray(want.face_occ))
    assert got.face_occ.any() and not got.face_occ.all()
    assert not any(isinstance(v, torch.Tensor) for v in vars(got).values())
    assert pickle.loads(pickle.dumps(got)).scene_json == got.scene_json


_MESHES: dict = {}


def _scenes(args, tasks):
    """The jobs' scenes built in this process with their own seeds, as the
    workers build them."""
    out = []
    for index, seed in tasks:
        tutils.seed_everything(seed % (2**31))
        out.append(seld.build_scene(args, *_jobs()[index], np.random.default_rng(seed), meshes=_MESHES)[0])
    return out


def _source_bucket(scene) -> int:
    return pipeline._bucket(len(scene.state._emitter_positions()))


@pytest.fixture(scope="module")
def prepped(assets):
    """Three jobs' PreppedScenes inline and from two spawned workers. The
    jobs' seeds are the first from 100 on whose scenes share one source
    bucket, so that they batch together."""
    args = seld.build_parser().parse_args(_argv(assets, "prep"))
    kw = dict(args_dict=vars(args), jobs=_jobs(), plan_kwargs=seld.plan_kwargs(args))
    seeds, bucket = [], None
    for seed in range(100, 200):
        b = _source_bucket(_scenes(args, [(len(seeds), seed)])[0])
        if bucket in (None, b):
            seeds, bucket = seeds + [seed], b
        if len(seeds) == 3:
            break
    tasks = list(enumerate(seeds))
    out = {}
    for workers in (0, 2):
        with ScenePrepPool("audiblelight_tpu_torch.seld:make_pooled_prep", kw, workers=workers) as pool:
            out[workers] = list(pool.imap(tasks))
    return args, tasks, out


def test_pool_workers_give_the_inline_payloads(prepped):
    _, _, out = prepped
    for a, b in zip(out[0], out[2]):
        assert a.index == b.index and a.csv_texts == b.csv_texts and a.mic_alias == b.mic_alias
        assert _without_creation_time(a.scene_json) == _without_creation_time(b.scene_json)
        assert a.inputs[0] == b.inputs[0]
        for x, y in zip(a.inputs[1:], b.inputs[1:]):
            np.testing.assert_array_equal(x, y)
        assert a.plan.keys() == b.plan.keys()
        for k in a.plan:
            np.testing.assert_array_equal(a.plan[k], b.plan[k])
        np.testing.assert_array_equal(a.face_occ, b.face_occ)
        assert a.amb == b.amb and a.bucket_sources == b.bucket_sources


def _pipelined(args, tasks, **kw) -> list:
    wavs = []
    render_scenes_pipelined(_scenes(args, tasks), lambda s, audio: wavs.append(audio["mic000"]),
                            plan_kwargs=seld.plan_kwargs(args), **kw)
    return wavs


def test_render_prepped_scenes_equals_the_pipelined_loop(prepped):
    """The main process's rain table equals the worker's, and the pooled render
    gives the pipelined loop's payloads (within 1 LSB)."""
    args, tasks, out = prepped
    template = _scenes(args, tasks[:1])[0]
    plan = build_scene_plan(template, **seld.plan_kwargs(args))
    renderers = {}

    def renderer_for(bucket):
        return renderers.setdefault(bucket, FusedSceneRenderer.from_scene(template, plan, bucket))

    for p in out[2]:
        table = renderer_for(p.bucket_sources).state.rain_occlusion_for(p.mic_pts).numpy()
        np.testing.assert_array_equal(table, p.face_occ)
    got, stats = {}, {}
    assert render_prepped_scenes(renderer_for, iter(out[2]), lambda p, wav: got.setdefault(p.index, wav),
                                 fused_batch=2, stats=stats) == 3
    assert stats["n_scenes"] == 3 and set(stats) == {"prep_wait_s", "dispatch_s", "pull_s", "complete_s", "n_scenes"}
    want = _pipelined(args, tasks, fused_batch=2, device_mix=True)
    for i, w in enumerate(want):
        assert got[i].dtype == np.int16 and got[i].shape == w.shape
        assert np.abs(got[i].astype(np.int32) - w.astype(np.int32)).max() <= 1
        assert np.abs(w).max() > 100


def test_fused_batch_of_two_equals_one_scene_at_a_time(prepped):
    args, tasks, _ = prepped
    pairs = []
    real = FusedSceneRenderer.render_mix_batch

    def counted(self, inputs, plans, extras):
        pairs.append(len(inputs))
        return real(self, inputs, plans, extras)

    FusedSceneRenderer.render_mix_batch = counted
    try:
        two = _pipelined(args, tasks, fused_batch=2, device_mix=True)
    finally:
        FusedSceneRenderer.render_mix_batch = real
    one = _pipelined(args, tasks, fused_batch=1, device_mix=True)
    assert pairs == [2]  # the pair; the trailing scene renders alone
    for a, b in zip(two, one):
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_bucket_overflow_keeps_every_event(prepped, monkeypatch):
    """A scene with more static events than the pinned bucket renders through
    the plan path with its buckets auto-sized."""
    args, tasks, _ = prepped
    scenes = _scenes(args, tasks)
    n_static = [sum(1 for e in s.events.values() if not e.is_moving) for s in scenes]
    pinned = dict(seld.plan_kwargs(args), max_static=max(n_static) - 1)
    plans = []
    real = pipeline.build_scene_plan

    def kept(scene, **kw):
        plan = real(scene, **kw)
        plans.append((kw.get("plan_path", False), int(plan.static_mask.sum())))
        return plan

    monkeypatch.setattr(pipeline, "build_scene_plan", kept)
    wavs = []
    render_scenes_pipelined(scenes, lambda s, audio: wavs.append(audio["mic000"]), plan_kwargs=pinned,
                            fused_batch=2, device_mix=True)
    assert len(wavs) == 3
    overflowed = [n > pinned["max_static"] for n in n_static]
    assert any(overflowed)
    assert [p for p, _ in plans] == overflowed  # the overflowing scenes take the plan path
    assert [n for _, n in plans] == n_static  # and keep every static event
    assert all(w.dtype == (np.float32 if o else np.int16) for w, o in zip(wavs, overflowed))


def _pooled(assets, name: str, *flags, capfd=None) -> tuple:
    """One pooled CLI run into assets/name: (seconds, stats, its log)."""
    stats: dict = {}
    seconds = seld.main(_argv(assets, name, *flags), stats=stats)
    return seconds, stats, capfd.readouterr().err if capfd is not None else ""


@pytest.fixture(scope="module")
def pooled_w1(assets):
    """The pooled CLI with 1 worker in single renders: what every other
    pooled run of the same jobs is held to."""
    return _pooled(assets, "cli_w1", "--placement-workers", "1", "--fused-batch", "1")


def _same_outputs(assets, a: str, b: str, n_files: int = 9) -> None:
    """Two runs wrote the same files: CSVs byte for byte, JSONs but for the
    creation time, WAVs within 1 LSB and not silent."""
    files = sorted(p.relative_to(assets / a) for p in (assets / a).rglob("*") if p.is_file())
    assert len(files) == n_files
    assert files == sorted(p.relative_to(assets / b) for p in (assets / b).rglob("*") if p.is_file())
    for rel in files:
        x_path, y_path = assets / a / rel, assets / b / rel
        if rel.suffix == ".csv":
            assert x_path.read_bytes() == y_path.read_bytes()
        elif rel.suffix == ".json":
            assert _without_creation_time(x_path.read_text()) == _without_creation_time(y_path.read_text())
        else:
            x, y = wav_read(x_path)[0], wav_read(y_path)[0]
            assert x.shape == (4, 4 * 24000)
            assert np.abs(np.round(x * 32768) - np.round(y * 32768)).max() <= 1 and np.abs(x).max() > 100 / 32768


def test_pooled_cli_output_does_not_depend_on_the_workers(assets, pooled_w1):
    runs = {1: pooled_w1, 2: _pooled(assets, "cli_w2", "--placement-workers", "2", "--fused-batch", "2")}
    for seconds, stats, _ in runs.values():
        assert stats["n_scenes"] == len(seconds) == 3 and stats["world_size"] == 1
        assert set(stats) >= {"prep_wait_s", "dispatch_s", "pull_s", "complete_s", "wall_s", "cpu_count"}
        assert sum(seconds) <= stats["wall_s"]
    _same_outputs(assets, "cli_w1", "cli_w2")


def test_pooled_cli_mesh_devices_matches_one_device(assets, pooled_w1, capfd):
    """`--mesh-devices 2 --device cpu` spawns two gloo ranks (no prep
    workers: 0 split over 2 ranks), each rendering its share of the jobs,
    and writes the 1-worker run's files; the log gives the world's count."""
    seconds, stats, log = _pooled(assets, "cli_mesh2", "--mesh-devices", "2", capfd=capfd)
    assert stats["world_size"] == 2 and stats["n_scenes"] == len(seconds) == 3
    assert "Pooled driver rendered 3 scenes" in log
    _same_outputs(assets, "cli_w1", "cli_mesh2")


def test_pooled_cli_mesh_devices_with_workers(assets, pooled_w1):
    """`--mesh-devices 2 --placement-workers 2` (one prep worker a rank, batches
    of 2) writes the files of `--mesh-devices 1 --placement-workers 1`."""
    seconds, stats, _ = _pooled(assets, "cli_mesh2_w2", "--mesh-devices", "2", "--placement-workers", "2",
                                "--fused-batch", "2")
    assert stats["world_size"] == 2 and len(seconds) == 3
    _same_outputs(assets, "cli_w1", "cli_mesh2_w2")


def test_pooled_cli_coordinator_world_of_one(assets, pooled_w1):
    """`--coordinator host:port --num-processes 1 --process-id 0` joins a
    world of one (gloo on the CPU), writes the run's files without it, and
    leaves the group on its way out."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    seconds, stats, _ = _pooled(assets, "cli_coord", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
                                "--process-id", "0", "--placement-workers", "1", "--fused-batch", "1")
    assert stats["world_size"] == 1 and len(seconds) == 3
    assert not dist.is_initialized()
    _same_outputs(assets, "cli_w1", "cli_coord")


def test_pooled_cli_resume_with_two_ranks(assets, pooled_w1):
    """With the second job's files already written, two ranks render only the
    other two (one each, after the barrier) and leave the written files as
    they were; every job keeps its seed, so the files are the 1-worker run's."""
    import shutil

    out = assets / "cli_resume"
    for src in (assets / "cli_w1").rglob("*fold1_scene1_001*"):
        dst = out / src.relative_to(assets / "cli_w1")
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, dst)
    before = {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()}
    assert len(before) == 3
    seconds, stats, _ = _pooled(assets, "cli_resume", "--mesh-devices", "2")
    assert stats["n_scenes"] == len(seconds) == 2
    assert all(p.stat().st_mtime_ns == t for p, t in before.items())
    _same_outputs(assets, "cli_w1", "cli_resume")
