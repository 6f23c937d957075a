"""Multi-device rendering: the port's `render_scene_arrays` and `parallel`
package against the JAX package's, on the CPU.

The plans are the JAX package's (shoebox scenes as tests/test_render_parallel.py
builds them, smaller), carried across as numpy. In one process: the whole-
scene render, `pad_plans`, `bucket_plans`, `stack_plans` and `render_batch`
within 1e-5 of the reference's peak (max-abs, relative); the pads bit for bit.

The sharded functions run in a 2-rank gloo group of CPU processes
(tests/torch_parallel_worker.py, spawned with a timeout; the group's own
timeout fails a rank that waits for a lost peer): `shard_render` gathered
over a (2, 1) and a (1, 2) mesh equals `render_batch` bit for bit and the
JAX `shard_render` over a 2-device mesh (conftest gives JAX 8 virtual CPU
devices) within 1e-5, also normalised by the global peak and on a ragged
pair; `shard_convolve_time` equals the port's `fft_convolve` and the JAX
function within 1e-5 of peak; each rank's `shard_trace_rirs` shard equals
`trace_rirs_multi` of its slice with its `shard_generator` bit for bit, and
the gathered IRs are held to the JAX function statistically (the two draw
different random numbers: the total energy and the summed tails' T30 within
5 %, each source's energy within 25 %); the fused renderer's sharded methods give the unsharded
renders' rows of this process (within 1 LSB); `init_distributed` twice is a
no-op and every size check raises the reference's error.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene
from audiblelight_tpu import parallel as jpar
from audiblelight_tpu import render as jrender
from audiblelight_tpu.io.audio import wav_write
from audiblelight_tpu_torch import parallel as par
from audiblelight_tpu_torch import render as trender

torch.set_num_threads(1)

SR = 44100
REPO = Path(__file__).resolve().parents[1]
N_PLANS = 4
TRACE_KW = dict(n_samples=2400, sr=24000, n_rays=4096, max_depth=20, occlusion=False)
N_SOURCES = 16


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def fg_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("fg")
    for cls, freq in [("maleSpeech", 220.0), ("music", 660.0)]:
        d = root / cls
        d.mkdir()
        t = np.arange(SR * 2) / SR
        sig = 0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-t * 0.5)
        wav_write(d / f"{cls}.wav", sig.astype(np.float32), SR)
    return root


def make_scene(fg_dir, seed=0, duration=4.0, moving=True):
    scene = Scene(
        duration=duration, backend="shoebox", fg_path=fg_dir,
        backend_kwargs=dict(dimensions=[6.0, 4.0, 3.0], max_order=2, max_ir_length=0.1, frequency_bands=1,
                            seed=seed),
    )
    scene.add_microphone(microphone_type="ambeovr", position=[3.0, 2.0, 1.5], alias="m")
    scene.add_event(event_type="static", position=[1.0 + 0.3 * seed, 1.0, 1.0], alias="s0",
                    scene_start=0.5, event_start=0.0, duration=1.0, snr=10.0)
    if moving:
        scene.add_event(event_type="moving", alias="m0", shape="linear", scene_start=2.0, event_start=0.0,
                        duration=1.5, snr=8.0, spatial_velocity=1.0, spatial_resolution=2.0)
    scene.add_ambience(noise="pink")
    return scene


def _numpy(plan) -> dict:
    return {k: (v if k == "n_scene_samples" else np.asarray(v)) for k, v in vars(plan).items()}


def _port(plan_np: dict) -> trender.ScenePlan:
    return trender.ScenePlan.from_numpy(plan_np, "cpu")


@pytest.fixture(scope="module")
def plans(fg_dir):
    """N_PLANS JAX plans of one bucket shape, as numpy."""
    kw = dict(max_static=2, max_moving=2, max_traj=8, pad_audio_seconds=2.0)
    return [_numpy(jrender.build_scene_plan(make_scene(fg_dir, seed=i), **kw)) for i in range(N_PLANS)]


@pytest.fixture(scope="module")
def ragged(fg_dir):
    """Two JAX plans of different event counts, audio lengths and durations."""
    scene_b = make_scene(fg_dir, seed=3, duration=3.0, moving=False)
    scene_b.add_event(event_type="static", position=[4.5, 3.0, 1.2], alias="s1", scene_start=1.5,
                      event_start=0.0, duration=0.5, snr=6.0)
    return [_numpy(jrender.build_scene_plan(make_scene(fg_dir, seed=0))), _numpy(jrender.build_scene_plan(scene_b))]


def _jax_batched(plans_np: list, pad: bool = False) -> dict:
    return jpar.stack_plans([jrender.ScenePlan(**p) for p in plans_np], pad=pad)


@pytest.mark.parametrize("index", [0, 1])
def test_render_scene_plan_matches_reference(plans, index):
    want = np.asarray(jrender.render_scene_plan(jrender.ScenePlan(**plans[index])))
    got = trender.render_scene_plan(_port(plans[index])).numpy()
    assert got.dtype == np.float32 and np.abs(want).max() > 0
    _close(got, want)


def test_render_scene_arrays_without_moving_events_or_bed(ragged):
    """A plan without moving events (the JAX `build_scene_plan` pads one empty slot),
    and the same plan with no ambience bed: the mix without it."""
    p = ragged[1]
    want = np.asarray(jrender.render_scene_plan(jrender.ScenePlan(**p)))
    got = trender.render_scene_plan(_port(p)).numpy()
    _close(got, want)
    dry = trender.render_scene_arrays(*(getattr(_port(dict(p, ambience=None)), f) for f in par._PLAN_FIELDS),
                                      n_scene_samples=p["n_scene_samples"]).numpy()
    _close(dry + p["ambience"], want)


def test_stack_plans_and_render_batch_match_reference(plans):
    batched = par.stack_plans([_port(p) for p in plans])
    want_b = _jax_batched(plans)
    for f in par._PLAN_FIELDS:
        np.testing.assert_array_equal(batched[f].numpy(), np.asarray(want_b[f]))
    got = par.render_batch(batched).numpy()
    want = np.asarray(jpar.render_batch(want_b))
    assert got.shape == (N_PLANS, 4, 4 * SR)
    _close(got, want)
    for i, p in enumerate(plans):  # a scene's bits do not depend on its batch
        np.testing.assert_array_equal(got[i], trender.render_scene_plan(_port(p)).numpy())


def test_pad_plans_match_reference(ragged):
    want = jpar.pad_plans([jrender.ScenePlan(**p) for p in ragged])
    got = par.pad_plans([_port(p) for p in ragged])
    for w, g in zip(want, got):
        assert g.n_scene_samples == w.n_scene_samples
        for f in par._PLAN_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(g, f)), np.asarray(getattr(w, f)), err_msg=f)
    with pytest.raises(ValueError, match="pad=True"):
        par.stack_plans([_port(p) for p in ragged])
    out = par.render_batch(par.stack_plans([_port(p) for p in ragged], pad=True)).numpy()
    _close(out, np.asarray(jpar.render_batch(_jax_batched(ragged, pad=True))))
    for i, p in enumerate(ragged):  # each padded render is the unpadded one, then silence
        t = p["n_scene_samples"]
        _close(out[i, :, :t], trender.render_scene_plan(_port(p)).numpy())
        assert np.abs(out[i, :, t:]).max(initial=0.0) == 0.0


def test_pad_plans_rejects_mismatched_channels(plans):
    import dataclasses

    plan_a = _port(plans[0])
    plan_bad = dataclasses.replace(plan_a, static_irs=plan_a.static_irs[:, :2], moving_irs=plan_a.moving_irs[:, :2],
                                   ambience=plan_a.ambience[:2])
    with pytest.raises(ValueError, match="channel"):
        par.pad_plans([plan_a, plan_bad])


def test_bucket_plans_bounds_padding_overhead(fg_dir):
    """Mixed 4 / 8 / 24 s scenes bucket as the reference buckets them, with the
    padded volume within 30 % of the true volume per bucket; each bucket
    renders, padded, to each scene's own render."""
    durations = [4.0, 4.0, 8.0, 8.0, 24.0, 24.0]
    kw = dict(max_static=2, max_moving=2, max_traj=8, pad_audio_seconds=2.0)
    plans_np = [_numpy(jrender.build_scene_plan(make_scene(fg_dir, seed=i, duration=d), **kw))
                for i, d in enumerate(durations)]
    plans = [_port(p) for p in plans_np]
    buckets = par.bucket_plans(plans, max_overhead=0.3)
    assert buckets == jpar.bucket_plans([jrender.ScenePlan(**p) for p in plans_np], max_overhead=0.3)
    assert len(buckets) >= 2
    assert sorted(i for b in buckets for i in b) == list(range(len(plans)))

    def cost(p):
        s = max(p.static_audio.shape[1], p.moving_audio.shape[1])
        return float(p.n_scene_samples + (p.static_audio.shape[0] + p.moving_audio.shape[0]) * s)

    for b in buckets:
        assert max(cost(plans[i]) for i in b) * len(b) <= 1.3 * sum(cost(plans[i]) for i in b) + 1e-6
        out = par.render_batch(par.stack_plans([plans[i] for i in b], pad=True)).numpy()
        for row, i in enumerate(b):
            t = plans[i].n_scene_samples
            np.testing.assert_array_equal(out[row, :, :t], trender.render_scene_plan(plans[i]).numpy())


# ---------------------------------------------------------------------------
# The 2-rank gloo group
# ---------------------------------------------------------------------------


def _trace_inputs() -> dict:
    from audiblelight_tpu.geometry import box_mesh

    room = box_mesh(extents=[6, 4, 3], center=[3, 2, 1.5])
    rng = np.random.default_rng(0)
    return dict(tris=room.triangles.astype(np.float32), absorption=np.full((12, 2), 0.3, np.float32),
                scattering=np.full((12,), 0.2, np.float32),
                sources=rng.uniform(0.5, [5.5, 3.5, 2.5], (N_SOURCES, 3)).astype(np.float32),
                listener=np.array([[3.0, 2.0, 1.5]], np.float32))


def _fused_job(root: Path) -> dict:
    """Three pooled-driver jobs in a 432-face room, two static events each
    (so that every scene has one source bucket)."""
    import shutil

    from audiblelight_tpu_torch.geometry.mesh import save_obj, scanned_like_room

    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")
    argv = ["--fg-dir", str(root / "fg"), "--output-dir", str(root / "out"), "--backend", "rlr",
            "--mesh", str(root / "room.obj"), "--duration", "4", "--rays", "64", "--ray-depth", "4",
            "--ir-seconds", "0.1", "--min-events-static", "2", "--max-events-static", "2",
            "--min-events-moving", "0", "--max-events-moving", "0", "--device", "cpu"]
    return dict(argv=argv, jobs=[["train", 1, i] for i in range(3)], seeds=[101, 102, 103])


@pytest.fixture(scope="module")
def group(tmp_path_factory, plans, ragged):
    """Both ranks' outputs: ({rank: arrays}, {rank: checks}, the inputs, the fused job)."""
    folder = tmp_path_factory.mktemp("group")
    arrays = {"n_plans": np.int64(len(plans)), "audio": np.random.default_rng(0).standard_normal(4 * 2048)
              .astype(np.float32), "irs": (0.1 * np.random.default_rng(1).standard_normal((4, 513))).astype(np.float32),
              "trace_seed": np.int64(7), "trace_kwargs": json.dumps(TRACE_KW), **_trace_inputs()}
    for prefix, group_plans in (("plan", plans), ("ragged", ragged)):
        for i, p in enumerate(group_plans):
            arrays.update({f"{prefix}{i}_{k}": np.asarray(v) for k, v in p.items()})
    np.savez(folder / "inputs.npz", **arrays)
    job = _fused_job(folder)
    (folder / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    init = (folder / "rendezvous").as_uri()
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests/torch_parallel_worker.py"), str(r), "2", init,
                               str(folder)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    out = {r: dict(np.load(folder / f"rank{r}.npz")) for r in range(2)}
    checks = {r: json.loads((folder / f"rank{r}.json").read_text()) for r in range(2)}
    return out, checks, arrays, job


def _gathered(out: dict, key: str) -> np.ndarray:
    return np.concatenate([out[0][key], out[1][key]])


def test_init_distributed_twice_and_mesh_size(group):
    _, checks, _, _ = group
    for r in range(2):
        assert checks[r]["init_twice"] and checks[r]["backend"] == "gloo"
        assert checks[r]["bad_mesh"] == "a (3, 1) mesh needs 3 ranks; the world has 2"


def test_shard_render_equals_render_batch_and_reference(group, plans):
    out, checks, _, _ = group
    local = par.render_batch(par.stack_plans([_port(p) for p in plans])).numpy()
    for key in ("render", "render_chan"):  # (2, 1) and (1, 2) meshes
        assert out[0][key].shape == (N_PLANS // 2, 4, 4 * SR)
        np.testing.assert_array_equal(_gathered(out, key), local)
    mesh = jpar.make_mesh(n_scene=2, n_chan=1, devices=jax.devices()[:2])
    _close(_gathered(out, "render"), np.asarray(jpar.shard_render(_jax_batched(plans), mesh)))
    for r in range(2):
        assert checks[r]["render_divisible"] == "Batch size 1 must be divisible by mesh size 2"


def test_shard_render_normalize_divides_by_the_global_peak(group, plans):
    out, _, _, _ = group
    got = _gathered(out, "render_norm")
    local = par.render_batch(par.stack_plans([_port(p) for p in plans])).numpy()
    np.testing.assert_array_equal(got, local / np.abs(local).max())
    assert abs(np.abs(got).max() - 1.0) < 1e-6
    assert np.abs(out[0]["render_norm"]).max() != np.abs(out[1]["render_norm"]).max()  # one global peak
    mesh = jpar.make_mesh(n_scene=2, n_chan=1, devices=jax.devices()[:2])
    _close(got, np.asarray(jpar.shard_render(_jax_batched(plans), mesh, normalize=True)))


def test_shard_render_ragged_pair(group, ragged):
    out, _, _, _ = group
    want = par.render_batch(par.stack_plans([_port(p) for p in ragged], pad=True)).numpy()
    np.testing.assert_array_equal(_gathered(out, "ragged"), want)


def test_shard_convolve_time_matches_unsharded(group):
    from audiblelight_tpu.ops.convolve import fft_convolve as j_fft_convolve
    from audiblelight_tpu_torch.ops.convolve import fft_convolve

    out, _, arrays, _ = group
    audio, irs = arrays["audio"], arrays["irs"]
    want = fft_convolve(torch.from_numpy(audio), torch.from_numpy(irs)).numpy()
    for r in range(2):  # every rank returns the whole result
        assert out[r]["conv"].shape == (4, len(audio) + irs.shape[-1] - 1)
        _close(out[r]["conv"], want)
    np.testing.assert_array_equal(out[0]["conv"], out[1]["conv"])
    mesh = jpar.make_mesh(n_scene=2, n_chan=1, devices=jax.devices()[:2])
    _close(out[0]["conv"], np.asarray(jpar.shard_convolve_time(audio, irs, mesh)))
    _close(out[0]["conv"], np.asarray(j_fft_convolve(audio, irs)))


def test_shard_convolve_time_validates_halo(group):
    _, checks, _, _ = group
    for r in range(2):
        assert checks[r]["conv_halo"] == ("time blocks of 64 samples are shorter than the 255-sample halo; "
                                          "use fewer devices or longer audio")
        assert checks[r]["conv_divide"] == "n_samples 129 must divide the 'scene' axis size 2"


def test_shard_trace_rirs_equals_unsharded_slices(group):
    """Each rank's shard is trace_rirs_multi of its half of the sources with
    its shard generator, bit for bit."""
    from audiblelight_tpu_torch.rir.raytracer import trace_rirs_multi

    out, checks, arrays, _ = group
    geo = [torch.from_numpy(arrays[k]) for k in ("tris", "absorption", "scattering")]
    half = N_SOURCES // 2
    for r in range(2):
        gen = par.shard_generator(7, r, "cpu")
        want = trace_rirs_multi(gen, *geo, torch.from_numpy(arrays["sources"][half * r : half * (r + 1)]),
                                torch.from_numpy(arrays["listener"]), **TRACE_KW).numpy()
        assert out[r]["trace"].shape == (1, half, TRACE_KW["n_samples"])
        np.testing.assert_array_equal(out[r]["trace"], want)
        assert checks[r]["trace_divisible"] == "Source count 3 must be divisible by mesh 'scene' size 2"
    assert par.shard_generator(7, 0, "cpu").initial_seed() != par.shard_generator(7, 1, "cpu").initial_seed()
    gen = torch.Generator().manual_seed(7)
    assert par.shard_generator(gen, 1, "cpu").initial_seed() == par.shard_generator(7, 1, "cpu").initial_seed()


def _tail_t30(irs: np.ndarray, sr: int, bin_s: float = 0.002) -> float:
    """T30 (s) of the sources' summed tails: each IR's energy in 2 ms bins
    from two bins after its direct-path peak, summed over the sources, its
    Schroeder integral's -5 to -35 dB slope extrapolated to 60 dB."""
    n = int(bin_s * sr)
    e = (irs[:, : irs.shape[1] // n * n].astype(np.float64) ** 2).reshape(len(irs), -1, n).sum(-1)
    for row in e:
        row[: int(np.argmax(row)) + 2] = 0.0
    tail = e.sum(0)
    tail = tail[np.flatnonzero(tail)[0] :]
    sch = np.cumsum(tail[::-1])[::-1]
    db = 10 * np.log10(np.maximum(sch / sch[0], 1e-30))
    sel = (db <= -5) & (db >= -35)
    return -60.0 / np.polyfit(np.arange(len(db))[sel] * bin_s, db[sel], 1)[0]


def test_shard_trace_rirs_statistics_match_reference(group):
    """The gathered IRs against the JAX shard_trace_rirs over a 2-device mesh
    (its own threefry streams): the sources' total energy and the T30 of
    their summed tails within 5 %, each source's energy within 25 %. The
    bounds cover the JAX function against itself at other keys: one 0.1 s
    IR's noise carriers move its energy by ~10 % whatever the ray count,
    so only the sums over 16 sources are held tightly."""
    out, _, arrays, _ = group
    mesh = jpar.make_mesh(n_scene=2, n_chan=1, devices=jax.devices()[:2])
    want = np.asarray(jpar.shard_trace_rirs(
        mesh, jax.random.PRNGKey(7), *(arrays[k] for k in ("tris", "absorption", "scattering", "sources", "listener")),
        **TRACE_KW))[0]
    got = np.concatenate([out[0]["trace"][0], out[1]["trace"][0]])
    assert got.shape == want.shape == (N_SOURCES, TRACE_KW["n_samples"])
    assert np.isfinite(got).all()
    e_got, e_want = (got.astype(np.float64) ** 2).sum(-1), (want.astype(np.float64) ** 2).sum(-1)
    assert abs(e_got.sum() / e_want.sum() - 1) < 0.05
    np.testing.assert_allclose(e_got, e_want, rtol=0.25)
    t_got, t_want = _tail_t30(got, TRACE_KW["sr"]), _tail_t30(want, TRACE_KW["sr"])
    assert abs(t_got / t_want - 1) < 0.05, (t_got, t_want)


def test_fused_renderer_sharded_methods(group):
    """render_mix_batch_sharded and render_batch_sharded give each rank its
    row of the unsharded batch rendered in this process (the same seeds)."""
    from audiblelight_tpu_torch import seld, utils
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer
    from audiblelight_tpu_torch.render import build_scene_plan

    out, checks, _, job = group
    args = seld.build_parser().parse_args(job["argv"])
    jobs = [tuple(j) for j in job["jobs"]]
    pk = seld.plan_kwargs(args)
    prep = seld.make_pooled_prep(vars(args), jobs, pk)
    prepped = [prep(i, seed) for i, seed in enumerate(job["seeds"])]
    utils.seed_everything(job["seeds"][0] % (2**31))
    template = seld.build_scene(args, *jobs[0], np.random.default_rng(job["seeds"][0]))[0]
    r = FusedSceneRenderer.from_scene(template, build_scene_plan(template, **pk), prepped[0].bucket_sources)
    inputs = [(p.inputs[0], p.inputs[1], p.inputs[2], p.face_occ, p.inputs[3], p.inputs[4]) for p in prepped]
    mix = r.render_mix_batch(inputs[:2], [p.plan for p in prepped[:2]], [p.amb for p in prepped[:2]]).numpy()
    q, scales = (x.numpy() for x in r.render_batch(inputs[:2], [p.plan for p in prepped[:2]]))
    assert np.abs(mix).max() > 100
    one = r.render_mix_batch(inputs[2:], [prepped[2].plan], [prepped[2].amb]).numpy()[0]
    for rank in range(2):
        assert out[rank]["mix_sharded"].shape == (1, *mix.shape[1:])
        assert np.abs(out[rank]["mix_sharded"][0].astype(np.int32) - mix[rank]).max() <= 1
        assert np.abs(out[rank]["stems_sharded"][0].astype(np.int32) - q[rank]).max() <= 1
        np.testing.assert_allclose(out[rank]["scales_sharded"][0], scales[rank], rtol=1e-5)
        assert checks[rank]["mix_sharded"] == "batch size 1 must divide by mesh 'scene' size 2"
        assert checks[rank]["stems_sharded"] == checks[rank]["mix_sharded"]
        # render_prepped_scenes with the mesh: each rank completes its slice of
        # the pair and the whole trailing group
        assert sorted(k for k in out[rank] if k.startswith("prepped_")) == [f"prepped_{rank}", "prepped_2"]
        assert np.abs(out[rank][f"prepped_{rank}"].astype(np.int32) - mix[rank]).max() <= 1
        assert np.abs(out[rank]["prepped_2"].astype(np.int32) - one).max() <= 1
