"""The port's spans and counters (profiling.annotate, count, recorded) and
the spans of the dispatch-ahead loop's plan path.

A span records only while a torch.profiler session is active in the
process; off, it is one flag check. On the CPU: the span tree, the scene
ids, the per-thread stacks and self times; the loop's span tree a scene and
its `host_syncs`, with the audio equal to the untraced run's. The tests
marked `cuda` hold the span's clock against the device trace's and the
engine's marker pair a call; this file imports neither JAX nor the JAX
package, so on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -m cuda
"""

import threading
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiblelight_tpu_torch import profiling
from audiblelight_tpu_torch.profiling import annotate, count, recorded

REPO = Path(__file__).resolve().parents[1]
SR = 16000
# The waits for the device a scene of the tiny cell (one block of images):
# the plan's 14 uploads (every field with elements but the IR placeholders),
# the world state's 5 (absorption, sources, room, listener, bands), the
# engine's 3 (its image grid, its lowest band) and the FOA channel order's
# one a block; and the host mix's 3 reads
DISPATCH_SYNCS, COMPLETE_SYNCS = 14 + 5 + 3 + 1, 3
PLAN_KW = dict(max_static=2, max_moving=1, max_traj=4, pad_audio_seconds=1.0)
# Each scene's spans on the loop's plan path: name -> its parent's name
TREE = {
    "loop.dispatch": None, "plan.build": "loop.dispatch", "engine.ism": "plan.build", "plan.audio": "plan.build",
    "plan.bed": "plan.build", "plan.upload": "plan.build", "plan.gather": "plan.build",
    "stems.dispatch": "loop.dispatch", "loop.put": "loop.dispatch",
    "loop.complete": None, "complete.pull": "loop.complete", "complete.mix": "loop.complete",
    "complete.user": "loop.complete",
}


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.clear_recorded()
    yield
    profiling.clear_recorded()


def _traced():
    return profile(activities=[ProfilerActivity.CPU])


def test_a_span_off_does_nothing_beyond_the_check(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a span off reached past its check")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(profiling, "_OpenSpan", boom)
    monkeypatch.setattr(profiling, "_keep", boom)
    assert not profiling._tracing()
    with annotate("off", scene=3):
        with annotate("off.child"):
            count("host_syncs")
    rec = recorded()
    assert rec.spans == [] and rec.counts == [] and rec.dropped == 0


def test_spans_nest_per_thread_with_scene_ids_and_self_times():
    ready = threading.Barrier(2, timeout=30)

    def work(scene):
        with annotate("root", scene=scene):
            ready.wait()  # both threads hold a span open at once
            with annotate("child"):
                with annotate("grandchild"):
                    sum(range(1000))
            with annotate("child", scene=scene + 100):
                ready.wait()

    with _traced():
        other = threading.Thread(target=work, args=(2,))
        other.start()
        work(1)
        other.join(timeout=30)
    assert not other.is_alive()
    rec = recorded()
    assert len(rec.spans) == 8
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name == "root":
            assert s.parent is None
            continue
        parent = by_id[s.parent]
        assert parent.thread == s.thread and parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert parent.name == {"child": "root", "grandchild": "child"}[s.name]
    roots = {s.scene: s for s in rec.spans if s.name == "root"}
    assert set(roots) == {1, 2} and roots[1].thread != roots[2].thread
    for s in rec.spans:
        root = next(r for r in roots.values() if r.thread == s.thread)
        explicit = s.name == "child" and s.start_ns != min(c.start_ns for c in rec.spans
                                                            if c.name == "child" and c.thread == s.thread)
        assert s.scene == (root.scene + 100 if explicit else root.scene)
    own = profiling.self_ns(rec.spans)
    for s in rec.spans:
        kids = sum(c.end_ns - c.start_ns for c in rec.spans if c.parent == s.id)
        assert own[s.id] == s.end_ns - s.start_ns - kids >= 0


def test_a_scene_id_crosses_to_the_completion_thread():
    from audiblelight_tpu_torch.prep import CompletionThread

    def finish(ordinal):
        with annotate("loop.complete", ordinal):
            with annotate("complete.user"):
                count("host_syncs", 2)

    with _traced():
        with CompletionThread(finish, 2) as completion:
            for ordinal in range(3):
                with annotate("loop.dispatch", ordinal):
                    completion.put(ordinal)
            completion.join()
    rec = recorded()
    main = threading.get_ident()
    for name, on_main in (("loop.dispatch", True), ("loop.complete", False), ("complete.user", False)):
        spans = [s for s in rec.spans if s.name == name]
        assert sorted(s.scene for s in spans) == [0, 1, 2]
        assert all((s.thread == main) == on_main for s in spans)
    assert sorted((c.scene, c.n) for c in rec.counts) == [(0, 2), (1, 2), (2, 2)]
    assert all(c.thread != main for c in rec.counts) and rec.total("host_syncs") == 6


def test_count_follows_the_spans_rule():
    count("host_syncs", 5)
    assert recorded().counts == []
    with _traced():
        count("host_syncs", 2)
        with annotate("outer", scene=7):
            count("host_syncs")
            count("host_syncs", 4, scene=9)
    count("host_syncs", 5)
    rec = recorded()
    assert [(c.name, c.scene, c.n) for c in rec.counts] == [("host_syncs", None, 2), ("host_syncs", 7, 1),
                                                           ("host_syncs", 9, 4)]
    assert rec.total("host_syncs") == 7 and rec.total("other") == 0


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with _traced():
        for _ in range(5):
            with annotate("s"):
                pass
    rec = recorded()
    assert len(rec.spans) == 3 and rec.dropped == 2


def test_annotate_pushes_no_nvtx(monkeypatch):
    pushed = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: pushed.append(name))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: pushed.append(None))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with annotate("off"):
        pass
    with _traced():
        with annotate("on"):
            pass
    assert pushed == [] and [s.name for s in recorded().spans] == ["on"]


# --------------------------------------------------------------------------
# The dispatch-ahead loop's plan path
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A one-second mono clip (a decaying tone with a little noise)."""
    from audiblelight_tpu_torch.io.audio import wav_write

    t = np.arange(SR) / SR
    rng = np.random.default_rng(5)
    audio = (0.5 * np.sin(2 * np.pi * 440 * t) * np.exp(-2 * t) + 0.01 * rng.standard_normal(SR)).astype(np.float32)
    path = tmp_path_factory.mktemp("spans") / "clip.wav"
    wav_write(path, audio, SR)
    return str(path)


def _scene(clip, i):
    """A tiny FOA shoebox scene: two static events and a moving one, a gaussian bed."""
    from audiblelight_tpu_torch.core import Scene

    scene = Scene(duration=2.0, sample_rate=SR, backend="shoebox", max_overlap=3, ref_db=-50, device="cpu",
                  backend_kwargs=dict(dimensions=[5.0 + 0.1 * i, 4.0, 3.0], absorption=0.3, max_order=1,
                                      max_ir_length=0.05, seed=3 + i))
    scene.add_microphone(microphone_type="foalistener", position=[2.5, 2.0, 1.5])
    for k, (pos, start) in enumerate((([1.0, 1.0, 1.2], 0.0), ([4.0, 3.0, 1.8], 0.5))):
        scene.add_event(event_type="static", filepath=clip, position=pos, scene_start=start, event_start=0.0,
                        duration=1.0, snr=20.0 + k, class_id=k)
    trajectory = np.stack([np.linspace(1.0, 2.0, 3), np.full(3, 3.2), np.full(3, 1.5)], axis=1)
    scene.add_event(event_type="predefined", filepath=clip, trajectory=trajectory, scene_start=0.8,
                    event_start=0.0, duration=1.0, snr=25.0, class_id=2)
    scene.add_ambience(noise="gaussian")
    return scene


def _loop(clip, n, traced):
    """n scenes through the loop's plan path; their audio in order."""
    from audiblelight_tpu_torch.pipeline import render_scenes_pipelined

    def factory():
        for i in range(n):
            scene = _scene(clip, i)
            np.random.seed(40 + i)  # the bed's draw, as the CLI seeds each scene
            yield scene

    out = []
    kw = dict(max_in_flight=2, plan_kwargs=PLAN_KW)
    if traced:
        with _traced():
            render_scenes_pipelined(factory(), lambda scene, audio: out.append(next(iter(audio.values()))), **kw)
    else:
        render_scenes_pipelined(factory(), lambda scene, audio: out.append(next(iter(audio.values()))), **kw)
    return out


@pytest.fixture(scope="module")
def loop_runs(clip):
    """(untraced audio, traced audio, the traced run's recording)."""
    state = np.random.get_state()
    try:
        profiling.clear_recorded()
        plain = _loop(clip, 3, traced=False)
        assert recorded().spans == []
        traced = _loop(clip, 3, traced=True)
        return plain, traced, recorded()
    finally:
        np.random.set_state(state)
        profiling.clear_recorded()


def test_the_loop_gives_every_scene_the_span_tree_and_the_same_audio(loop_runs):
    plain, traced, rec = loop_runs
    assert len(plain) == len(traced) == 3
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    by_id = {s.id: s for s in rec.spans}
    per_scene = defaultdict(lambda: defaultdict(list))
    for s in rec.spans:
        per_scene[s.scene][s.name].append(s)
    assert sorted(per_scene) == [0, 1, 2]
    threads = {name: {s.thread for s in rec.spans if s.name == name} for name in TREE}
    assert len(threads["loop.dispatch"] | threads["loop.complete"]) == 2
    for scene, names in per_scene.items():
        assert {k: len(v) for k, v in names.items()} == {name: 1 for name in TREE}
        for name, parent in TREE.items():
            span = names[name][0]
            if parent is None:
                assert span.parent is None
            else:
                assert by_id[span.parent].name == parent and by_id[span.parent].scene == scene
            root = "loop.dispatch" if name in ("loop.dispatch", "loop.put") or name.split(".")[0] in (
                "plan", "engine", "stems") else "loop.complete"
            assert span.thread in threads[root] and len(threads[root]) == 1


def test_the_loop_counts_its_host_syncs(loop_runs):
    _, _, rec = loop_runs
    by_scene = defaultdict(lambda: defaultdict(int))
    for c in rec.counts:
        assert c.name == "host_syncs"
        by_scene[c.scene][c.thread] += c.n
    for scene in range(3):
        dispatch, complete = sorted(by_scene[scene].values(), reverse=True)
        assert (dispatch, complete) == (DISPATCH_SYNCS, COMPLETE_SYNCS)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


# The kernel of a span's markers (`torch.cuda._sleep(0)`) and of the test's
# own sleeps
MARKER = "spin_kernel"
# How far a device event's start may read before the host stamp that
# preceded its launch: the device trace's clock is the host's, mapped by
# CUPTI (an H100 read a kernel up to 26 us before the stamp taken just
# before launching it)
CLOCK_NS = 100_000


def _device_kernels(prof) -> list:
    from torch.autograd import DeviceType

    return sorted(((e.name(), int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
                   for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA),
                  key=lambda e: e[1])


@pytest.mark.cuda
def test_a_span_shares_the_device_traces_clock(card):
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda.synchronize()  # an empty stream: the kernel starts at once
            with annotate("sleep"):
                torch.cuda._sleep(20000)
            torch.cuda.synchronize()
    spans = recorded().spans
    kernels = [k for k in _device_kernels(prof) if MARKER in k[0]]
    assert len(spans) == len(kernels) == 5
    for span, (_, start, _) in zip(spans, kernels):
        assert span.start_ns - CLOCK_NS < start < span.end_ns + 1_000_000


@pytest.mark.cuda
def test_the_engine_brackets_each_call_with_one_marker_pair(card):
    from audiblelight_tpu_torch.rir.image_source import shoebox_rirs

    args = ([5.0, 4.0, 3.0], torch.tensor([[1.0, 1.0, 1.0], [3.0, 2.0, 1.5]], device=card),
            torch.tensor([[2.5, 2.0, 1.5]], device=card), torch.full((6, 1), -0.2, device=card),
            torch.tensor([1000.0], device=card))
    shoebox_rirs(*args, n_samples=1200, max_order=2, sr=SR, encoding="foa")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            shoebox_rirs(*args, n_samples=1200, max_order=2, sr=SR, encoding="foa")
        torch.cuda.synchronize()
    spans = [s for s in recorded().spans if s.name == "engine.ism"]
    events = _device_kernels(prof)
    markers = [i for i, e in enumerate(events) if MARKER in e[0]]
    assert len(spans) == 3 and len(markers) == 6
    for span, begin, end in zip(spans, markers[0::2], markers[1::2]):
        assert end - begin > 1  # the engine's own work lies between its markers
        assert span.start_ns - CLOCK_NS < events[begin][1] < span.end_ns


# --------------------------------------------------------------------------
# The fused path: a ray-traced room through the batched renderer
# --------------------------------------------------------------------------

# Each scene's spans on the fused path, each batch's bounce loop and upload
FUSED_SCENE = ("trace.rain", "trace.carriers", "trace.direct", "trace.diffraction", "fused.stems")
FUSED_PLAN_KW = dict(max_static=2, max_moving=1, max_traj=4, pad_audio_seconds=1.0)
# Deep enough that every loop ends when its rays are dead (0.05 s responses
# end their rays at 17.8 m of path)
FUSED_DEPTH = 40


def _pillar_room():
    """A 6 x 5 x 3 m room with a pillar (1 x 3 x 2.6 m) inside: nonconvex."""
    from audiblelight_tpu_torch.geometry.mesh import TriMesh

    def box(lo, hi, inward):
        v = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])], float)
        f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
        return v, f[:, ::-1].copy() if inward else f

    (v0, f0), (v1, f1) = box([0, 0, 0], [6, 5, 3], True), box([2.5, 1.0, 0.0], [3.5, 4.0, 2.6], False)
    return TriMesh(np.concatenate([v0, v1]), np.concatenate([f0, f1 + len(v0)]))


def _rlr_scene(clip, room, i):
    """A tiny AmbeoVR scene in the pillar room: one source behind the pillar,
    one in view, a moving one; a gaussian bed."""
    from audiblelight_tpu_torch.core import Scene

    scene = Scene(duration=2.0, sample_rate=SR, backend="rlr", max_overlap=3, ref_db=-50, device="cpu",
                  backend_kwargs=dict(mesh=room, material=None, add_to_context=False, seed=11 + i, rlr_kwargs=dict(
                      indirect_ray_count=24, indirect_ray_depth=FUSED_DEPTH, max_ir_length=0.05,
                      mesh_simplification=True, ray_decimation=False, diffraction=True)))
    scene.add_microphone(microphone_type="ambeovr", position=[1.5, 2.5 + 0.1 * i, 1.5])
    for k, (pos, start) in enumerate((([4.5, 2.5, 1.2], 0.0), ([1.0, 1.0, 1.8], 0.5))):
        scene.add_event(event_type="static", filepath=clip, position=pos, scene_start=start, event_start=0.0,
                        duration=1.0, snr=20.0 + k, class_id=k)
    trajectory = np.stack([np.linspace(4.2, 5.0, 3), np.full(3, 0.6), np.full(3, 1.5)], axis=1)
    scene.add_event(event_type="predefined", filepath=clip, trajectory=trajectory, scene_start=0.8,
                    event_start=0.0, duration=1.0, snr=25.0, class_id=2)
    scene.add_ambience(noise="gaussian")
    return scene


def _fused_loop(clip, traced):
    """Three scenes of one room through the loop's fused path (a batch of
    two, then one alone): their payloads in order, and each bounce loop's
    (bounces run, rows a bounce)."""
    from audiblelight_tpu_torch.pipeline import render_scenes_pipelined
    from audiblelight_tpu_torch.rir import raytracer

    room, out, loops = _pillar_room(), [], []
    bounce = raytracer._bounce

    def counted(draws, state, *args, **kwargs):
        loops[-1].append(state[0].shape[0])
        return bounce(draws, state, *args, **kwargs)

    trace = raytracer.trace_energy_histogram_batch

    def loop(*args, **kwargs):
        loops.append([])
        return trace(*args, **kwargs)

    def factory():
        for i in range(3):
            yield _rlr_scene(clip, room, i)

    kw = dict(max_in_flight=2, plan_kwargs=FUSED_PLAN_KW, fused_batch=2, device_mix=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(raytracer, "_bounce", counted)
        mp.setattr(raytracer, "trace_energy_histogram_batch", loop)
        if traced:
            with _traced():
                render_scenes_pipelined(factory(), lambda s, audio: out.append(next(iter(audio.values()))), **kw)
        else:
            render_scenes_pipelined(factory(), lambda s, audio: out.append(next(iter(audio.values()))), **kw)
    return out, loops


@pytest.fixture(scope="module")
def fused_runs(clip):
    """(untraced payloads, traced payloads, the traced run's recording, its loops)."""
    profiling.clear_recorded()
    try:
        plain, _ = _fused_loop(clip, traced=False)
        assert recorded().spans == [] and recorded().counts == []
        traced, loops = _fused_loop(clip, traced=True)
        return plain, traced, recorded(), loops
    finally:
        profiling.clear_recorded()


def test_the_fused_path_records_only_under_a_profiler_and_keeps_its_bits(fused_runs):
    plain, traced, rec, loops = fused_runs
    assert len(plain) == len(traced) == 3
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)
    names = defaultdict(int)
    for s in rec.spans:
        names[s.name] += 1
    # One bounce loop for the batch of two, one for the scene alone
    assert len(loops) == names["trace.bounces"] == 2 and names["fused.upload"] == 1
    assert all(names[name] == 3 for name in FUSED_SCENE), dict(names)
    # All on the dispatch thread (the trailing scene's after its loop.dispatch)
    dispatch = {s.thread for s in rec.spans if s.name == "loop.dispatch"}
    assert len(dispatch) == 1
    assert {s.thread for s in rec.spans if s.name in FUSED_SCENE + ("trace.bounces", "fused.upload")} == dispatch


def test_the_fused_path_counts_a_sync_a_read_of_the_alive_mask(fused_runs):
    _, _, rec, loops = fused_runs
    # Each loop reads the mask before each bounce, and once more to find
    # every ray dead (no loop reaches its depth)
    assert all(0 < len(rows) < FUSED_DEPTH for rows in loops)
    assert rec.total("trace.sync") == sum(len(rows) + 1 for rows in loops)
    assert rec.total("trace.rays") == sum(sum(rows) for rows in loops)
    # The batch's loop hands both scenes' rays to each bounce
    assert loops[0][0] == 2 * loops[1][0]


@pytest.mark.cuda
def test_the_bounce_loop_brackets_each_call_with_one_marker_pair(card):
    from audiblelight_tpu_torch.rir.raytracer import trace_energy_histogram_batch

    room = _pillar_room()
    tris = torch.as_tensor(room.triangles, dtype=torch.float32, device=card)
    args = (tris, torch.full((len(tris), 4), 0.2, device=card), torch.full((len(tris),), 0.5, device=card),
            torch.tensor([[[4.5, 2.5, 1.2], [1.0, 1.0, 1.8]]], device=card),
            torch.tensor([[[1.5, 2.5, 1.5], [1.51, 2.5, 1.5]]], device=card))

    def once():
        gen = torch.Generator(device=card).manual_seed(3)
        return trace_energy_histogram_batch([gen], *args, n_rays=64, max_depth=8, n_bins=32)

    once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            once()
        torch.cuda.synchronize()
    spans = [s for s in recorded().spans if s.name == "trace.bounces"]
    events = _device_kernels(prof)
    markers = [i for i, e in enumerate(events) if MARKER in e[0]]
    assert len(spans) == 3 and len(markers) == 6
    for span, begin, end in zip(spans, markers[0::2], markers[1::2]):
        assert end - begin > 1  # the bounces' own work lies between the markers
        assert span.start_ns - CLOCK_NS < events[begin][1] < span.end_ns
