"""The ray-traced cell's output check on the CPU at a tiny size: a
nonconvex room (a 6 x 5 x 3 m box with a pillar inside), tens of rays, 16
bounces, 0.1 s responses and 4 s scenes. The port agrees with the float64
reference within the configuration's limits, the bfloat16 control does
not, and four faults made in the port read incorrect: diffraction off, the
rain table ignored, one band's absorption scaled, the responses a sample
late. The reference imports nothing of the port and builds the port's LOD;
a scene's payload does not depend on the batch it rides in.

    python -m pytest portbench/tests -p no:cacheprovider
"""

from __future__ import annotations

import ast
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, manifest, meshroom, program, traffic
from portbench.control import readings
from portbench.reference import rlr as reference
from portbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "scanned_mic.dcase5"
LIMITS = {k: v for k, v in manifest.load_config("scanned_mic")["check"].items() if k != "sample"}
# A pillar, 1 x 3 m and 2.6 m tall, in a 6 x 5 x 3 m room: many sources
# stand behind it, so that diffraction and the rain table both matter
PILLAR = ([2.5, 1.0, 0.0], [3.5, 4.0, 2.6])
# Tiny sizes: scenes of one static and one moving event of three points
# (4 emitters), loud as the cell's loudest events are
TINY_MIX = dict(static=1, moving=1, moving_seconds=2.0, static_seconds=[1.0, 1.5], trajectory_length_m=[1.5, 1.9],
                trajectory_points=3, clips=2, clip_seconds=2.0, ring=3, snr_db=[25.0, 30.0])
CONFIG = manifest.load_config("scanned_mic")
TINY = dict(duration_s=4.0, room=dict(mesh="pillar_room"),
            engine=dict(CONFIG["engine"], max_ir_length=0.1, indirect_ray_count=48, indirect_ray_depth=16),
            pipeline=dict(CONFIG["pipeline"], plan_kwargs=dict(CONFIG["pipeline"]["plan_kwargs"],
                                                               pad_audio_seconds=2.0)))


def _box(lo, hi, inward: bool) -> tuple:
    v = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])], float)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f[:, ::-1].copy() if inward else f


def pillar_room() -> tuple:
    (v0, f0), (v1, f1) = _box([0, 0, 0], [6, 5, 3], True), _box(*PILLAR, False)
    return np.concatenate([v0, v1]), np.concatenate([f0, f1 + len(v0)])


@pytest.fixture(autouse=True)
def room(tmp_path_factory, monkeypatch):
    """The pillar room as `meshes/pillar_room.npz` beside the benchmark's
    meshes; numpy's global stream restored after each test."""
    from portbench.backends import rlr as backend

    base = tmp_path_factory.mktemp("bench")
    (base / "meshes").mkdir()
    v, f = pillar_room()
    np.savez(base / "meshes" / "pillar_room.npz", vertices=v, faces=f)
    load = manifest.load_mesh
    monkeypatch.setattr(manifest, "load_mesh", lambda name, b=None: load(name, base if name == "pillar_room"
                                                                         else manifest.HERE))
    state = np.random.get_state()
    backend.mesh.cache_clear()
    meshroom.space.cache_clear()
    yield
    backend.mesh.cache_clear()
    meshroom.space.cache_clear()
    np.random.set_state(state)


def _run(seed: int) -> dict:
    return run_cell(CELL, seed, 8.0, False, ROOT, device="cpu", config_overrides=TINY, mix_overrides=TINY_MIX)


def test_the_reference_equals_the_port_on_the_cpu():
    r = _run(2**33 + 5)
    assert r["correct"], r["check"]
    assert r["check"]["scenes_checked"]["value"] >= 1 and r["failed"] == 0
    assert list(r["check"]) == list(LIMITS) + ["scenes_checked"]
    # The same rays: what is left is float32's rounding, at most half of
    # each limit, as the configuration's limits were chosen on the card
    assert all(r["check"][k]["value"] <= v / 2 for k, v in LIMITS.items()), r["check"]


def test_the_control_reads_incorrect():
    for r in readings(CELL, [11, 12, 13], ROOT, device="cpu", config_overrides=TINY, mix_overrides=TINY_MIX):
        assert not check.judge(LIMITS, dict(r, checked=1))[0], r


def _diffraction_off(monkeypatch):
    from audiblelight_tpu_torch.rir import raytracer

    monkeypatch.setattr(raytracer, "diffracted_path_ir", lambda tris, src, *a, **k: torch.zeros(
        (len(src), 4, round(TINY["engine"]["max_ir_length"] * CONFIG["sample_rate"]))))


def _rain_ignored(monkeypatch):
    from audiblelight_tpu_torch.worldstate.mesh_backend import MeshDeviceState

    orig = MeshDeviceState.rain_occlusion_for
    monkeypatch.setattr(MeshDeviceState, "rain_occlusion_for", lambda self, pts: torch.zeros_like(orig(self, pts)))


def _band_scaled(monkeypatch):
    from audiblelight_tpu_torch.worldstate import mesh_backend

    orig = mesh_backend.face_props

    def scaled(*args):
        alpha, scattering, tau = orig(*args)
        alpha = alpha.copy()
        alpha[:, 2] *= 2.0
        return alpha, scattering, tau

    monkeypatch.setattr(mesh_backend, "face_props", scaled)


def _late(monkeypatch):
    from audiblelight_tpu_torch.rir import raytracer

    orig = raytracer.trace_rirs_batch
    monkeypatch.setattr(raytracer, "trace_rirs_batch",
                        lambda *a, **k: [torch.roll(irs, 1, dims=-1) for irs in orig(*a, **k)])


@pytest.mark.parametrize("fault", [_diffraction_off, _rain_ignored, _band_scaled, _late],
                         ids=["diffraction_off", "rain_ignored", "band_absorption_scaled", "responses_late"])
def test_a_fault_in_the_port_reads_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    r = _run(2**33 + 6)
    assert r["check"]["scenes_checked"]["value"] >= 1
    assert not r["correct"], r["check"]


def test_the_pillar_blocks_paths_that_diffraction_bends_round():
    """The scenes the faults are read on have blocked direct paths."""
    config = dict(CONFIG, **TINY)
    mix = dict(manifest.load_mix("dcase5"), **TINY_MIX)
    spec = traffic.scene(config, mix, 2**33 + 6, 0)
    room = reference.room_of(config, spec, "cpu")
    src = torch.as_tensor(reference.emitters(spec) - room.centre)
    caps = torch.as_tensor(np.asarray(spec["mic"]["position"]) + np.asarray(config["rig"]["capsules"]) - room.centre)
    blocked = room.full.blocked(caps[None].expand(len(src), -1, 3).reshape(-1, 3),
                                src[:, None].expand(-1, len(caps), 3).reshape(-1, 3))
    assert blocked.any() and not blocked.all()


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_port_or_jax():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert not _imports(path) & {"audiblelight_tpu_torch", "audiblelight_tpu", "jax", "jaxlib"}, path


@pytest.mark.parametrize("mesh,budget", [("pillar_room", 2), ("scanned_room_0", 4096)])
def test_the_reference_lod_is_the_ports(mesh, budget):
    from audiblelight_tpu_torch.geometry.mesh import TriMesh

    v, f = manifest.load_mesh(mesh)
    tri = TriMesh(v, f)
    if mesh == "pillar_room":  # subdivided, so that a budget of faces cuts it
        tri = tri.subdivided(2)
        budget = len(tri.faces) // budget
    want = tri.simplified(target_faces=budget)
    got_v, got_f = reference.lod(tri.vertices, tri.faces, budget)
    assert len(got_f) < len(tri.faces)
    assert np.array_equal(got_v, want.vertices) and np.array_equal(got_f, want.faces)


def test_a_scene_does_not_depend_on_its_batch():
    """Four scenes through one batched render and each alone: the same
    payloads, bit for bit."""
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer
    from audiblelight_tpu_torch.render import build_scene_plan

    config = dict(CONFIG, **TINY, device="cpu")
    mix = dict(manifest.load_mix("dcase5"), **TINY_MIX)
    clips = traffic.clips(mix, int(config["sample_rate"]), 3)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, clip in enumerate(clips):
            paths.append(str(Path(tmp) / f"clip{i}.wav"))
            program.write_clip(paths[-1], clip, int(config["sample_rate"]))

        def scenes():
            return [program.build_scene(config, traffic.scene(config, mix, 3, i), paths) for i in range(4)]

        one, four = scenes(), scenes()
        plans = [build_scene_plan(s, **config["pipeline"]["plan_kwargs"]) for s in one]
        renderer = FusedSceneRenderer.from_scene(one[0], plans[0])
        alone = [renderer.render_scene(s, p) for s, p in zip(one, plans)]
        plans = [build_scene_plan(s, **config["pipeline"]["plan_kwargs"]) for s in four]
        batch = renderer.render_mix_batch([renderer.scene_inputs(s, device=False) for s in four], plans,
                                          [renderer.mix_args(s) for s in four])
    assert batch.shape[0] == 4
    for a, b in zip(alone, batch):
        assert a.dtype == b.dtype == torch.int16 and torch.equal(a, b)


# The ray tracer's readers on a synthetic run, hand-placed: one batch of
# two scenes, its bounce loop's markers at 100 and 500 ns with a K1 and a
# K3 launch between them, a K2 launch after
TRACER = ["trace_ms_per_scene", "trace_host_ms_per_scene", "synth_host_ms_per_scene", "trace_syncs_per_scene",
          "first_hit_roofline", "any_hit_roofline", "deposit_roofline"]
MARK = "at::cuda::(anonymous namespace)::spin_kernel(long)"
EVENTS = [(MARK, 100, 102), ("(anonymous namespace)::first_hit_big_kernel(float const*)", 110, 310),
          ("void (anonymous namespace)::deposit_histogram_kernel<float4>(float const*)", 320, 360),
          (MARK, 500, 502), ("void (anonymous namespace)::any_hit_kernel(float const*)", 600, 1600)]


def _spans():
    from audiblelight_tpu_torch.profiling import Count, Span

    spans = [Span("loop.dispatch", 1, 1, None, 0, 2000, 0), Span("trace.bounces", 1, 1, 0, 90, 700, 1),
             Span("trace.rain", 1, 1, 0, 20, 80, 2)]
    spans += [Span(name, 1, 1, 0, 700 + 100 * i, 750 + 100 * i, 3 + i)
              for i, name in enumerate(["trace.carriers", "trace.direct", "trace.diffraction"] * 2)]
    return spans, [Count("trace.sync", 1, 1, 3), Count("trace.rays", 1, 1, 2 * 4 * 48)]


def _synthetic(events=EVENTS):
    from types import SimpleNamespace

    from portbench.trace import DeviceTrace

    window = SimpleNamespace(records=[dict(index=i, t_done=1e-6) for i in range(2)], start=0.0, end=1e-6)
    return SimpleNamespace(config=dict(CONFIG, **TINY), window=window, trace=DeviceTrace(list(events)),
                           emitters={0: 4, 1: 3})


def test_the_tracers_readers_read_their_spans_counters_and_kernels(monkeypatch):
    from audiblelight_tpu_torch import profiling
    from audiblelight_tpu_torch.profiling import Recording
    from portbench import counts, tracer_counts

    spans, counters = _spans()
    monkeypatch.setattr(profiling, "recorded", lambda: Recording(spans, counters, 0))
    run = _synthetic()
    read = {name: manifest.reader(name)(run) for name in TRACER}
    assert read["trace_ms_per_scene"] == pytest.approx(1e-6 * 240 / 2)  # K1 and K3 between the markers
    assert read["trace_host_ms_per_scene"] == pytest.approx(1e-6 * 610 / 2)
    assert read["synth_host_ms_per_scene"] == pytest.approx(1e-6 * 300 / 2)
    assert read["trace_syncs_per_scene"] == 1.5
    faces = len(pillar_room()[1])
    rays = 2 * 4 * 48
    assert read["first_hit_roofline"] == pytest.approx(
        100 * counts.bound_s(0, rays * 32 + faces * 36) / 200e-9)
    assert read["deposit_roofline"] == pytest.approx(
        100 * counts.bound_s(0, rays * (12 + 12 + 16 + 4 + 4) + (rays // 48) * 4 * 4 * 51 * 4) / 40e-9)
    # The rain table, then each scene's direct, trigger, one-bend and graph legs (4 sources each)
    queries = [(faces, faces)] + 2 * tracer_counts.any_hit_queries(4, 4, faces, faces, 10)
    assert read["any_hit_roofline"] == pytest.approx(
        100 * counts.bound_s(0, tracer_counts.any_hit_bytes(queries)) / 1000e-9)
    # A port without the tracer's spans and counters (the parent's) reads none
    monkeypatch.setattr(profiling, "recorded", lambda: Recording([spans[0]], [], 0))
    assert all(manifest.reader(name)(run) is None for name in TRACER)
    # A marker lost: no pair to read
    monkeypatch.setattr(profiling, "recorded", lambda: Recording(spans, counters, 0))
    assert manifest.reader("trace_ms_per_scene")(_synthetic(EVENTS[1:])) is None
