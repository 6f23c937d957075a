"""The span readers on a synthetic run: the port's spans and counters (as
`profiling.recorded()` gives them) and device events, hand-placed.

    python -m pytest portbench/tests -p no:cacheprovider
"""

from __future__ import annotations

import types
from pathlib import Path
from types import SimpleNamespace

import pytest

from audiblelight_tpu_torch import profiling
from audiblelight_tpu_torch.profiling import Count, Recording, Span
from portbench import counts, manifest, spans
from portbench.trace import DeviceTrace

ROOT = Path(__file__).resolve().parents[2]

NEW = ["plan_host_ms_per_scene", "engine_host_ms_per_scene", "ism_engine_roofline", "stems_host_ms_per_scene",
       "mix_ms_per_scene", "host_syncs_per_scene", "idle_in_plan_pct", "idle_in_engine_pct"]
DISPATCH, COMPLETION = 1, 2
MARK = "at::cuda::(anonymous namespace)::spin_kernel(long)"

# One scene, in ns: the dispatch thread's spans and the completion thread's
# root, which overlaps the device's gaps too but is not the dispatch thread's
SPANS = [
    Span("engine.ism", DISPATCH, 0, 1, 100, 400, 2),
    Span("plan.bed", DISPATCH, 0, 1, 500, 600, 3),
    Span("plan.build", DISPATCH, 0, 0, 0, 700, 1),
    Span("stems.dispatch", DISPATCH, 0, 0, 700, 900, 4),
    Span("loop.dispatch", DISPATCH, 0, None, 0, 1000, 0),
    Span("complete.mix", COMPLETION, 0, 5, 300, 800, 6),
    Span("loop.complete", COMPLETION, 0, None, 300, 800, 5),
]
COUNTS = [Count("host_syncs", DISPATCH, 0, 20), Count("host_syncs", COMPLETION, 0, 3)]
# The engine's markers at 110 and 410, its work between them; a copy and
# the stems' kernel after it
EVENTS = [(MARK, 110, 112), ("k1", 120, 200), ("k2", 250, 300), (MARK, 410, 412), ("Memcpy HtoD", 650, 700),
          ("stems", 900, 950)]
CONFIG = dict(manifest.load_config("shoebox_foa"), engine=dict(max_order=1, max_ir_length=0.01),
              sample_rate=1000)


def _run(events=EVENTS):
    window = SimpleNamespace(records=[dict(index=0, t_yield=0.0, t_next=1e-6, t_done=1e-6)], start=0.0,
                             end=1e-6)
    return SimpleNamespace(config=CONFIG, window=window, trace=DeviceTrace(list(events)), emitters={0: 3})


@pytest.fixture
def recording(monkeypatch):
    def put(spans_, counts_=()):
        monkeypatch.setattr(profiling, "recorded", lambda: Recording(list(spans_), list(counts_), 0))

    put(SPANS, COUNTS)
    return put


def test_idle_goes_to_the_dispatch_threads_innermost_span(recording):
    # Gaps: 112-120, 200-250 in the engine; 300-410 in the engine to 400,
    # then the plan's build; 412-650 in the plan (its self time and the bed);
    # 700-900 in the stems' dispatch (neither)
    assert spans.idle_by_kind(profiling.recorded(), _run().trace) == {"engine": 158, "plan": 248, "other": 200}
    run = _run()
    assert manifest.reader("idle_in_engine_pct")(run) == pytest.approx(15.8)
    assert manifest.reader("idle_in_plan_pct")(run) == pytest.approx(24.8)
    device_idle = manifest.reader("device_idle_pct")(run)
    assert 15.8 + 24.8 <= device_idle


def test_the_host_times_read_their_spans(recording):
    run = _run()
    assert manifest.reader("plan_host_ms_per_scene")(run) == pytest.approx(400e-6)  # 700 less the engine's 300
    assert manifest.reader("engine_host_ms_per_scene")(run) == pytest.approx(300e-6)
    assert manifest.reader("stems_host_ms_per_scene")(run) == pytest.approx(200e-6)
    assert manifest.reader("mix_ms_per_scene")(run) == pytest.approx(500e-6)
    assert manifest.reader("host_syncs_per_scene")(run) == 23


def test_the_engines_roofline_reads_its_brackets(recording):
    run = _run()
    terms = counts.ism_terms(1, 3, 10, 1)
    want = 100.0 * (counts.ISM_FLOPS_PER_TERM * terms / counts.PEAK_FP32) / 130e-9  # k1 and k2 only
    assert spans.engine_busy_ns(profiling.recorded(), run.trace) == 130
    assert manifest.reader("ism_engine_roofline")(run) == pytest.approx(want)
    assert manifest.reader("ism_engine_roofline")(run) >= manifest.reader("ism_roofline")(run)
    # A marker lost from the trace: no pair to read
    assert manifest.reader("ism_engine_roofline")(_run(EVENTS[1:])) is None


def test_no_spans_read_none(recording, monkeypatch):
    recording([], [])
    for name in NEW:
        assert manifest.reader(name)(_run()) is None
    # A port older than its span recorder
    monkeypatch.setitem(__import__("sys").modules, "audiblelight_tpu_torch.profiling",
                        types.ModuleType("audiblelight_tpu_torch.profiling"))
    for name in NEW:
        assert manifest.reader(name)(_run()) is None


def test_the_manifest_lists_the_span_metrics():
    man = manifest.load_manifest(ROOT)
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in NEW:
        assert entries[name]["workloads"] == ["shoebox_foa.dcase5"] and entries[name]["moves"] == "audio_s_per_s"
    assert [m["name"] for m in man["per_layer"]][-len(NEW):] == NEW
