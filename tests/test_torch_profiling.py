"""The port's stage timers (audiblelight_tpu_torch/profiling.py) against the
reference's (audiblelight_tpu/profiling.py).

The reference's five tests run on the port; the report, `to_dict` and
`dump` formats equal the reference's character for character for the same
stage statistics; the trace capture writes its Chrome-trace file on the
CPU. The card's synced stage is held in tests/test_torch_cuda.py (a file
without JAX, so it runs on the card)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu import profiling as ref
from audiblelight_tpu_torch import profiling as port
from audiblelight_tpu_torch.profiling import Profiler, annotate, device_memory_stats, torch_trace


def test_profiler_stages():
    prof = Profiler(sync=False)
    with prof.stage("alpha"):
        sum(range(1000))
    with prof.stage("alpha"):
        sum(range(1000))
    with prof.stage("beta"):
        pass
    assert prof.stages["alpha"].calls == 2
    assert prof.stages["beta"].calls == 1
    assert prof.stages["alpha"].total_seconds >= 0
    report = prof.report()
    assert "alpha" in report and "beta" in report


def test_profiler_sync_with_device():
    prof = Profiler(sync=True)
    with prof.stage("matmul"):
        x = torch.ones((256, 256))
        y = x @ x
        assert prof.block(y) is y
    assert prof.stages["matmul"].calls == 1
    assert prof.stages["matmul"].total_seconds > 0


def test_profiler_dump(tmp_path):
    prof = Profiler(sync=False)
    with prof.stage("s"):
        pass
    p = tmp_path / "prof.json"
    prof.dump(p)
    loaded = json.loads(p.read_text())
    assert "s" in loaded
    prof.reset()
    assert len(prof.stages) == 0


def test_annotate_context():
    with annotate("test-region"):
        _ = torch.ones(8) * 2


def test_device_memory_stats():
    stats = device_memory_stats()
    assert isinstance(stats, dict)
    assert len(stats) >= 1
    # Without a card the port reports its one CPU device with no statistics,
    # as JAX's CPU devices (8 virtual ones in these tests) do
    assert stats == {"cpu": None}
    assert set(ref.device_memory_stats().values()) == {None}


def _filled(cls, stats):
    prof = cls(sync=False)
    for name, (calls, total, worst) in stats.items():
        s = prof.stages[name]
        s.calls, s.total_seconds, s.max_seconds = calls, total, worst
    return prof


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_report_and_dicts_equal_the_reference(seed, tmp_path):
    """The same statistics give the reference's report, dict and JSON text,
    character for character (stage names longer than the column included)."""
    rng = np.random.default_rng(seed)
    names = ["trace", "render", "a_rather_long_stage_name", "io", "mix"][: 2 + seed]
    stats = {n: (int(rng.integers(1, 50)), float(rng.uniform(0, 100)), float(rng.uniform(0, 5))) for n in names}
    stats["never"] = (0, 0.0, 0.0)
    got, want = _filled(Profiler, stats), _filled(ref.Profiler, stats)
    assert got.report() == want.report()
    assert got.to_dict() == want.to_dict()
    assert got.stages["never"].mean_seconds == want.stages["never"].mean_seconds == 0.0
    got.dump(tmp_path / "got.json")
    want.dump(tmp_path / "want.json")
    assert (tmp_path / "got.json").read_text() == (tmp_path / "want.json").read_text()


def test_stage_timing_matches_the_reference_shape():
    """Both profilers time the same blocks into the same stages; the stage
    survives an exception in its block, as the reference's does."""
    got, want = Profiler(sync=True), ref.Profiler(sync=True)
    for prof, ones in ((got, torch.ones), (want, jnp.ones)):
        for _ in range(3):
            with prof.stage("work"):
                prof.block(ones((64, 64)) * 2)
        with pytest.raises(ValueError):
            with prof.stage("fails"):
                raise ValueError("in the block")
    for name in ("work", "fails"):
        assert got.stages[name].calls == want.stages[name].calls
        assert got.stages[name].max_seconds <= got.stages[name].total_seconds
    assert list(got.to_dict()) == list(want.to_dict())


def test_block_walks_nested_values():
    value = {"a": [torch.ones(2), (torch.zeros(3), 1.0)], "b": "text"}
    assert Profiler().block(value) is value
    assert port._cuda_devices(value, set()) == set()


def test_trace_capture_writes_its_file_on_the_cpu(tmp_path):
    with torch_trace(tmp_path / "traces") as cap:
        with annotate("traced-region"):
            y = torch.ones((64, 64)) @ torch.ones((64, 64))
    assert float(y[0, 0]) == 64.0
    assert cap.path is not None and cap.path.parent == tmp_path / "traces" and cap.path.is_file()
    trace = json.loads(cap.path.read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "traced-region" in names
    assert any(n and "mm" in n for n in names)
