"""Stage timers and profiler capture for the port.

Counterpart of audiblelight_tpu/profiling.py: `StageStats` and `Profiler`
(per-stage wall-clock accumulators, synchronised on the card so a stage owns
the device work it launched), `annotate` (a named region in traces) and
`device_memory_stats`. `torch_trace` takes the place of the reference's
`xla_trace` (a `jax.profiler.trace` capture): a `torch.profiler.profile` of
the enclosed block, written as a Chrome-trace JSON under `log_dir`.

The reference swallows every exception of its device sync
(`Profiler.stage`, `Profiler.block`); here a failed `torch.cuda.synchronize`
raises, so a fault on the card is never hidden behind a stage time.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Generator, Optional, Union

import torch

from audiblelight_tpu_torch.utils import logger


def _sync_card() -> None:
    """Wait for every card this process has used. Nothing runs
    asynchronously on the CPU, so a process that never initialised CUDA has
    nothing to wait for. Raises when the sync fails."""
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _cuda_devices(value: Any, found: set) -> set:
    """The CUDA devices of the tensors in `value` (nested lists, tuples and
    dicts are searched)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, found)
    return found


@dataclass
class StageStats:
    """Cumulative statistics for one pipeline stage."""

    calls: int = 0
    total_seconds: float = 0.0
    max_seconds: float = 0.0

    @property
    def mean_seconds(self) -> float:
        return self.total_seconds / self.calls if self.calls else 0.0


@dataclass
class Profiler:
    """Per-stage timing accumulator for the render pipeline.

    Usage:
        prof = Profiler(sync=True)
        with prof.stage("trace"):
            irs = trace_rirs_multi(...)
        with prof.stage("render"):
            out = render_scene_arrays(...)
        print(prof.report())

    With `sync=True` (default) each stage ends with `torch.cuda.synchronize()`
    on every card the process has used, so device work is attributed to the
    stage that launched it rather than wherever the host next blocks. On the
    CPU nothing is asynchronous and the sync does nothing. A failed sync
    raises (the reference ignores it).
    """

    sync: bool = True
    stages: Dict[str, StageStats] = field(default_factory=lambda: defaultdict(StageStats))
    _last_result: Any = None

    @contextlib.contextmanager
    def stage(self, name: str) -> Generator[None, None, None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                _sync_card()
            elapsed = time.perf_counter() - start
            s = self.stages[name]
            s.calls += 1
            s.total_seconds += elapsed
            s.max_seconds = max(s.max_seconds, elapsed)

    def block(self, value: Any) -> Any:
        """Wait for the devices of the tensors in `value` (a tensor, or
        nested lists, tuples and dicts of them) inside a stage, to attribute
        their device time. Returns `value`. A failed sync raises."""
        for device in _cuda_devices(value, set()):
            torch.cuda.synchronize(device)
        return value

    def report(self) -> str:
        """Human-readable per-stage summary, longest total first."""
        rows = sorted(self.stages.items(), key=lambda kv: -kv[1].total_seconds)
        lines = [f"{'stage':<16}{'calls':>7}{'total_s':>10}{'mean_s':>10}{'max_s':>10}"]
        for name, s in rows:
            lines.append(
                f"{name:<16}{s.calls:>7}{s.total_seconds:>10.3f}{s.mean_seconds:>10.4f}"
                f"{s.max_seconds:>10.4f}"
            )
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """JSON-serialisable stage statistics."""
        return {
            name: dict(calls=s.calls, total_seconds=s.total_seconds, mean_seconds=s.mean_seconds)
            for name, s in self.stages.items()
        }

    def dump(self, path: Union[str, Path]) -> None:
        """Write stage statistics as JSON."""
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    def reset(self) -> None:
        self.stages.clear()


@dataclass
class TraceCapture:
    """A trace capture: `profile` is the `torch.profiler.profile` (for
    `key_averages()`), `path` the Chrome-trace JSON, set when the block ends."""

    profile: Any
    path: Optional[Path] = None


@contextlib.contextmanager
def torch_trace(log_dir: Union[str, Path], host_trace: bool = True) -> Generator[TraceCapture, None, None]:
    """Capture a profiler trace of the enclosed block, in place of the
    reference's `xla_trace`: the card's kernels (where one is present) and
    the CPU's ops (with `host_trace`, or where no card is present), written
    on exit as a Chrome-trace JSON (Perfetto, chrome://tracing) under
    `log_dir`:

        with torch_trace("traces") as cap:
            ...
        print(cap.path)
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] if on_card else []
    if host_trace or not on_card:
        activities.insert(0, ProfilerActivity.CPU)
    logger.warning(f"Capturing a torch.profiler trace to {log_dir}")
    cap = TraceCapture(profile(activities=activities))
    with cap.profile:
        yield cap
        _sync_card()
    cap.path = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    cap.profile.export_chrome_trace(str(cap.path))


@contextlib.contextmanager
def annotate(name: str) -> Generator[None, None, None]:
    """A named region in traces: a `torch.profiler.record_function` range,
    plus an NVTX range where a card is present."""
    on_card = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if on_card:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if on_card:
                torch.cuda.nvtx.range_pop()


def device_memory_stats() -> Optional[dict]:
    """Per-device memory statistics, keyed by `str(device)`: on each card
    `bytes_in_use` and `peak_bytes_in_use` (the caching allocator's
    allocated bytes, `torch.cuda.memory_stats`) and `bytes_limit` (the
    card's total memory, `torch.cuda.mem_get_info`); without a card
    `{"cpu": None}`, as JAX's CPU device reports none."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    stats = {}
    for i in range(torch.cuda.device_count()):
        mem = torch.cuda.memory_stats(i)
        stats[str(torch.device("cuda", i))] = dict(
            bytes_in_use=int(mem.get("allocated_bytes.all.current", 0)),
            peak_bytes_in_use=int(mem.get("allocated_bytes.all.peak", 0)),
            bytes_limit=int(torch.cuda.mem_get_info(i)[1]),
        )
    return stats


__all__ = ["StageStats", "Profiler", "TraceCapture", "torch_trace", "annotate", "device_memory_stats"]
