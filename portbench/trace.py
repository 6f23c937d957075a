"""The device trace of a traced run, reduced: torch.profiler's device
events (kernels, copies, sets) with their names, starts and lengths, the
union of their intervals, and the breakdown the result line carries."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class DeviceTrace:
    """Device events of the profiled loop: (name, start ns, end ns) each."""

    events: list = field(default_factory=list)

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        from torch.autograd import DeviceType

        out = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                out.append((e.name(), int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns())))
        out.sort(key=lambda x: x[1])
        return cls(out)

    @property
    def kernels(self) -> list:
        """The kernel launches: every device event that is no copy or set."""
        return [e for e in self.events if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_ns(self) -> int:
        """The union of the device events' intervals."""
        total, end = 0, None
        for _, a, b in self.events:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def time_by_name(self) -> dict:
        out = defaultdict(int)
        for name, a, b in self.events:
            out[name] += b - a
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the operation the device had just finished (the
        host was then preparing what followed it)."""
        ops = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps, end, last = [], None, None
        for name, a, b in self.events:
            if end is not None and a > end:
                gaps.append((f"after {last}", (a - end) * 1e-9))
            if end is None or b > end:
                end, last = b, name
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n[:200], t * 1e-9] for n, t in ops],
                "idle_gaps": [[n[:200], s] for n, s in gaps[:top]]}
