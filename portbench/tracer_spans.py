"""What the ray tracer's readers share: the port's spans and counters of
the fused path (`trace.bounces` with its marker pair on the stream,
`trace.rain`, `trace.carriers`, `trace.direct`, `trace.diffraction`, the
counters `trace.sync` and `trace.rays`), and its kernels' device time in
the device trace, matched by kernel name.

A port without these spans or counters (one older than them) gives each
reader None.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right

from portbench.spans import MARKER, _union, recording, scenes_done

BOUNCES = "trace.bounces"
# The kernels' names as the device trace gives them (a name holds the
# first and not the second)
KERNELS = {
    "first_hit": (("first_hit_big_kernel", "first_hit_small_kernel"), ()),
    "any_hit": (("any_hit_kernel",), ("star_any_hit",)),
    "deposit": (("deposit_histogram_kernel",), ("foa",)),
}


def spans_named(rec, name: str) -> list:
    return [s for s in rec.spans if s.name == name]


def bounces_busy_ns(rec, trace):
    """The device's busy time between each `trace.bounces` span's two
    markers (the union of the device events between them in stream
    order), or None where the trace's markers are not two to each such
    span."""
    markers = [e for e in trace.events if MARKER in e[0]]
    n = len(spans_named(rec, BOUNCES))
    if not n or len(markers) != 2 * n:
        return None
    starts = [e[1] for e in trace.events]
    busy = 0
    for begin, end in zip(markers[0::2], markers[1::2]):
        inside = trace.events[bisect_right(starts, begin[1]):bisect_left(starts, end[1])]
        busy += sum(b - a for a, b in _union([e for e in inside if MARKER not in e[0] and e[2] <= end[1]]))
    return busy


def kernel_events(trace, kernel: str) -> list:
    """The device trace's launches of `kernel` (a key of KERNELS)."""
    take, skip = KERNELS[kernel]
    return [e for e in trace.kernels if any(t in e[0] for t in take) and not any(s in e[0] for s in skip)]


def counted(run, name: str):
    """(the recording, the counter's total, scenes completed), or None
    where the port counted nothing under that name."""
    rec, n = recording(), scenes_done(run)
    if rec is None or not n:
        return None
    total = rec.total(name)
    return (rec, total, n) if total else None


def roofline(run, kernel: str, nbytes_of):
    """The kernel's bound over its device time in the trace, %: the bound
    from `nbytes_of(rec, launches)` bytes at the card's bandwidth."""
    from portbench.counts import bound_s

    got = counted(run, "trace.rays")
    if got is None or run.trace is None:
        return None
    rec = got[0]
    events = kernel_events(run.trace, kernel)
    if not events:
        return None
    busy = sum(b - a for _, a, b in events)
    return 100.0 * bound_s(0.0, nbytes_of(rec, len(events))) / (1e-9 * busy)
