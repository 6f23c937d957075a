"""What the span readers share: the port's own spans and counters of the
profiled loop (`audiblelight_tpu_torch.profiling.recorded()`), read against
the device trace. Spans and device events are both Unix-epoch nanoseconds.

A port that records no spans (one older than its span recorder, or a run
whose profiled loop recorded none) gives `recording()` None, and each reader
then returns None.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right

# The kernel `torch.cuda._sleep(0)` launches: the port puts one on the
# stream as a bracketed span opens and one as it closes
MARKER = "spin_kernel"
ENGINE = "engine.ism"
PLAN = "plan.build"


def recording():
    """The port's recording of the profiled loop, or None."""
    try:
        from audiblelight_tpu_torch.profiling import recorded
    except ImportError:
        return None
    rec = recorded()
    return rec if rec.spans else None


def scenes_done(run) -> int:
    return sum(1 for r in run.window.records if "t_done" in r)


def total_ns(rec, name: str) -> int:
    return sum(s.end_ns - s.start_ns for s in rec.spans if s.name == name)


def ms_per_scene(run, *names: str, minus: tuple = ()):
    """The summed durations of the spans `names` less those of `minus`, in
    ms over the scenes completed, or None."""
    rec, n = recording(), scenes_done(run)
    if rec is None or not n:
        return None
    ns = sum(total_ns(rec, name) for name in names) - sum(total_ns(rec, name) for name in minus)
    return 1e-6 * ns / n


def _union(events) -> list:
    """The union of (name, start, end) intervals, sorted by start, as
    disjoint [start, end] pieces."""
    out = []
    for _, a, b in events:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def engine_busy_ns(rec, trace):
    """The device's busy time inside the engine's marker pairs: the union of
    the device events between each pair's markers (in stream order, so the
    engine's own work), or None where the markers do not come two to each
    engine span."""
    markers = [e for e in trace.events if MARKER in e[0]]
    n_engine = sum(1 for s in rec.spans if s.name == ENGINE)
    if not n_engine or len(markers) != 2 * n_engine:
        return None
    starts = [e[1] for e in trace.events]
    busy = 0
    for begin, end in zip(markers[0::2], markers[1::2]):
        inside = trace.events[bisect_right(starts, begin[1]):bisect_left(starts, end[1])]
        busy += sum(b - a for a, b in _union([e for e in inside if MARKER not in e[0] and e[2] <= end[1]]))
    return busy


def _kind(span, by_id) -> str:
    """"engine" within the engine's span, "plan" within the plan's build
    elsewhere, else "other"."""
    kind = "other"
    while span is not None:
        if span.name == ENGINE:
            return "engine"
        if span.name == PLAN:
            kind = "plan"
        span = by_id.get(span.parent)
    return kind


def _innermost(rec) -> list:
    """The dispatch thread's time cut into [start, end, kind] pieces, each
    the self time of one span (its interval less its children's), sorted."""
    threads = {s.thread for s in rec.spans if s.name == "loop.dispatch"}
    spans = [s for s in rec.spans if s.thread in threads]
    by_id = {s.id: s for s in spans}
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    pieces = []
    for s in spans:
        kind, t = _kind(s, by_id), s.start_ns
        for c in sorted(children.get(s.id, ()), key=lambda c: c.start_ns):
            if c.start_ns > t:
                pieces.append((t, c.start_ns, kind))
            t = max(t, c.end_ns)
        if s.end_ns > t:
            pieces.append((t, s.end_ns, kind))
    return sorted(pieces)


def idle_by_kind(rec, trace) -> dict:
    """The device's idle time (the gaps between the union of its events)
    while the dispatch thread's innermost open span was the engine's
    ("engine"), within the plan's build ("plan"), or any other ("other"), ns."""
    union = _union(trace.events)
    gaps = [(a[1], b[0]) for a, b in zip(union, union[1:])]
    pieces = _innermost(rec)
    out = {"engine": 0, "plan": 0, "other": 0}
    i = j = 0
    while i < len(gaps) and j < len(pieces):
        (ga, gb), (pa, pb, kind) = gaps[i], pieces[j]
        overlap = min(gb, pb) - max(ga, pa)
        if overlap > 0:
            out[kind] += overlap
        if gb <= pb:
            i += 1
        else:
            j += 1
    return out


def idle_pct(run, kind: str):
    """The idle share of `kind` (see `idle_by_kind`) over the loop's wall."""
    rec = recording()
    if rec is None or run.trace is None or not run.trace.events:
        return None
    wall = run.window.end - run.window.start
    return 100.0 * 1e-9 * idle_by_kind(rec, run.trace)[kind] / wall
