"""Host time inside the ray tracer's bounce loops (the port's
`trace.bounces` spans: the launches of every bounce, its draws, and each
bounce's wait for the alive mask), over the scenes completed in the
profiled loop."""

from portbench.spans import recording, scenes_done
from portbench.tracer_spans import BOUNCES, spans_named


def read(run):
    rec, n = recording(), scenes_done(run)
    if rec is None or not n:
        return None
    spans = spans_named(rec, BOUNCES)
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans) / n if spans else None
