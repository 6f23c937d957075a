"""Host time of the responses' synthesis past the bounce loop, scene by
scene: the noise carriers (`trace.carriers`), the direct paths
(`trace.direct`) and knife-edge diffraction (`trace.diffraction`), over the
scenes completed in the profiled loop."""

from portbench.spans import recording, scenes_done
from portbench.tracer_spans import spans_named

NAMES = ("trace.carriers", "trace.direct", "trace.diffraction")


def read(run):
    rec, n = recording(), scenes_done(run)
    if rec is None or not n:
        return None
    spans = [s for name in NAMES for s in spans_named(rec, name)]
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans) / n if spans else None
