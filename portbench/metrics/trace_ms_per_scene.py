"""The ray tracer's bounce loop on the device: the busy time between the
marker pair that the port puts on the stream as each `trace.bounces` span
opens and closes (one span a batch's bounce loop), over the scenes
completed in the profiled loop."""

from portbench.spans import recording, scenes_done
from portbench.tracer_spans import bounces_busy_ns


def read(run):
    rec, n = recording(), scenes_done(run)
    if rec is None or run.trace is None or not n:
        return None
    busy = bounces_busy_ns(rec, run.trace)
    return None if busy is None else 1e-6 * busy / n
