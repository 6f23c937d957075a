"""The bounce loop's waits for the device: the port's `trace.sync` counter
(each read of the scenes' alive mask, one before each bounce and one that
finds every ray dead), over the scenes completed in the profiled loop. A
batch's loop reads once for all of its scenes."""

from portbench.tracer_spans import counted


def read(run):
    got = counted(run, "trace.sync")
    return None if got is None else got[1] / got[2]
