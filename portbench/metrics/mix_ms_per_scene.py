"""Host time placing the quantised stems and adding the host bed on the
completion thread (the port's `complete.mix` spans), over the scenes
completed in the profiled loop."""

from portbench.spans import ms_per_scene


def read(run):
    return ms_per_scene(run, "complete.mix")
