"""Host time inside the image-source engine's calls (the port's `engine.ism`
spans: its launches, and its waits on the device), over the scenes completed
in the profiled loop."""

from portbench.spans import ms_per_scene


def read(run):
    return ms_per_scene(run, "engine.ism")
