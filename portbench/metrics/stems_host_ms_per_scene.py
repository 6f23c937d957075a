"""Host time dispatching each scene's stems on the device (the port's
`stems.dispatch` spans: the renders and the int16 quantisation), over the
scenes completed in the profiled loop."""

from portbench.spans import ms_per_scene


def read(run):
    return ms_per_scene(run, "stems.dispatch")
