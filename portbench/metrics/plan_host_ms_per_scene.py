"""Host time the port spends building a scene's plan outside the image-source
engine (its `plan.build` spans less their `engine.ism` spans: the IR bank's
stacking, the audio loads and slot packing, the host bed, the upload and the
IR gathers), over the scenes completed in the profiled loop."""

from portbench.spans import ms_per_scene


def read(run):
    return ms_per_scene(run, "plan.build", minus=("engine.ism",))
