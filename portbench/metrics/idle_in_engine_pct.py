"""The device's idle time (the gaps between the union of its events) while
the dispatch thread's innermost open span was the image-source engine's
(`engine.ism`), over the loop's wall time."""

from portbench.spans import idle_pct


def read(run):
    return idle_pct(run, "engine")
