"""The device's idle time (the gaps between the union of its events) while
the dispatch thread's innermost open span was the plan's build or one of its
parts other than the image-source engine, over the loop's wall time."""

from portbench.spans import idle_pct


def read(run):
    return idle_pct(run, "plan")
