"""Host time the loop spends between taking a scene from the benchmark's
factory and asking for the next, summed over the window, over its scenes
(the benchmark's own timestamps around each yield)."""


def read(run):
    recs = [r for r in run.window.records if "t_next" in r]
    if not recs:
        return None
    return 1e3 * sum(r["t_next"] - r["t_yield"] for r in recs) / len(recs)
