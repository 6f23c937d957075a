"""Factory yield to `complete` return, 95th percentile of the scenes
completed inside the window, with their count."""

import statistics


def read(run):
    lat = sorted(1e3 * (r["t_done"] - r["t_yield"]) for r in run.inside)
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20)[-1], len(lat)
