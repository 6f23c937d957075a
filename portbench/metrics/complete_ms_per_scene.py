"""Host clock inside the benchmark's `complete` (the WAV and the metadata
writes), per scene of the window."""


def read(run):
    recs = [r for r in run.window.records if "complete_s" in r]
    return 1e3 * sum(r["complete_s"] for r in recs) / len(recs) if recs else None
