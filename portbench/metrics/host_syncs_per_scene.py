"""The points at which the port's host waited for the device (its
`host_syncs` counter: each blocking read to the host and each upload from
pageable memory on the loop's plan path), over the scenes completed in the
profiled loop."""

from portbench.spans import recording, scenes_done


def read(run):
    rec, n = recording(), scenes_done(run)
    if rec is None or not n:
        return None
    return rec.total("host_syncs") / n
