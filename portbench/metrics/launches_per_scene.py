"""CUDA kernel launches in the profiled loop (the window and its drain),
over the scenes it rendered."""


def read(run):
    n = sum(1 for r in run.window.records if "t_done" in r)
    if run.trace is None or not n:
        return None
    return len(run.trace.kernels) / n
