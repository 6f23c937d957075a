"""One minus the union of the device's busy intervals (kernels, copies,
sets) from torch.profiler, over the profiled loop's wall time."""


def read(run):
    if run.trace is None or not run.trace.events:
        return None
    wall = run.window.end - run.window.start
    return 100.0 * (1.0 - 1e-9 * run.trace.busy_ns() / wall)
