"""The image-source engine's share of its roofline, a lower bound: 30 fp32
operations per (listener, emitter, image, bin) term (`counts.ism_terms`) of
each rendered scene, over 67 TFLOP/s, divided by the device's busy time in
the profiled loop (which also holds the stems' device time). The engine
evaluates one listener row for an encoded rig and one per capsule for an
omni rig (the configuration's `rig`)."""

from portbench.counts import ISM_FLOPS_PER_TERM, PEAK_FP32, ism_terms


def read(run):
    done = [r for r in run.window.records if "t_done" in r]
    if run.trace is None or not done:
        return None
    eng, rig = run.config["engine"], run.config["rig"]
    rows = len(rig["capsules"]) if rig["encoding"] == "omni" else 1
    n_samples = round(eng["max_ir_length"] * run.config["sample_rate"])
    terms = sum(ism_terms(rows, run.emitters[r["index"]], n_samples, eng["max_order"]) for r in done)
    busy = 1e-9 * run.trace.busy_ns()
    return 100.0 * (ISM_FLOPS_PER_TERM * terms / PEAK_FP32) / busy if busy else None
