"""The image-source engine's share of its roofline, over its own device
time: 30 fp32 operations per (listener, emitter, image, bin) term
(`counts.ism_terms`) of each rendered scene, over 67 TFLOP/s, divided by the
device's busy time between the marker pairs the port puts on the stream at
each end of an engine call (`spans.engine_busy_ns`). `ism_roofline` holds the
same operations against all busy time."""

from portbench.counts import ISM_FLOPS_PER_TERM, PEAK_FP32, ism_terms
from portbench.spans import engine_busy_ns, recording


def read(run):
    done = [r for r in run.window.records if "t_done" in r]
    rec = recording()
    if rec is None or run.trace is None or not done:
        return None
    busy = engine_busy_ns(rec, run.trace)
    if not busy:
        return None
    eng, rig = run.config["engine"], run.config["rig"]
    rows = len(rig["capsules"]) if rig["encoding"] == "omni" else 1
    n_samples = round(eng["max_ir_length"] * run.config["sample_rate"])
    terms = sum(ism_terms(rows, run.emitters[r["index"]], n_samples, eng["max_order"]) for r in done)
    return 100.0 * (ISM_FLOPS_PER_TERM * terms / PEAK_FP32) / (1e-9 * busy)
