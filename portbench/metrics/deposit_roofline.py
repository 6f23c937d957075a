"""K3's share of its roofline: the bytes its work needs (each ray's hit,
normal, band energies, path and capsule flags read once, each source's
histogram increment written once a launch; `tracer_counts.deposit_bytes`,
the rays from the port's `trace.rays` counter) at the card's bandwidth,
over the device time of its launches in the trace."""

import math

from portbench.reference.rlr import BANDS, HIST_BIN_DT
from portbench.tracer_counts import deposit_bytes
from portbench.tracer_spans import roofline


def read(run):
    eng, rig = run.config["engine"], run.config["rig"]
    if rig["encoding"] != "omni" or "indirect_ray_count" not in eng:
        return None
    n_bins = math.ceil(float(eng["max_ir_length"]) / HIST_BIN_DT) + 1
    return roofline(run, "deposit", lambda rec, launches: deposit_bytes(
        rec.total("trace.rays"), launches, int(eng["indirect_ray_count"]), len(rig["capsules"]),
        BANDS, n_bins))
