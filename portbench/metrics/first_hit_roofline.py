"""K1's share of its roofline: the bytes its work needs (each ray handed
to the first hit, the port's `trace.rays` counter, read once and its hit
written once; the acoustic LOD's faces read once a launch;
`tracer_counts.first_hit_bytes`) at the card's bandwidth, over the device
time of its launches in the trace."""

from portbench.reference.rlr import LOD_FACES
from portbench.tracer_counts import first_hit_bytes, mesh_faces
from portbench.tracer_spans import roofline


def read(run):
    room = run.config.get("room", {})
    if "mesh" not in room:
        return None
    lod_faces = mesh_faces(room["mesh"], LOD_FACES)[1]
    return roofline(run, "first_hit", lambda rec, launches: first_hit_bytes(rec.total("trace.rays"), launches,
                                                                            lod_faces))
