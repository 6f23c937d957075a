"""K2's share of its roofline: the bytes its segment queries need (each
segment read once and its flag written once, each face of the mesh it is
tested against read once a query; `tracer_counts.any_hit_bytes`): a
rain table's LOD faces toward the rig (one a `trace.rain` span), and each
scene's direct paths, diffraction trigger and diffraction legs, at the
card's bandwidth, over the device time of its launches in the trace."""

from portbench.reference.rlr import LOD_FACES, MAX_DIFFRACTION_ORDER, bucket
from portbench.tracer_counts import any_hit_bytes, any_hit_queries, mesh_faces
from portbench.tracer_spans import roofline, spans_named


def read(run):
    room, eng, rig = run.config.get("room", {}), run.config["engine"], run.config["rig"]
    if "mesh" not in room:
        return None
    faces, lod_faces = mesh_faces(room["mesh"], LOD_FACES)
    order = MAX_DIFFRACTION_ORDER if eng["diffraction"] else 0
    done = [r for r in run.window.records if "t_done" in r]

    def nbytes(rec, launches):
        queries = [(lod_faces, lod_faces)] * len(spans_named(rec, "trace.rain"))
        for r in done:
            q = any_hit_queries(bucket(run.emitters[r["index"]]), len(rig["capsules"]), faces, lod_faces, order)
            queries += q if order else q[:1]
        return any_hit_bytes(queries)

    return roofline(run, "any_hit", nbytes)
