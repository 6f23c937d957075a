"""The rlr backend's settings, as the SELD CLI's `build_backend_kwargs`
gives them: the room's mesh, no material, the world state kept out of the
scene's context, the configuration's tracer settings and the scene's seed.

One TriMesh a mesh name in a process, as the CLI keeps one a mesh file, so
that the world states of all scenes share its level of detail, trees and
rain tables."""

import functools


@functools.lru_cache(maxsize=None)
def mesh(name: str):
    """The port's TriMesh of `meshes/<name>.npz`."""
    from audiblelight_tpu_torch.geometry.mesh import TriMesh

    from portbench import manifest

    path = manifest.HERE / "meshes" / f"{name}.npz"
    return TriMesh(*manifest.load_mesh(name), metadata=dict(fname=name, ftype=".npz", fpath=str(path)))


def backend_kwargs(config: dict, spec: dict) -> dict:
    eng = config["engine"]
    rlr_kwargs = {k: eng[k] for k in ("max_ir_length", "mesh_simplification", "ray_decimation", "diffraction")}
    rlr_kwargs.update({k: eng[k] for k in ("indirect_ray_count", "indirect_ray_depth") if k in eng})
    return dict(mesh=mesh(spec["room"]["mesh"]), material=None, add_to_context=False, rlr_kwargs=rlr_kwargs,
                seed=spec["state_seed"])
