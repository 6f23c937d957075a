"""One rank of the 2-rank gloo group of tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py <rank> <world> <init URL> <folder>

Reads <folder>/inputs.npz and <folder>/job.json (written by the test), runs
every `audiblelight_tpu_torch.parallel` function and the fused renderer's
sharded methods on this rank, and writes what the rank got to
<folder>/rank<rank>.npz and <folder>/rank<rank>.json. Imports the port only.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from audiblelight_tpu_torch import parallel as par
from audiblelight_tpu_torch.render import ScenePlan

PLAN_FIELDS = par._PLAN_FIELDS + ["n_scene_samples"]


def plans_from(inputs, prefix: str, n: int) -> list:
    return [ScenePlan.from_numpy({f: inputs[f"{prefix}{i}_{f}"] for f in PLAN_FIELDS}, "cpu") for i in range(n)]


def error_of(fn) -> str:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def fused(job: dict, mesh, out: dict, errors: dict) -> None:
    """The pooled driver's renderer over the job's scenes: render_mix_batch_sharded
    and render_batch_sharded of the first two, render_prepped_scenes over all
    three with the mesh (batches of two)."""
    from audiblelight_tpu_torch import seld, utils
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer
    from audiblelight_tpu_torch.prep import render_prepped_scenes
    from audiblelight_tpu_torch.render import build_scene_plan

    args = seld.build_parser().parse_args(job["argv"])
    jobs = [tuple(j) for j in job["jobs"]]
    pk = seld.plan_kwargs(args)
    prep = seld.make_pooled_prep(vars(args), jobs, pk)
    prepped = [prep(i, seed) for i, seed in enumerate(job["seeds"])]
    utils.seed_everything(job["seeds"][0] % (2**31))
    template = seld.build_scene(args, *jobs[0], np.random.default_rng(job["seeds"][0]))[0]
    plan = build_scene_plan(template, **pk)
    renderers = {}

    def renderer_for(bucket):
        return renderers.setdefault(bucket, FusedSceneRenderer.from_scene(template, plan, bucket))

    r = renderer_for(prepped[0].bucket_sources)
    inputs = [(p.inputs[0], p.inputs[1], p.inputs[2], p.face_occ, p.inputs[3], p.inputs[4]) for p in prepped[:2]]
    plans, extras = [p.plan for p in prepped[:2]], [p.amb for p in prepped[:2]]
    out["mix_sharded"] = r.render_mix_batch_sharded(inputs, plans, extras, mesh).numpy()
    q, scales = r.render_batch_sharded(inputs, plans, mesh)
    out["stems_sharded"], out["scales_sharded"] = q.numpy(), scales.numpy()
    errors["mix_sharded"] = error_of(lambda: r.render_mix_batch_sharded(inputs[:1], plans[:1], extras[:1], mesh))
    errors["stems_sharded"] = error_of(lambda: r.render_batch_sharded(inputs[:1], plans[:1], mesh))
    done = {}
    render_prepped_scenes(renderer_for, iter(prepped), lambda p, wav: done.setdefault(p.index, wav), fused_batch=2,
                          mesh=mesh)
    for index, wav in done.items():
        out[f"prepped_{index}"] = wav


def main(rank: int, world: int, init: str, folder: Path) -> None:
    torch.set_num_threads(1)
    inputs = dict(np.load(folder / "inputs.npz"))
    job = json.loads((folder / "job.json").read_text())
    n = par.init_distributed(init, world, rank, timeout=120)
    errors = {"init_twice": par.init_distributed(init, world, rank) == n == world,
              "backend": dist.get_backend()}
    try:
        errors["bad_mesh"] = error_of(lambda: par.make_mesh(n_scene=world + 1, n_chan=1))
        mesh = par.make_mesh()
        mesh_chan = par.make_mesh(n_scene=1, n_chan=world)
        plans = plans_from(inputs, "plan", int(inputs["n_plans"]))
        batched = par.stack_plans(plans)
        out = {
            "render": par.shard_render(batched, mesh).numpy(),
            "render_chan": par.shard_render(batched, mesh_chan).numpy(),
            "render_norm": par.shard_render(batched, mesh, normalize=True).numpy(),
            "ragged": par.shard_render(par.stack_plans(plans_from(inputs, "ragged", 2), pad=True), mesh).numpy(),
        }
        errors["render_divisible"] = error_of(lambda: par.shard_render(par.stack_plans(plans[:1]), mesh))
        audio, irs = torch.from_numpy(inputs["audio"]), torch.from_numpy(inputs["irs"])
        out["conv"] = par.shard_convolve_time(audio, irs, mesh).numpy()
        errors["conv_halo"] = error_of(lambda: par.shard_convolve_time(torch.zeros(world * 64), torch.zeros(2, 256),
                                                                       mesh))
        errors["conv_divide"] = error_of(lambda: par.shard_convolve_time(torch.zeros(world * 64 + 1),
                                                                         torch.zeros(2, 16), mesh))
        geo = [torch.from_numpy(inputs[k]) for k in ("tris", "absorption", "scattering", "sources", "listener")]
        kw = json.loads(str(inputs["trace_kwargs"]))
        out["trace"] = par.shard_trace_rirs(mesh, int(inputs["trace_seed"]), *geo, **kw).numpy()
        errors["trace_divisible"] = error_of(
            lambda: par.shard_trace_rirs(mesh, 0, geo[0], geo[1], geo[2], geo[3][:3], geo[4], **kw))
        fused(job, mesh, out, errors)
        np.savez(folder / f"rank{rank}.npz", **out)
        (folder / f"rank{rank}.json").write_text(json.dumps(errors))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
