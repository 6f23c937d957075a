"""Which torch.distributed collectives take CUDA tensors on this card.

    python3 tools/dist_probe.py

Starts a world of one NCCL rank, then two gloo ranks sharing cuda:0, each a
subprocess with a timeout, and in each rank times `init_process_group`
(host clock) and tries all_reduce (world and a DeviceMesh axis group),
all_gather, broadcast, all_gather_into_tensor and barrier on CUDA tensors,
printing "ok" or the error. Needs one card.
"""

import datetime
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def rank_main(rank: int, world: int, init: str, backend: str) -> None:
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    print(rank, backend, f"init_process_group {(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cuda", (world, 1), mesh_dim_names=("scene", "chan"))
    x = torch.full((4,), float(rank + 1), device=dev)
    ops = [
        ("all_reduce", lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX)),
        ("all_reduce over the scene axis", lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX,
                                                                   group=mesh.get_group("scene"))),
        ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x)),
        ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
        ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(torch.empty(world * 4, device=dev), x)),
        ("barrier", dist.barrier),
    ]
    try:
        for name, op in ops:
            try:
                op()
                torch.cuda.synchronize()
                print(rank, backend, name, "ok", flush=True)
            except (RuntimeError, ValueError) as exc:
                print(rank, backend, name, "failed:", type(exc).__name__, str(exc)[:200], flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
          "nccl", dist.is_nccl_available(), "gloo", dist.is_gloo_available(), flush=True)
    folder = tempfile.mkdtemp()
    rc = 0
    for backend, world in (("nccl", 1), ("gloo", 2)):
        init = f"file://{folder}/{backend}"
        procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), init, backend],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
        try:
            for p in procs:
                print(p.communicate(timeout=120)[0], flush=True)
                rc = rc or p.returncode
        finally:
            for p in procs:
                p.kill()
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
