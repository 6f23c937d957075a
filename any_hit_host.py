"""Host time per call of the segment-occlusion wrapper (K2) on one NVIDIA card.

    python3 any_hit_host.py [--root DIR]

Times `audiblelight_tpu_torch.ops.cuda_kernels.segments_occluded` of the
package under DIR (default: beside this script) in the flagship room
(`scanned_like_room((7, 5, 3), seed=0)`: 110,592 faces, a 4,071-face LOD) on
the two small calls of the main path, where the wrapper's host work is most
of the call: the 64 direct-path segments on the full mesh and the per-face
rain table's 4,071 segments on the LOD. Per call by CUDA events (median of
50), its device part from the profiler (chip_smoke.device_ms), and the host
time as their difference. A package whose wrapper takes a cached any-hit
tree (`any_hit_tree`) is timed with one built beforehand; an older one, whose
wrapper builds its face table per call, without. Prints one line per call
and exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("any_hit_host: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import device_ms, time_ms  # the smoke's timers

    sys.path.insert(0, args.root)
    from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
    from audiblelight_tpu_torch.micarrays import ambeovr_capsules
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), seed=0)
    full = torch.as_tensor(mesh.triangles, dtype=torch.float32, device=dev)
    lod_mesh = mesh.simplified(target_faces=4096)
    lod = torch.as_tensor(lod_mesh.triangles, dtype=torch.float32, device=dev)
    caps = torch.as_tensor(ambeovr_capsules((3.5, 2.5, 1.5)), dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.uniform((0.5, 0.5, 0.5), (6.5, 4.5, 2.5), (16, 3)), dtype=torch.float32, device=dev)
    centroids = lod.mean(dim=1)
    normals = torch.as_tensor(lod_mesh.face_normals, dtype=torch.float32, device=dev)
    lpt = caps.mean(dim=0, keepdim=True)
    n_or = torch.where(((normals * (lpt - centroids)).sum(-1) >= 0)[:, None], normals, -normals)
    calls = (("64 direct segments on the full mesh", caps.repeat(16, 1), src.repeat_interleave(4, dim=0), full),
             ("4,071 rain-table segments on the LOD", centroids + 1e-4 * n_or, lpt.expand(len(lod), 3), lod))
    cached = hasattr(ck, "any_hit_tree")
    for label, starts, ends, tris in calls:
        if cached:
            tree = ck.any_hit_tree(tris)
            call = lambda s=starts, e=ends, t=tris, tr=tree: ck.segments_occluded(s, e, t, tr)  # noqa: E731
        else:
            call = lambda s=starts, e=ends, t=tris: ck.segments_occluded(s, e, t)  # noqa: E731
        per_call, device = time_ms(call, reps=50), device_ms(call, reps=50)
        print(f"segments_occluded ({'cached tree' if cached else 'table per call'}), {label}: {per_call:.4f} ms "
              f"per call, device {device:.4f} ms, host {per_call - device:.4f} ms on {torch.cuda.get_device_name(0)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
