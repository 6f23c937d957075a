"""Host time per call of the tracer's small-call wrappers on one NVIDIA card.

    python3 wrapper_host.py [--root DIR]

Times the wrappers of `audiblelight_tpu_torch.ops.cuda_kernels` of the
package under DIR (default: beside this script) at the flagship shapes of
the main path, where the wrapper's host work is much of the call, in the
flagship room (`scanned_like_room((7, 5, 3), seed=0)`: 110,592 faces, a
4,071-face LOD):

- `segments_occluded` (K2) on the 64 direct-path segments on the full mesh
  and the per-face rain table's 4,071 segments on the LOD;
- `deposit_histogram` (K3) on one bounce of 16 sources x 5,000 rays hitting
  the LOD, at the AmbeoVR's 4 capsules, and `deposit_histogram_foa` (K4) on
  the same bounce at the rig's centre and on the FOA scene's 8 sources x
  5,000, 2,500 and 1,250 rays (its decimation phases), arrivals spread over
  300 m of path;
- `bin_histogram` (K5) at the HOA3 (16 x 5,000 x 64) and binaural (x 8)
  flagship bounce.

Per call by CUDA events (median of 50), its device part from the profiler
(chip_smoke.device_ms) and their difference; the time per call of 50
calls back to back by the host clock before the device is synchronised, the
least and the median of 10 such rounds (the host's time per call where the
device keeps up, as it does for K3-K5; K2's calls take longer on the
device); and a sha256 of the output's bytes (two
packages whose kernels sum in the same order give the same hash). A package whose any-hit wrapper takes a cached tree
(`any_hit_tree`) is timed with one built beforehand; an older one, whose
wrapper builds its face table per call, without. The inputs are made on the
card from fixed seeds, the same for every package. Prints one line per call
and exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("wrapper_host: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import device_ms, time_ms  # the smoke's timers

    sys.path.insert(0, args.root)
    from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
    from audiblelight_tpu_torch.micarrays import ambeovr_capsules
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
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

    def report(label: str, call) -> None:
        out = call()
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        per_call, device = time_ms(call, reps=50), device_ms(call, reps=50)
        # The host's own time per call: rounds of 50 calls back to back by
        # the host clock, before the sync (the device keeps up where it is
        # faster); the least round, as other work on a shared host only adds
        rounds = []
        for _ in range(10):
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            rounds.append((time.perf_counter() - t0) / 50 * 1e3)
            torch.cuda.synchronize()
        print(f"{label}: {per_call:.4f} ms per call, device {device:.4f} ms, per call - device {per_call - device:.4f} "
              f"ms; back to back {min(rounds):.4f} ms per call (least of 10 rounds of 50 calls, median "
              f"{float(np.median(rounds)):.4f}); output sha256 {digest} on {card}", flush=True)

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
        report(f"segments_occluded ({'cached tree' if cached else 'table per call'}), {label}", call)

    # One bounce: 5,000 rays a source from the 16 sources, their first hits
    # on the LOD, incoming-facing normals, random energies and path lengths
    gen = torch.Generator(device=dev).manual_seed(1)
    origins = src.repeat_interleave(5000, dim=0)
    dirs = torch.randn(origins.shape, generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    t, face = ck.ray_first_hit(origins, dirs, lod)
    ok = torch.isfinite(t)
    hit = origins + torch.where(ok, t, 0.0)[:, None] * dirs
    nrm = normals[face.clamp_min(0).long()]
    nrm = torch.where(((nrm * dirs).sum(-1) > 0)[:, None], -nrm, nrm)
    e_refl = torch.rand(80000, 4, generator=gen, device=dev) * 2e-4
    dist = torch.where(ok, t, 0.0) + 300.0 * torch.rand(80000, generator=gen, device=dev)
    seen = torch.rand(4, 80000, generator=gen, device=dev) < 0.7
    kw = dict(n_bins=501, bin_dt=0.002, c_sound=343.0)
    occ = (~seen | ~ok[None]).contiguous()
    bounce = [x.contiguous() for x in (hit, nrm, e_refl, dist)]
    report("deposit_histogram, 16 sources x 5,000 rays x 4 capsules",
           lambda: ck.deposit_histogram(*bounce, occ, caps, n_sources=16, **kw))
    centre = caps.mean(dim=0, keepdim=True)
    for n_src, rays in ((16, 5000), (8, 5000), (8, 2500), (8, 1250)):
        part = [x.view(16, 5000, -1)[:n_src, :rays].reshape(n_src * rays, -1).squeeze(-1).contiguous()
                for x in (*bounce, occ[0])]
        occ1 = part.pop().reshape(1, -1)
        report(f"deposit_histogram_foa, {n_src} sources x {rays:,} rays",
               lambda part=part, occ1=occ1, n_src=n_src: ck.deposit_histogram_foa(*part, occ1, centre,
                                                                                  n_sources=n_src, **kw))
    d_c = (centre - hit).norm(dim=1)
    bins = ((dist + d_c) / 343.0 / 0.002).to(torch.int32).reshape(16, 5000)
    bins = torch.where(bins < 501, bins, -1).contiguous()
    for label, k in (("hoa3", 64), ("binaural", 8)):
        dep = torch.rand(16, 5000, k, generator=gen, device=dev) * 1e-6
        report(f"bin_histogram {label}, (16, 5000, {k})", lambda dep=dep: ck.bin_histogram(bins, dep, 501))
    return 0


if __name__ == "__main__":
    sys.exit(main())
