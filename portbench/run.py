"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up makes the run's inputs from the seed
(the dry clips and a ring of scene descriptions), builds each scene of the
ring through the port's Scene API, and warms the loop; the window then
drives the SELD CLI's dispatch-ahead loop over new scenes (the ring's, then
any further ones built as the loop asks) for `--seconds` and drains it. With `--trace 0` the result line carries the cell's
end-to-end metrics; with `--trace 1` the window runs under torch.profiler
and the line carries the per-layer metrics. Either way a sample of the
window's scenes drawn from the seed is held to the plain reference once the
window has closed (`check.py`: each number that the backend's reference
reports, against the configuration's limit for it), and the last line of
standard output is the result, its `check` last: each number compared
beside its limit, and the scenes checked.

A configuration's room is a shoebox drawn per scene or a mesh of
`meshes/`, the same in every scene (`traffic.py`); `backends/<backend>.py`
gives the port's Scene its settings for either.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "audiblelight_tpu")
CACHE = Path(".portbench_cache")
# The host's thread pools (PyTorch's and the BLAS's) at two threads: the
# loop is paced by one Python thread, and a run's load on the host stays
# fixed and small whatever cores the machine has
HOST_THREADS = "2"


def process_start() -> float:
    """This process's start, seconds since the epoch (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def build_inputs(config: dict, mix: dict, seed: int, work: Path):
    """(clips, clip paths, the ring's scene descriptions)."""
    from portbench import traffic
    from portbench.program import write_clip

    sr = int(config["sample_rate"])
    clips = traffic.clips(mix, sr, seed)
    paths = []
    for i, c in enumerate(clips):
        paths.append(work / f"clip{i:02d}.wav")
        write_clip(paths[-1], c, sr)
    return clips, paths, traffic.ring(config, mix, seed)


def emitters(spec: dict) -> int:
    """A scene's emitters: one a static event, one a trajectory point."""
    return sum(len(e["trajectory"]) if e["moving"] else 1 for e in spec["events"])


def run_cell(workload: str, seed: int, seconds: float, trace: bool, root: Path, device: str = "cuda",
             config_overrides: dict = None, mix_overrides: dict = None) -> dict:
    """One run of `workload`; returns the result object. `device` "cpu" and
    the overrides are for the tests: the CLI runs on the card, at the
    configuration's and the mix's own sizes."""
    import torch

    from portbench import check, manifest
    from portbench.program import Window, build_scene
    from portbench.trace import DeviceTrace

    t_proc = process_start()
    man = manifest.load_manifest(root)
    cell = manifest.cell(man, workload)
    config = manifest.load_config(cell["config"])
    config.update(config_overrides or {})
    config["device"] = device
    mix = dict(manifest.load_mix(cell["traffic"]), **(mix_overrides or {}))
    on_card = device == "cuda"

    work = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
    marks = [("start", time.time() - t_proc)]
    try:
        if on_card:
            from audiblelight_tpu_torch.ops import build

            build.build_all()
        marks.append(("imports and kernels", time.time() - t_proc))
        clips, clip_paths, specs = build_inputs(config, mix, seed, work)
        marks.append(("inputs", time.time() - t_proc))
        place_s, ring = [], []
        for spec in specs:
            t0 = time.perf_counter()
            ring.append((spec, build_scene(config, spec, [str(p) for p in clip_paths])))
            place_s.append(time.perf_counter() - t0)
        marks.append(("placement", time.time() - t_proc))
        sampler = check.Sampler(config["check"]["sample"], seed)
        window = Window(config, mix, seed, [str(p) for p in clip_paths], ring, work / "out", sampler)
        del ring
        warm = int(config["pipeline"]["warm_scenes"])

        prof = None
        if trace and on_card:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        window.run(seconds, warm=warm, around=prof)
        if on_card:
            torch.cuda.synchronize()
        window_close = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() if on_card else None
        dtrace = DeviceTrace.from_profiler(prof) if prof is not None else None
        t_trace = time.perf_counter() - window.end
        setup_s = (window.start - window_close) + time.time() - t_proc
        # What the metric readers read
        run = SimpleNamespace(config=config, window=window, inside=window.inside(), place_s=place_s, trace=dtrace,
                              peak_bytes=peak, emitters={i: emitters(sp) for i, sp in window.specs.items()})

        # The program's state goes before the reference runs
        window.ring = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        numbers = check.compare(config, window.specs, clips, sampler.kept, device)
        marks.append(("warm-up", setup_s))
        steps = ", ".join(f"{name} {b - a:.1f}" for (_, a), (name, b) in zip(marks, marks[1:]))
        print(f"portbench: set-up {setup_s:.1f} s ({steps}), window {window.end - window.start:.1f} s, "
              f"trace {t_trace:.1f} s, reference {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    inside = run.inside
    if not inside:
        raise RuntimeError("no scene completed inside the window")
    correct, checked = check.judge(config["check"], numbers)
    if trace:
        metrics = {}
        for m in manifest.metrics_for(man, workload, "per_layer"):
            value = manifest.reader(m["name"])(run)
            if isinstance(value, tuple):  # (value, count)
                metrics[m["name"]] = dict(value=float(value[0]), unit=m["unit"], count=int(value[1]))
            elif value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    else:
        t_last = max(r["t_done"] for r in inside)
        metrics = dict(
            audio_s_per_s=dict(value=len(inside) * config["duration_s"] / (t_last - window.start), unit="s/s"),
            setup_s=dict(value=setup_s, unit="s"),
        )
    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                       count=int(cell["chips"]), memory_peak_bytes=int(peak or 0))
    result = dict(correct=bool(correct), attempted=len(window.records),
                  failed=len(window.records) - sum(1 for r in window.records if "t_done" in r),
                  metrics=metrics, device=device_info)
    if dtrace is not None:
        device_info.update(busy_s=dtrace.busy_ns() * 1e-9, window_s=window.end - window.start)
        result["breakdown"] = dtrace.breakdown()
    result["check"] = checked
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    cache = (root / CACHE).resolve()
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["OMP_NUM_THREADS"] = HOST_THREADS

    import torch

    from portbench import manifest

    chips = int(manifest.cell(manifest.load_manifest(root), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), root)
    print(f"portbench: {time.perf_counter() - t0:.1f} s from the harness's start to the result", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of {', '.join(bad)} were loaded in this process", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
