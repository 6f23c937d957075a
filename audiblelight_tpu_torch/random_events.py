"""Generate scenes with fully random events with the PyTorch/CUDA port.

    python -m audiblelight_tpu_torch.random_events --fg-dir <folder of WAVs> --output-dir <out> \\
        [--n-scenes 1] [--duration 60] [--backend shoebox|rlr|sofa] [--mesh room.obj] \\
        [--sofa room.sofa] [--mic ambeovr] [--n-static 4] [--n-moving 1] [--seed 42] [--device cpu]

The port's counterpart of scripts/generate/generate_with_random_events.py,
with the same flags, defaults, seeding (one `np.random.default_rng(seed)`:
each shoebox scene's room size and world-state seed) and layout: every
parameter left unset samples from the Scene's default distributions, each
scene gets `--n-static` static and `--n-moving` moving events (a failed
placement is logged and skipped) and a gaussian bed, and renders through
`Scene.generate()` into `<output>/scene_<i>/` (audio_out_<mic>.wav,
metadata_out.json, metadata_out_<mic>.csv). As in the reference script,
the global `random` and numpy streams (placement) are not seeded here.
`--device` (default cuda) selects where placement queries, IRs and renders
run; without a card the default raises.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.core import Scene
from audiblelight_tpu_torch.utils import logger


def build_parser() -> argparse.ArgumentParser:
    """The reference script's flags and defaults, plus --device."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--fg-dir", type=str, required=True)
    parser.add_argument("--output-dir", type=str, required=True)
    parser.add_argument("--n-scenes", type=int, default=1)
    parser.add_argument("--duration", type=float, default=config.SCENE_DURATION)
    parser.add_argument("--backend", choices=["shoebox", "rlr", "sofa"], default="shoebox")
    parser.add_argument("--mesh", type=str, default=None)
    parser.add_argument("--sofa", type=str, default=None)
    parser.add_argument("--mic", type=str, default=config.MIC_ARRAY_TYPE)
    parser.add_argument("--n-static", type=int, default=config.DEFAULT_STATIC_EVENTS)
    parser.add_argument("--n-moving", type=int, default=config.DEFAULT_MOVING_EVENTS)
    parser.add_argument("--seed", type=int, default=utils.SEED)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where placement queries, IRs and renders run (cuda, or cpu)")
    return parser


def main(argv: Optional[list] = None) -> list[float]:
    """Run the generator on `argv` (default: the command line). Returns each
    scene's host-clock seconds (placement, render and writes)."""
    args = build_parser().parse_args(argv)
    utils.resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    out_root = Path(args.output_dir)
    out_root.mkdir(parents=True, exist_ok=True)

    seconds = []
    for idx in range(args.n_scenes):
        t0 = time.perf_counter()
        if args.backend == "shoebox":
            backend_kwargs = dict(
                dimensions=rng.uniform([5, 4, 2.6], [10, 8, 3.5]).tolist(),
                seed=int(rng.integers(2**31)),
            )
        elif args.backend == "rlr":
            backend_kwargs = dict(mesh=args.mesh, add_to_context=False)
        else:
            backend_kwargs = dict(sofa=args.sofa)

        scene = Scene(duration=args.duration, backend=args.backend, backend_kwargs=backend_kwargs,
                      fg_path=args.fg_dir, device=args.device)
        scene.add_microphone(microphone_type=args.mic)
        for _ in range(args.n_static):
            try:
                scene.add_event(event_type="static", max_place_attempts=100)
            except (ValueError, FileNotFoundError) as e:
                logger.warning(f"Static placement failed: {e}")
        for _ in range(args.n_moving):
            try:
                scene.add_event(event_type="moving", max_place_attempts=100)
            except (ValueError, FileNotFoundError) as e:
                logger.warning(f"Moving placement failed: {e}")
        scene.add_ambience(noise="gaussian")

        out_dir = out_root / f"scene_{idx:04d}"
        out_dir.mkdir(exist_ok=True)
        scene.generate(output_dir=out_dir)
        seconds.append(time.perf_counter() - t0)
        logger.warning(f"[{idx + 1}/{args.n_scenes}] wrote {out_dir}")
    return seconds


if __name__ == "__main__":
    main()
