"""Seconds per Scene-API scene with the PyTorch/CUDA port.

    python -m audiblelight_tpu_torch.scene_timing [--n-scenes 1000] [--duration 60] \\
        [--fg-dir <folder>] [--output-dir <out>] [--seed 42] [--device cpu]

The port's counterpart of scripts/generate/benchmark.py, with the same
flags, defaults, seeding and output: N shoebox scenes of random size (from
`np.random.default_rng(seed)`), each with an AmbeoVR, 1-10 static and 0-6
moving events (a failed placement skipped) and a gaussian bed, rendered
through `Scene.generate()` into `<out>/scene_<i>/`; a scene whose WAV exists
is skipped. Without `--fg-dir` a synthetic pool of six 4 s clips in DCASE2023
class folders is written under `<out>/pool`. It prints

    total_seconds=... avg_seconds_per_scene=...

by the host clock, placement to last write. `--device` (default cuda)
selects where placement queries, IRs and renders run; without a card the
default raises.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.core import Scene
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.utils import logger


def make_pool(pool_dir: Path, sr: int, n: int = 6) -> None:
    """Synthetic clips in DCASE2023 class folders, so metadata generation works."""
    classes = ["music", "maleSpeech", "femaleSpeech", "bell", "knock", "telephone"]
    rng = np.random.default_rng(0)
    t = np.arange(sr * 4) / sr
    for i in range(n):
        d = pool_dir / classes[i % len(classes)]
        d.mkdir(exist_ok=True)
        sig = 0.5 * np.sin(2 * np.pi * 300 * (i + 1) * t) * np.exp(-t * 0.5)
        sig += 0.02 * rng.standard_normal(len(t))
        wav_write(d / f"ev_{i}.wav", sig.astype(np.float32), sr, subtype="float32")


def build_parser() -> argparse.ArgumentParser:
    """The reference script's flags and defaults, plus --device."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--n-scenes", type=int, default=config.N_SCENES)
    parser.add_argument("--duration", type=float, default=config.SCENE_DURATION)
    parser.add_argument("--fg-dir", type=str, default=None)
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument("--seed", type=int, default=utils.SEED)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where placement queries, IRs and renders run (cuda, or cpu)")
    return parser


def main(argv: Optional[list] = None) -> tuple:
    """Run on `argv` (default: the command line). Returns (total seconds,
    scenes written)."""
    args = build_parser().parse_args(argv)
    utils.resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    out_root = Path(args.output_dir or tempfile.mkdtemp(prefix="al_benchmark_"))
    out_root.mkdir(parents=True, exist_ok=True)

    fg = Path(args.fg_dir) if args.fg_dir else out_root / "pool"
    if args.fg_dir is None:
        fg.mkdir(exist_ok=True)
        make_pool(fg, 44100)

    start = time.time()
    done = 0
    for idx in range(args.n_scenes):
        out_dir = out_root / f"scene_{idx:05d}"
        if (out_dir / "audio_out_mic000.wav").is_file():
            continue  # resume, as the reference does
        out_dir.mkdir(exist_ok=True)

        scene = Scene(
            duration=args.duration,
            backend="shoebox",
            backend_kwargs=dict(
                dimensions=rng.uniform([5, 4, 2.6], [10, 8, 3.5]).tolist(),
                seed=int(rng.integers(2**31)),
            ),
            fg_path=fg,
            device=args.device,
        )
        scene.add_microphone(microphone_type=config.MIC_ARRAY_TYPE)
        n_static = int(rng.integers(config.MIN_STATIC_EVENTS, config.MAX_STATIC_EVENTS + 1))
        n_moving = int(rng.integers(config.MIN_MOVING_EVENTS, config.MAX_MOVING_EVENTS + 1))
        for _ in range(n_static):
            try:
                scene.add_event(event_type="static", max_place_attempts=50)
            except (ValueError, FileNotFoundError):
                pass
        for _ in range(n_moving):
            try:
                scene.add_event(
                    event_type="moving",
                    shape=str(rng.choice(config.MOVING_EVENT_SHAPES)),
                    max_place_attempts=50,
                )
            except (ValueError, FileNotFoundError):
                pass
        scene.add_ambience(noise="gaussian")
        scene.generate(output_dir=out_dir)
        done += 1

    total = time.time() - start
    logger.warning(f"Generated {done} scenes in {total:.1f}s ({total / max(done, 1):.2f}s/scene)")
    print(f"total_seconds={total:.2f} avg_seconds_per_scene={total / max(done, 1):.3f}")
    return total, done


if __name__ == "__main__":
    main()
