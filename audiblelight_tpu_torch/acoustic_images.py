"""Generate APGD acoustic images and their segmentation labels for rendered
scenes with the PyTorch/CUDA port.

    python -m audiblelight_tpu_torch.acoustic_images --fg-dir <folder of WAVs> --output-dir <out> \\
        [--n-scenes 5] [--duration 10] [--max-events 3] [--nbands 9] [--sh-order 10] \\
        [--frame-cap N] [--seed 42] [--device cpu]

The port's counterpart of scripts/imaging/generate_acoustic_images.py, with
the same flags, defaults, seeding (one `np.random.default_rng(seed)`, drawn
in the script's order: each scene's room size, absorption, world-state seed
and event count) and layout: per scene a shoebox room of random size (image
sources to order 8, 0.3 s IRs) with an Eigenmike32 (32 capsules: APGD wants
many), 1 to `--max-events` static events, rendered through
`Scene.generate()` and imaged by `Scene.generate_acoustic_image()`:

    <output>/scene_<i>/audio_out_mic000.wav, metadata_out.json, metadata_out_mic000.csv
    <output>/scene_<i>/acoustic_image_mic000.hdf, acoustic_image_metadata_mic000.json

Scenes whose HDF exists are skipped. As in the reference script, the global
`random` and numpy streams (placement) are not seeded here. `--device`
(default cuda) selects where placement queries, the image sources, the
render and the APGD solve run; without a card the default raises.
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


def generate_scene_with_image(args, idx: int, rng: np.random.Generator) -> Optional[Scene]:
    """One scene's audio, metadata and acoustic image; None when skipped."""
    out_dir = Path(args.output_dir) / f"scene_{idx:04d}"
    if (out_dir / "acoustic_image_mic000.hdf").is_file():
        logger.info(f"Skipping existing scene {idx}")
        return None
    out_dir.mkdir(parents=True, exist_ok=True)

    dims = rng.uniform([5.0, 4.0, 2.6], [9.0, 7.0, 3.4])
    scene = Scene(
        duration=args.duration,
        backend="shoebox",
        backend_kwargs=dict(
            dimensions=dims.tolist(),
            absorption=float(rng.uniform(0.3, 0.7)),
            max_order=8,
            max_ir_length=0.3,
            seed=int(rng.integers(2**31)),
        ),
        fg_path=args.fg_dir,
        class_mapping="DCASE2023Task3",
        device=args.device,
    )
    scene.add_microphone(microphone_type="eigenmike32")

    for _ in range(int(rng.integers(1, args.max_events + 1))):
        try:
            scene.add_event(event_type="static", max_place_attempts=100)
        except (ValueError, FileNotFoundError) as e:
            logger.warning(f"Could not place event: {e}")
    if len(scene.events) == 0:
        logger.warning(f"No events placed for scene {idx}; skipping")
        return None

    scene.generate(output_dir=out_dir, audio=True, metadata_json=True, metadata_dcase=True)
    scene.generate_acoustic_image(output_dir=out_dir, nbands=args.nbands, sh_order=args.sh_order,
                                  frame_cap=args.frame_cap)
    return scene


def build_parser() -> argparse.ArgumentParser:
    """The reference script's flags and defaults, plus --device."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--fg-dir", type=str, required=True)
    parser.add_argument("--output-dir", type=str, required=True)
    parser.add_argument("--n-scenes", type=int, default=5)
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--max-events", type=int, default=3)
    parser.add_argument("--nbands", type=int, default=config.AIMG_NBANDS)
    parser.add_argument("--sh-order", type=int, default=config.AIMG_SH_ORDER)
    parser.add_argument("--frame-cap", type=int, default=config.AIMG_FRAME_CAP)
    parser.add_argument("--seed", type=int, default=utils.SEED)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where placement queries, image sources, renders and the APGD solve run (cuda, or cpu)")
    return parser


def main(argv: Optional[list] = None) -> list[float]:
    """Run the generator on `argv` (default: the command line). Returns each
    imaged scene's host-clock seconds (placement, render, image, writes)."""
    args = build_parser().parse_args(argv)
    utils.resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    seconds = []
    for idx in range(args.n_scenes):
        logger.warning(f"[{idx + 1}/{args.n_scenes}] generating acoustic image scene")
        t0 = time.perf_counter()
        if generate_scene_with_image(args, idx, rng) is not None:
            seconds.append(time.perf_counter() - t0)
    return seconds


if __name__ == "__main__":
    main()
