"""Generate a DCASE2025-Task4-style spatial semantic segmentation dataset with
the PyTorch/CUDA port.

    python -m audiblelight_tpu_torch.ssseg --fg-dir <folder of WAVs> --output-dir <out> \\
        [--n-scenes 10] [--ism-order 10] [--duration 10] [--seed 42] [--device cpu]

The port's counterpart of scripts/ssseg/generate_dataset.py, with the same
flags, defaults, seeding (one `np.random.default_rng(seed)`, drawn in the
script's order: each scene's room size, absorption and world-state seed,
then its event count) and file layout: 10 s FOA ("foalistener") scenes at
32 kHz in a shoebox room of random size (image sources to order 10, 0.5 s
IRs), 1-3 static events with dry-stem parameters (reference channel 0, the
direct path window [5, 50] ms) and a gaussian bed, rendered through the
classic per-event render (`Scene.generate()`), written as

    <output>/mixtures/scene_<i>_mic000.wav   (int16)
    <output>/mixtures/scene_<i>.json, scene_<i>_mic000.csv
    <output>/stems/scene_<i>/<alias>_<class label>_mic000_dry.wav   (float32)

Scenes whose mixture exists are skipped. As in the reference script, the
global `random` and numpy streams (placement) are not seeded here.
`--device` (default cuda) selects where the placement queries, the image
sources and the render run; without a card the default raises.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np

from audiblelight_tpu_torch import utils
from audiblelight_tpu_torch.core import Scene
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.utils import logger

DURATION = 10.0
SAMPLE_RATE = 32000
MAX_POLYPHONY = 3


def generate_scene(args, idx: int, rng: np.random.Generator) -> Optional[Scene]:
    """One scene: the FOA mixture, its metadata and a dry stem per event.
    Returns the rendered Scene, or None when it was skipped."""
    out_root = Path(args.output_dir)
    mix_path = out_root / "mixtures" / f"scene_{idx:05d}"
    stem_dir = out_root / "stems" / f"scene_{idx:05d}"
    if (mix_path.parent / f"{mix_path.name}_mic000.wav").is_file():
        logger.info(f"Skipping existing scene {idx}")
        return None
    mix_path.parent.mkdir(parents=True, exist_ok=True)
    stem_dir.mkdir(parents=True, exist_ok=True)

    dims = rng.uniform([4.0, 3.5, 2.5], [9.0, 7.0, 3.4])
    scene = Scene(
        duration=args.duration,
        sample_rate=SAMPLE_RATE,
        backend="shoebox",
        backend_kwargs=dict(
            dimensions=dims.tolist(),
            absorption=float(rng.uniform(0.2, 0.6)),
            max_order=args.ism_order,
            max_ir_length=0.5,
            seed=int(rng.integers(2**31)),
        ),
        fg_path=args.fg_dir,
        max_overlap=MAX_POLYPHONY,
        class_mapping="DCASE2025Task4",
        device=args.device,
    )
    scene.add_microphone(microphone_type="foalistener")

    n_events = int(rng.integers(1, MAX_POLYPHONY + 1))
    for _ in range(n_events):
        try:
            scene.add_event(event_type="static", max_place_attempts=100, ref_ir_channel=0,
                            direct_path_time_ms=(5, 50))
        except (ValueError, FileNotFoundError) as e:
            logger.warning(f"Could not place event: {e}")

    if len(scene.events) == 0:
        logger.warning(f"No events placed for scene {idx}; skipping")
        return None

    scene.add_ambience(noise="gaussian")
    scene.generate(output_dir=mix_path.parent, audio=True, metadata_json=True, metadata_dcase=True,
                   audio_fname=mix_path.name, metadata_fname=mix_path.name)

    # The dry stems were computed during the render: one float32 WAV per event
    for alias, event in scene.events.items():
        for mic_alias, dry in event._spatial_audio_dry_padded.items():
            wav_write(stem_dir / f"{alias}_{event.class_label}_{mic_alias}_dry.wav", dry.astype(np.float32),
                      SAMPLE_RATE, subtype="float32")
    return scene


def build_parser() -> argparse.ArgumentParser:
    """The reference script's flags and defaults, plus --device."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--fg-dir", type=str, required=True)
    parser.add_argument("--output-dir", type=str, required=True)
    parser.add_argument("--n-scenes", type=int, default=10)
    parser.add_argument("--ism-order", type=int, default=10)
    parser.add_argument("--duration", type=float, default=DURATION)
    parser.add_argument("--seed", type=int, default=utils.SEED)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where placement queries, image sources and renders run (cuda, or cpu)")
    return parser


def main(argv: Optional[list] = None) -> list[float]:
    """Run the generator on `argv` (default: the command line). Returns each
    written scene's host-clock seconds, placement included."""
    args = build_parser().parse_args(argv)
    utils.resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    seconds = []
    for idx in range(args.n_scenes):
        logger.warning(f"[{idx + 1}/{args.n_scenes}] generating ssseg scene")
        t0 = time.perf_counter()
        if generate_scene(args, idx, rng) is not None:
            seconds.append(time.perf_counter() - t0)
    return seconds


if __name__ == "__main__":
    main()
