"""Convert generated scene outputs into the DCASE dataset layout.

    python -m audiblelight_tpu_torch.dcase_format --input-dir <scenes> --output-dir <out> \\
        [--fmt mic|foa] [--split train|test] [--room 1] [--device cpu]

The port's counterpart of scripts/generate/convert_to_dcase_format.py, with
the same flags, defaults and layout: every WAV under `--input-dir` (sorted)
with its own microphone's CSV (`<stem>.csv`, else the folder's first CSV)
is copied to

    <out>/<fmt>_dev/dev-<split>-synth/fold<1|2>_room<room>_mix<NNN>.wav
    <out>/metadata_dev/dev-<split>-synth/fold<1|2>_room<room>_mix<NNN>.csv

(fold 1 for train, 2 for test). Nothing here runs on a device: `--device`
is accepted and checked as the other entries' are, so a run without a card
needs `--device cpu`.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path
from typing import Optional

from audiblelight_tpu_torch import utils
from audiblelight_tpu_torch.utils import logger


def build_parser() -> argparse.ArgumentParser:
    """The reference script's flags and defaults, plus --device."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input-dir", type=str, required=True)
    parser.add_argument("--output-dir", type=str, required=True)
    parser.add_argument("--fmt", choices=["foa", "mic"], default="mic")
    parser.add_argument("--split", choices=["train", "test"], default="train")
    parser.add_argument("--room", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda", help="checked only (cuda, or cpu)")
    return parser


def main(argv: Optional[list] = None) -> int:
    """Convert on `argv` (default: the command line). Returns the number of
    mixtures written."""
    args = build_parser().parse_args(argv)
    utils.resolve_device(args.device)
    in_root = Path(args.input_dir)
    out_root = Path(args.output_dir)
    fold = 1 if args.split == "train" else 2

    audio_out = out_root / f"{args.fmt}_dev" / f"dev-{args.split}-synth"
    meta_out = out_root / "metadata_dev" / f"dev-{args.split}-synth"
    audio_out.mkdir(parents=True, exist_ok=True)
    meta_out.mkdir(parents=True, exist_ok=True)

    mix_idx = 1
    for wav in sorted(in_root.rglob("*.wav")):
        # Each WAV takes its own microphone's CSV (scene_X_mic000.wav ->
        # scene_X_mic000.csv), else the folder's first
        exact = wav.with_suffix(".csv")
        if exact.is_file():
            csv_path = exact
        else:
            csv_candidates = sorted(wav.parent.glob("*.csv"))
            if not csv_candidates:
                logger.warning(f"No CSV next to {wav}; skipping")
                continue
            if len(csv_candidates) > 1:
                logger.warning(f"No exact CSV match for {wav.name}; using {csv_candidates[0].name}")
            csv_path = csv_candidates[0]
        stem = f"fold{fold}_room{args.room}_mix{mix_idx:03d}"
        shutil.copy2(wav, audio_out / f"{stem}.wav")
        shutil.copy2(csv_path, meta_out / f"{stem}.csv")
        mix_idx += 1

    logger.warning(f"Converted {mix_idx - 1} scenes into {out_root}")
    return mix_idx - 1


if __name__ == "__main__":
    main()
