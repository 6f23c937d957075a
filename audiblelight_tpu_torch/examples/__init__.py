"""Worked examples of the port, each the counterpart of the reference's
`examples/0N_*.py`. Each runs as a module with an output directory and
`--device` (default `cuda`):

    python -m audiblelight_tpu_torch.examples.01_shoebox_quickstart <out> [--device cpu]

and exposes `main(output_dir, device)` for callers in the same process. On
the card each runs at the reference example's sizes. On the CPU the port's
image-source engine and tracer take minutes at those sizes (eager PyTorch,
no kernel), so there an example cuts its work (the image-source order, the
IR length, rays and bounces, the room's faces: `small(device)`) and keeps
everything it does.
"""

import argparse
import tempfile
from pathlib import Path

import torch


def small(device) -> bool:
    """Whether an example on `device` runs at its cut sizes: on the CPU."""
    return torch.device(device).type == "cpu"


def parse_args(doc: str) -> tuple:
    """(output directory, device) of an example's command line: the output
    directory (a fresh temporary one when omitted) and `--device`."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("output_dir", nargs="?", type=Path, default=None)
    parser.add_argument("--device", default="cuda", help="where the example runs (default: cuda)")
    args = parser.parse_args()
    out = args.output_dir or Path(tempfile.mkdtemp())
    out.mkdir(parents=True, exist_ok=True)
    return out, args.device
