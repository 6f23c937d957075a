"""MUSIC direction-of-arrival experiment with the PyTorch/CUDA port.

    python -m audiblelight_tpu_torch.music_doa [--n-azimuths 8] [--seed 0] [--device cpu]

The port's counterpart of scripts/experiments/music_doa.py, with the same
flags, defaults and output: a 2 s two-tone-plus-noise source (drawn from
`np.random.default_rng(seed)`) placed 2 m from an Eigenmike32 at each of
`--n-azimuths` azimuths in an 8 x 8 x 4 m shoebox (image sources to order
2, 0.12 s IRs, one band, absorption 0.85, trial i seeded i), rendered
through the classic per-event render, its direction estimated by MUSIC
(`doa.estimate_doa`), and the errors' statistics printed as

    mean_error_deg=... median_error_deg=... max_error_deg=...

`--device` (default cuda) selects where the placement queries, the image
sources and the render run; without a card the default raises.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from audiblelight_tpu_torch import utils
from audiblelight_tpu_torch.core import Scene
from audiblelight_tpu_torch.doa import estimate_doa
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.micarrays import Eigenmike32
from audiblelight_tpu_torch.utils import logger

SR = 44100


def run_trial(az_gt: float, fg: Path, seed: int, device=None) -> float:
    """One trial: the source at azimuth `az_gt` (elevation 0, 2 m); returns
    the absolute azimuth error of the MUSIC estimate in degrees."""
    scene = Scene(
        duration=3.0,
        backend="shoebox",
        fg_path=fg,
        backend_kwargs=dict(
            dimensions=[8.0, 8.0, 4.0], max_order=2, max_ir_length=0.12,
            frequency_bands=1, absorption=0.85, seed=seed,
        ),
        device=device,
    )
    scene.add_microphone(microphone_type="eigenmike32", position=[4.0, 4.0, 2.0])
    scene.add_event(
        event_type="static",
        position=[az_gt, 0.0, 2.0],
        polar=True,
        scene_start=0.0,
        event_start=0.0,
        duration=2.0,
        snr=25.0,
    )
    from audiblelight_tpu_torch.synthesize import render_scene_classic

    render_scene_classic(scene)
    audio = scene.audio[list(scene.audio.keys())[0]][:, : 2 * SR]

    est = estimate_doa(audio, Eigenmike32().coordinates_cartesian, SR, n_sources=1)
    return float(abs((est[0, 0] - az_gt + 180) % 360 - 180))


def build_parser() -> argparse.ArgumentParser:
    """The reference script's flags and defaults, plus --device."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--n-azimuths", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where placement queries, image sources and renders run (cuda, or cpu)")
    return parser


def main(argv: Optional[list] = None) -> list[float]:
    """Run the experiment on `argv` (default: the command line). Returns each
    trial's error in degrees, in azimuth order."""
    args = build_parser().parse_args(argv)
    device = utils.resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="al_doa_") as tmp_dir:
        tmp = Path(tmp_dir)
        d = tmp / "music"
        d.mkdir()
        rng = np.random.default_rng(args.seed)
        t = np.arange(SR * 2) / SR
        sig = 0.4 * np.sin(2 * np.pi * 800 * t) + 0.3 * np.sin(2 * np.pi * 2400 * t)
        sig += 0.2 * rng.standard_normal(len(t))
        wav_write(d / "src.wav", sig.astype(np.float32), SR, subtype="float32")

        azimuths = np.linspace(-180, 180, args.n_azimuths, endpoint=False)
        errors = []
        for i, az in enumerate(azimuths):
            err = run_trial(float(az), tmp, seed=i, device=device)
            errors.append(err)
            logger.warning(f"az={az:+7.1f} deg -> error {err:5.1f} deg")

    arr = np.array(errors)
    print(
        f"mean_error_deg={arr.mean():.2f} median_error_deg={np.median(arr):.2f} "
        f"max_error_deg={arr.max():.2f}"
    )
    return errors


if __name__ == "__main__":
    main()
