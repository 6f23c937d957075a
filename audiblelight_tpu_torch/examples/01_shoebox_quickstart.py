"""Quick start: a parametric shoebox room, one mic, two events, full generation.

Creates its own fixture audio so it runs anywhere:

    python -m audiblelight_tpu_torch.examples.01_shoebox_quickstart [output_dir] [--device cpu]

On the CPU it traces image sources to order 3 (the reference: 10).
"""

from pathlib import Path

import numpy as np

from audiblelight_tpu_torch import Scene
from audiblelight_tpu_torch.examples import parse_args, small
from audiblelight_tpu_torch.io.audio import wav_write

SR = 44100


def make_fixtures(root: Path) -> Path:
    """A tiny class-labelled foreground pool (DCASE-style folder layout)."""
    fg = root / "fg"
    t = np.arange(SR * 2) / SR
    clips = {
        "music/pluck.wav": 0.6 * np.sin(2 * np.pi * 330 * t) * np.exp(-2 * t),
        "bell/ding.wav": 0.5 * np.sin(2 * np.pi * 880 * t) * np.exp(-4 * t),
    }
    for rel, audio in clips.items():
        out = fg / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        wav_write(out, audio.astype(np.float32), SR)
    return fg


def main(output_dir: Path, device: str = "cuda") -> Scene:
    cut = small(device)
    fg = make_fixtures(output_dir)

    scene = Scene(
        duration=8.0,
        backend="shoebox",
        # 7x5x3 m room; the image-source engine runs on the device
        backend_kwargs=dict(dimensions=[7.0, 5.0, 3.0], max_order=3 if cut else 10, max_ir_length=0.3, seed=0),
        fg_path=fg,
        ref_db=-65,
        device=device,
    )
    scene.add_microphone(microphone_type="ambeovr", position=[3.5, 2.5, 1.5])
    scene.add_event(event_type="static", filepath=fg / "music/pluck.wav",
                    position=[5.5, 2.0, 1.5], scene_start=1.0, snr=12.0)
    scene.add_event(event_type="static", filepath=fg / "bell/ding.wav",
                    position=[1.5, 4.0, 2.0], scene_start=4.0, snr=8.0)
    scene.add_ambience(noise="pink")

    out = output_dir / "scene"
    out.mkdir(parents=True, exist_ok=True)
    scene.generate(output_dir=out)

    audio = scene.audio["mic000"]
    print(f"rendered {audio.shape} @ {SR} Hz, peak {np.abs(audio).max():.4f}")
    print("wrote:", sorted(p.name for p in out.iterdir()))
    return scene


if __name__ == "__main__":
    main(*parse_args(__doc__))
