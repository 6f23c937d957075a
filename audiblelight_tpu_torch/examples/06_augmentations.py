"""Event augmentations: the 27-effect DSP chain, per-event and scene-default.

    python -m audiblelight_tpu_torch.examples.06_augmentations [output_dir] [--device cpu]

The effects run on the scene's device (the torch FX on the card, the host
FX on the CPU); the example renders no room, so it runs at the reference's
sizes on either.
"""

from pathlib import Path

import numpy as np

from audiblelight_tpu_torch import Scene
from audiblelight_tpu_torch.augmentation import ALL_EVENT_AUGMENTATIONS, Compressor, Fade, LowpassFilter, PitchShift
from audiblelight_tpu_torch.examples import parse_args
from audiblelight_tpu_torch.io.audio import wav_write

SR = 44100


def main(output_dir: Path, device: str = "cuda") -> Scene:
    fg = output_dir / "fg" / "music"
    fg.mkdir(parents=True, exist_ok=True)
    t = np.arange(SR * 2) / SR
    wav_write(fg / "tone.wav", (0.5 * np.sin(2 * np.pi * 440 * t) * np.exp(-t)).astype(np.float32), SR)

    print(f"{len(ALL_EVENT_AUGMENTATIONS)} augmentations:",
          ", ".join(sorted(c.__name__ for c in ALL_EVENT_AUGMENTATIONS)))

    # Scene-level defaults apply to every event; tuples carry constructor kwargs.
    scene = Scene(duration=6.0, backend="shoebox",
                  backend_kwargs=dict(dimensions=[6, 4, 3], max_order=10, max_ir_length=0.25, seed=0),
                  fg_path=output_dir / "fg",
                  event_augmentations=[(LowpassFilter, dict(cutoff_frequency_hz=2000))],
                  device=device)
    scene.add_microphone(microphone_type="monocapsule", position=[3, 2, 1.5])
    scene.add_event(event_type="static", filepath=fg / "tone.wav", scene_start=0.5, duration=2.0, snr=10.0)

    # Per-event chains stack on top; unset parameters sample from each class's
    # default distribution.
    ev = scene.get_events()[0]
    ev.register_augmentations([
        Compressor(sample_rate=SR, threshold_db=-24, ratio=4.0),
        PitchShift(sample_rate=SR, semitones=-3.0),
        Fade(sample_rate=SR, fade_out_shape="exponential"),
    ])
    print("event chain:", [a.__class__.__name__ for a in ev.get_augmentations()])

    dry = np.sin(2 * np.pi * 440 * t)
    wet = ev.load_audio()
    print(f"dry peak {np.abs(dry).max():.3f} -> augmented peak {np.abs(wet).max():.3f}, len {len(wet)} samples")

    # Round-trips survive serialization
    rebuilt = Scene.from_dict(scene.to_dict(), device=device)
    print("serialization round-trip ok:", rebuilt == scene)
    return scene


if __name__ == "__main__":
    main(*parse_args(__doc__))
