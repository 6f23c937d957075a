"""Close the loop: render a scene, then recover the source direction with MUSIC
and produce an APGD acoustic image.

    python -m audiblelight_tpu_torch.examples.05_imaging_doa [output_dir] [--device cpu]

On the CPU it traces image sources to order 2 (the reference: 6) and images
two frames at spherical-harmonic order 3 (the reference: four frames at
the default order 10).
"""

from pathlib import Path

import numpy as np

from audiblelight_tpu_torch import Scene
from audiblelight_tpu_torch.doa import estimate_doa
from audiblelight_tpu_torch.examples import parse_args, small
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.utils import cartesian_to_polar

SR = 24000


def main(output_dir: Path, device: str = "cuda") -> Scene:
    cut = small(device)
    output_dir.mkdir(parents=True, exist_ok=True)
    fg = output_dir / "fg" / "music"
    fg.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    wav_write(fg / "noise.wav", (0.5 * rng.standard_normal(SR * 2)).astype(np.float32), SR)

    mic_pos = np.array([3.0, 2.0, 1.5])
    src_pos = np.array([5.0, 4.0, 1.5])  # front-left of the mic

    scene = Scene(duration=4.0, backend="shoebox", sample_rate=SR,
                  backend_kwargs=dict(dimensions=[7, 5, 3], max_order=2 if cut else 6, max_ir_length=0.25, seed=0),
                  fg_path=output_dir / "fg", device=device)
    scene.add_microphone(microphone_type="eigenmike32", position=mic_pos)
    scene.add_event(event_type="static", filepath=fg / "noise.wav", position=src_pos,
                    scene_start=0.5, duration=2.0, snr=20.0)
    out = output_dir / "scene"
    out.mkdir(exist_ok=True)
    scene.generate(output_dir=out, metadata_dcase=False)

    # --- MUSIC DOA ----------------------------------------------------------
    mic = scene.get_microphone("mic000")
    audio = scene.audio["mic000"][:, int(0.6 * SR): int(2.2 * SR)]
    az, el = estimate_doa(audio, np.asarray(mic.coordinates_cartesian), SR)[0]
    true_az, true_el, _ = cartesian_to_polar(src_pos - mic_pos).ravel()
    print(f"MUSIC: az {az:.1f} (true {true_az:.1f}), el {el:.1f} (true {true_el:.1f})")

    # --- APGD acoustic image ------------------------------------------------
    if cut:
        scene.generate_acoustic_image(output_dir=out, frame_cap=2, sh_order=3)
    else:
        scene.generate_acoustic_image(output_dir=out, frame_cap=4)
    print("wrote:", sorted(p.name for p in out.iterdir()))
    return scene


if __name__ == "__main__":
    main(*parse_args(__doc__))
