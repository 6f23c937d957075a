"""Scanned-room scene with a raycast panorama video.

A nonconvex, high-face-count room (the Gibson-scan regime) rendered end to end:
stochastic ray-traced RIRs with occlusion, a spatial event mix, and a video
whose background is the room itself, raycast equirectangularly with the
port's first-hit kernel (K1; no VTK/OpenCV). On the card the trace runs K1,
K2 and K3, the panorama one launch of K1.

Unlike the reference's example, the placement is seeded (the world state's
`seed` and `utils.seed_everything`, both 7), so every run places the same
microphone and events: the reference's unseeded placement is what makes its
own example's test unsteady (some placements ask its CPU run for ~70 GB).

    python -m audiblelight_tpu_torch.examples.07_scanned_room_video [output_dir] [--device cpu]

On the CPU it builds the room at subdivision level 1 (the reference: 3) and
traces 256 rays x 8 bounces (the reference: 1000 x 20).
"""

from pathlib import Path

import numpy as np

from audiblelight_tpu_torch import Scene, utils
from audiblelight_tpu_torch.examples import parse_args, small
from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
from audiblelight_tpu_torch.io.audio import wav_write

SEED = 7


def main(output_dir: Path, device: str = "cuda") -> Scene:
    cut = small(device)
    output_dir.mkdir(parents=True, exist_ok=True)
    utils.seed_everything(SEED)
    # A watertight nonconvex interior standing in for a license-gated Gibson scan.
    # Raise subdivision_levels to 5 for the full ~10^5-face tracing workload.
    room = scanned_like_room(extents=(6.0, 4.5, 2.8), n_furniture=5, subdivision_levels=1 if cut else 3, seed=7)
    print(f"room: {len(room.faces)} faces, convex={room.is_convex}")

    # Foreground pool: two synthetic class-labelled sounds
    fg = output_dir / "fg"
    sr = 24000
    t = np.arange(2 * sr) / sr
    (fg / "music").mkdir(parents=True, exist_ok=True)
    wav_write(fg / "music" / "arp.wav", (0.5 * np.sin(2 * np.pi * 440 * t) * np.exp(-t * 2)).astype(np.float32), sr)
    (fg / "femaleSpeech").mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    wav_write(fg / "femaleSpeech" / "speech.wav",
              (0.3 * rng.standard_normal(len(t)) * np.exp(-t)).astype(np.float32), sr)

    scene = Scene(
        duration=8.0,
        backend="rlr",
        sample_rate=sr,
        fg_path=fg,
        backend_kwargs=dict(
            mesh=room,
            rlr_kwargs=dict(indirect_ray_count=256 if cut else 1000, indirect_ray_depth=8 if cut else 20,
                            max_ir_length=0.8),
            seed=SEED,
        ),
        device=device,
    )
    scene.add_microphone(microphone_type="ambeovr", alias="m")  # placed by the seeded draw
    scene.add_event(event_type="static", alias="arp", scene_start=0.5, event_start=0.0, duration=2.0)
    scene.add_event(event_type="moving", shape="linear", alias="walker", scene_start=3.0, event_start=0.0,
                    duration=3.0)
    scene.add_ambience(noise="pink")

    scene.generate(output_dir=output_dir, video=True)
    print(f"outputs in {output_dir}:")
    for p in sorted(output_dir.iterdir()):
        if p.is_file():
            print("  ", p.name)
    return scene


if __name__ == "__main__":
    main(*parse_args(__doc__))
