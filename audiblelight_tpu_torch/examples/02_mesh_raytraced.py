"""Ray-traced mesh backend: load a room mesh, place a moving event, render.

Builds a box-room OBJ on the fly; swap in any GLB/OBJ/PLY scan:

    python -m audiblelight_tpu_torch.examples.02_mesh_raytraced [output_dir] [--device cpu]

On the card each bounce's first hit runs K1, the rain visibility K2 and
the FOA deposit K4; on the CPU their plain PyTorch versions run.
On the CPU it traces 512 rays x 12 bounces (the reference: 2048 x 48).
"""

from pathlib import Path

import numpy as np

from audiblelight_tpu_torch import Scene
from audiblelight_tpu_torch.examples import parse_args, small
from audiblelight_tpu_torch.geometry.mesh import box_mesh, save_obj
from audiblelight_tpu_torch.io.audio import wav_write

SR = 44100


def main(output_dir: Path, device: str = "cuda") -> Scene:
    cut = small(device)
    output_dir.mkdir(parents=True, exist_ok=True)
    room = save_obj(box_mesh(extents=[8.0, 6.0, 3.0], center=[4.0, 3.0, 1.5]), output_dir / "room.obj")

    fg = output_dir / "fg" / "music"
    fg.mkdir(parents=True, exist_ok=True)
    t = np.arange(SR * 3) / SR
    wav_write(fg / "tone.wav", (0.5 * np.sin(2 * np.pi * 440 * t) * np.exp(-t)).astype(np.float32), SR)

    scene = Scene(
        duration=6.0,
        backend="rlr",
        backend_kwargs=dict(
            mesh=room,
            material="Carpet",  # per-band absorption from the material table
            rlr_kwargs=dict(indirect_ray_count=512 if cut else 2048,  # rays per source
                            indirect_ray_depth=12 if cut else 48),  # bounces
        ),
        fg_path=output_dir / "fg",
        device=device,
    )
    scene.add_microphone(microphone_type="foalistener", position=[4.0, 3.0, 1.5])

    # A moving event: semicircular trajectory sampled inside the room
    scene.add_event(event_type="moving", filepath=fg / "tone.wav", shape="semicircular",
                    scene_start=0.5, duration=3.0, velocity=1.2, resolution=2.0, snr=10.0)

    out = output_dir / "scene"
    out.mkdir(exist_ok=True)
    scene.generate(output_dir=out)

    audio = scene.audio["mic000"]
    ev = scene.get_events()[0]
    print(f"FOA render {audio.shape}; event moved through {len(ev.emitters)} waypoints")
    print("wrote:", sorted(p.name for p in out.iterdir()))
    return scene


if __name__ == "__main__":
    main(*parse_args(__doc__))
