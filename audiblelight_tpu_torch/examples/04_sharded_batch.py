"""Multi-device scene rendering: compile scenes to plans, shard a batch over a mesh.

The port's `parallel` package runs on `torch.distributed` ranks, one
process and one card a rank. Here the world is this one process (NCCL on
the card, gloo on the CPU), and a process whose group is up already renders
in it; launch one process per card with `init_distributed` for more:

    python -m audiblelight_tpu_torch.examples.04_sharded_batch [output_dir] [--device cpu]

On the CPU it traces image sources to order 3 (the reference: 10).
"""

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from audiblelight_tpu_torch import Scene
from audiblelight_tpu_torch.examples import parse_args, small
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.parallel import init_distributed, make_mesh, render_batch, shard_render, stack_plans
from audiblelight_tpu_torch.render import build_scene_plan

SR = 24000


def build_scene(root: Path, seed: int, device: str, max_order: int) -> Scene:
    fg = root / "fg" / "music"
    if not fg.exists():
        fg.mkdir(parents=True)
        t = np.arange(SR * 2) / SR
        wav_write(fg / "tone.wav", (0.5 * np.sin(2 * np.pi * 330 * t)).astype(np.float32), SR)
    scene = Scene(duration=5.0, backend="shoebox", sample_rate=SR,
                  backend_kwargs=dict(dimensions=[6, 4, 3], max_order=max_order, max_ir_length=0.25, seed=seed),
                  fg_path=root / "fg", device=device)
    scene.add_microphone(microphone_type="ambeovr", position=[3, 2, 1.5])
    scene.add_event(event_type="static", filepath=fg / "tone.wav",
                    scene_start=0.5 + 0.15 * (seed % 8), duration=2.0, snr=10.0)
    return scene


def main(output_dir: Path, device: str = "cuda") -> np.ndarray:
    output_dir.mkdir(parents=True, exist_ok=True)
    own_group = not dist.is_initialized()
    if own_group:
        init_distributed(f"file://{(output_dir / 'rendezvous').resolve()}", 1, 0,
                         backend="nccl" if torch.device(device).type == "cuda" else "gloo")
    try:
        n_dev = dist.get_world_size()
        print(f"{n_dev} rank(s), backend {dist.get_backend()}")

        # One scene per mesh 'scene'-axis slot x chan shards handled inside
        n_scenes = max(n_dev, 4)
        scenes = [build_scene(output_dir, s, device, 3 if small(device) else 10) for s in range(n_scenes)]
        for s in scenes:
            s.state.simulate()
        batch = stack_plans([build_scene_plan(s) for s in scenes])

        # Mesh axes: scenes shard over "scene", capsule channels over "chan"
        mesh = make_mesh(n_scene=max(n_dev // 2, 1), n_chan=2 if n_dev >= 2 else 1)
        sharded = shard_render(batch, mesh).cpu().numpy()
        local = render_batch(batch).cpu().numpy()  # this rank's unsharded render
        rank = dist.get_rank()
        mine = local[rank * len(sharded):(rank + 1) * len(sharded)]
        print(f"batch audio {local.shape}, this rank's shard {sharded.shape}; "
              f"sharded == local: {np.array_equal(sharded, mine)}")
        return sharded
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main(*parse_args(__doc__))
