"""SOFA backend: render against measured (here: synthesised) RIR grids.

Writes a SingleRoomSRIR SOFA file from simple synthetic IRs, then builds a Scene
on it; the same flow works with TAU/METU measured collections. Part 2 renders
measured-HRTF binaural: a SimpleFreeFieldHRIR set drives `Binaural(hrtf_sofa=...)`
the way CIPIC/SADIE/KU100 files would.

    python -m audiblelight_tpu_torch.examples.03_sofa_measured [output_dir] [--device cpu]

On the CPU it traces part 2's image sources to order 2 (the reference: 4).
"""

from pathlib import Path

import numpy as np

from audiblelight_tpu_torch import Scene
from audiblelight_tpu_torch.examples import parse_args, small
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.io.sofa import write_sofa
from audiblelight_tpu_torch.micarrays import Binaural
from audiblelight_tpu_torch.rir.hrtf import write_hrtf_sofa

SR = 44100


def make_hrtf(path: Path) -> Path:
    """A toy SimpleFreeFieldHRIR set: per-ear lead/lag + broadband ILD on a
    15-degree azimuth grid (a real measured set drops in unchanged)."""
    az = np.arange(0.0, 360.0, 15.0)
    el = np.zeros_like(az)
    n = 128
    hrirs = np.zeros((len(az), 2, n))
    for i, a in enumerate(az):
        y = np.sin(np.deg2rad(a))  # cosine to the left-ear axis
        for ear, sgn in ((0, 1.0), (1, -1.0)):
            gain = 0.6 + 0.4 * y * sgn
            delay = 32 - y * sgn * (0.0875 / 343.0) * SR
            h = np.sinc(np.arange(n) - delay) * np.hanning(n)
            hrirs[i, ear] = gain * h / max(h.sum(), 1e-9)
    return write_hrtf_sofa(path, hrirs, az, el, SR)


def make_sofa(path: Path) -> Path:
    """An 8-position measurement grid around a 4-capsule mic at room center."""
    rng = np.random.default_rng(0)
    listener = np.array([2.5, 2.0, 1.5])
    grid = rng.uniform([1, 1, 1], [4, 3, 2], (8, 3))
    irs = np.zeros((8, 4, 4096))
    for m in range(8):
        delay = int(np.linalg.norm(grid[m] - listener) / 343 * SR)
        irs[m, :, delay] = 1.0 / (1 + delay / 100)  # direct path
        tail = rng.standard_normal((4, 4096 - delay - 50)) * 0.01
        irs[m, :, delay + 50:] = tail * np.exp(-np.linspace(0, 6, tail.shape[1]))
    return write_sofa(path, irs, grid, listener, receiver_positions=rng.uniform(-0.02, 0.02, (4, 3)),
                      sample_rate=SR)


def main(output_dir: Path, device: str = "cuda") -> Scene:
    cut = small(device)
    output_dir.mkdir(parents=True, exist_ok=True)
    sofa = make_sofa(output_dir / "room.sofa")

    fg = output_dir / "fg" / "music"
    fg.mkdir(parents=True, exist_ok=True)
    t = np.arange(SR * 2) / SR
    wav_write(fg / "tone.wav", (0.6 * np.sin(2 * np.pi * 523 * t) * np.exp(-t)).astype(np.float32), SR)

    # The mic array is built from the SOFA receiver positions.
    scene = Scene(duration=5.0, backend="sofa", backend_kwargs=dict(sofa=sofa), fg_path=output_dir / "fg",
                  device=device)

    # Emitters snap to the nearest measured position (warns above 0.1 m).
    scene.add_event(event_type="static", filepath=fg / "tone.wav", scene_start=1.0, duration=2.0, snr=10.0)

    out = output_dir / "scene"
    out.mkdir(exist_ok=True)
    scene.generate(output_dir=out)

    ev = scene.get_events()[0]
    print(f"event snapped to SOFA index {ev.emitters[0].sofa_idx}")
    print(f"rendered {scene.audio[scene.state.mic_alias].shape}")
    print("wrote:", sorted(p.name for p in out.iterdir()))

    # ---- Part 2: measured-HRTF binaural --------------------------------
    hrtf = make_hrtf(output_dir / "head.sofa")
    bscene = Scene(
        duration=4.0, backend="shoebox",
        backend_kwargs=dict(dimensions=[5.0, 4.0, 3.0], max_order=2 if cut else 4, max_ir_length=0.25, seed=1),
        fg_path=output_dir / "fg",
        device=device,
    )
    bscene.add_microphone(microphone_type=Binaural(hrtf_sofa=str(hrtf)), position=[2.5, 2.0, 1.5], alias="head")
    bscene.add_event(event_type="static", filepath=fg / "tone.wav",
                     position=[2.5, 3.5, 1.5],  # hard LEFT of the listener
                     scene_start=0.5, duration=2.0)
    bout = output_dir / "binaural"
    bout.mkdir(exist_ok=True)
    bscene.generate(output_dir=bout, metadata_dcase=False)
    left, right = bscene.audio["head"]
    print(f"binaural ILD (L/R energy): {np.sum(left**2) / max(np.sum(right**2), 1e-12):.1f}x (source on the left)")
    return bscene


if __name__ == "__main__":
    main(*parse_args(__doc__))
