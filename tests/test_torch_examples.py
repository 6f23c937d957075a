"""Run every example of the port (audiblelight_tpu_torch/examples/) as a CPU
subprocess, as tests/test_examples.py runs the reference's: `--device cpu`
(where an example cuts its work, `examples.small`), a clean exit within its
time limit, and the files each writes. The examples import the port
only; the subprocess's modules are checked for `jax` and the reference.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.stem for p in (REPO / "audiblelight_tpu_torch" / "examples").glob("0*.py"))
TIMEOUT_S = 180

# What each example leaves in its output directory (relative paths)
WRITES = {
    "01_shoebox_quickstart": ["scene/audio_out_mic000.wav", "scene/metadata_out_mic000.csv",
                              "scene/metadata_out.json"],
    "02_mesh_raytraced": ["room.obj", "scene/audio_out_mic000.wav", "scene/metadata_out_mic000.csv"],
    "03_sofa_measured": ["room.sofa", "head.sofa", "scene/audio_out_mic000.wav", "binaural/audio_out_head.wav"],
    "04_sharded_batch": ["fg/music/tone.wav"],
    "05_imaging_doa": ["scene/audio_out_mic000.wav", "scene/acoustic_image_mic000.hdf",
                       "scene/acoustic_image_metadata_mic000.json"],
    "06_augmentations": ["fg/music/tone.wav"],
    "07_scanned_room_video": ["audio_out_m.wav", "metadata_out_m.csv", "video_out.mp4", "video_out.gif"],
}

# Appended to each example's run: the modules it imported, one line
PROBE = ("import sys; print('MODULES', sorted(m for m in sys.modules "
         "if m == 'jax' or m.startswith(('jax.', 'audiblelight_tpu.')) or m == 'audiblelight_tpu'))")


def run_example(name: str, out: Path) -> subprocess.CompletedProcess:
    code = (f"import runpy, sys; sys.argv = ['{name}', {str(out)!r}, '--device', 'cpu']; "
            f"runpy.run_module('audiblelight_tpu_torch.examples.{name}', run_name='__main__'); " + PROBE)
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=TIMEOUT_S,
                          env=env, cwd=str(REPO))


def test_examples_exist():
    assert EXAMPLES == sorted(WRITES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, tmp_path):
    res = run_example(name, tmp_path)
    assert res.returncode == 0, f"{name} failed\n--- stdout ---\n{res.stdout[-4000:]}\n--- stderr ---\n{res.stderr[-4000:]}"
    assert "MODULES []" in res.stdout, res.stdout[-2000:]
    for rel in WRITES[name]:
        path = tmp_path / rel
        assert path.is_file() and path.stat().st_size > 0, f"{name} did not write {rel}"
