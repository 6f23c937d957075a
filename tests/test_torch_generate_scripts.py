"""The port's Scene-API entries (`random_events`, `dcase_format`,
`scene_timing`, `acoustic_images`) against the reference scripts
(scripts/generate/{generate_with_random_events,convert_to_dcase_format,
benchmark}.py, scripts/imaging/generate_acoustic_images.py), each run
in-process through its `main` on the CPU with the same seeds.

Both packages' shoebox rooms are cut alike to image sources of order 2 and
0.1 s IRs (`_small_shoebox`), so the scenes render in seconds here; the
entries' flags, seeding, placement and files are what is held. File names
are equal; DCASE CSVs byte for byte; metadata JSONs equal but for the
creation time; the pool and the converted layout's CSVs byte for byte;
acoustic images within 1e-4 of their peak (tests/test_torch_imaging.py),
their HDF attributes equal and their labels' (frame, instance, class,
distance) entries equal."""

import functools
import importlib.util
import json
import random
import re
import shutil
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from audiblelight_tpu import utils as jutils
from audiblelight_tpu.worldstate import shoebox_backend as jax_shoebox
from audiblelight_tpu_torch import acoustic_images, dcase_format, random_events, scene_timing
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.worldstate import shoebox_backend as port_shoebox

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


@pytest.fixture(autouse=True)
def _small_shoebox(monkeypatch):
    """Image sources of order 2 and 0.1 s IRs in both packages, whatever the
    entry asks for."""
    for cls in (jax_shoebox.WorldStateShoebox, port_shoebox.WorldStateShoebox):
        init = cls.__init__

        @functools.wraps(init)
        def small(self, *args, _init=init, **kwargs):
            kwargs.update(max_order=2, max_ir_length=0.1)
            _init(self, *args, **kwargs)

        monkeypatch.setattr(cls, "__init__", small)


def _reference(rel: str):
    spec = importlib.util.spec_from_file_location("ref_" + Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(monkeypatch, rel: str, argv: list, seed: int):
    mod = _reference(rel)
    monkeypatch.setattr("sys.argv", [rel, *argv])
    jutils.seed_everything(seed)
    mod.main()


@pytest.fixture(scope="module")
def fg(tmp_path_factory):
    root = tmp_path_factory.mktemp("fg")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / wav.parent.name / wav.name)
    return root


def _canon(path: Path) -> dict:
    d = json.loads(path.read_text())
    d.pop("creation_time")
    return d


def _same_scene_files(got: Path, want: Path) -> list:
    names = sorted(p.relative_to(got).as_posix() for p in got.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(want).as_posix() for p in want.rglob("*") if p.is_file())
    for name in names:
        if name.endswith(".csv"):
            assert (got / name).read_bytes() == (want / name).read_bytes(), name
        elif name.endswith("metadata_out.json"):
            assert _canon(got / name) == _canon(want / name), name
    return names


def test_random_events_matches_the_reference(fg, tmp_path, monkeypatch):
    argv = ["--fg-dir", str(fg), "--n-scenes", "2", "--duration", "5", "--n-static", "2", "--n-moving", "1"]
    _run_reference(monkeypatch, "scripts/generate/generate_with_random_events.py",
                   [*argv, "--output-dir", str(tmp_path / "want")], seed=5)
    tutils.seed_everything(5)
    seconds = random_events.main([*argv, "--output-dir", str(tmp_path / "got"), "--device", "cpu"])
    assert len(seconds) == 2
    names = _same_scene_files(tmp_path / "got", tmp_path / "want")
    assert "scene_0001/audio_out_mic000.wav" in names and "scene_0000/metadata_out_mic000.csv" in names
    assert json.loads((tmp_path / "got/scene_0000/metadata_out.json").read_text())["events"]

    # dcase_format on both packages' scenes: the same layout, the CSVs byte for byte
    conv = ["--fmt", "mic", "--split", "test", "--room", "3"]
    _run_reference(monkeypatch, "scripts/generate/convert_to_dcase_format.py",
                   ["--input-dir", str(tmp_path / "want"), "--output-dir", str(tmp_path / "dcase_want"), *conv], 0)
    n = dcase_format.main(["--input-dir", str(tmp_path / "got"), "--output-dir", str(tmp_path / "dcase_got"), *conv,
                           "--device", "cpu"])
    assert n == 2
    names = _same_scene_files(tmp_path / "dcase_got", tmp_path / "dcase_want")
    assert names == ["metadata_dev/dev-test-synth/fold2_room3_mix001.csv",
                     "metadata_dev/dev-test-synth/fold2_room3_mix002.csv",
                     "mic_dev/dev-test-synth/fold2_room3_mix001.wav", "mic_dev/dev-test-synth/fold2_room3_mix002.wav"]


def test_dcase_format_copies_the_reference_layout_exactly(tmp_path, monkeypatch):
    """On the same input (a two-microphone scene, a lone WAV with no CSV, a
    WAV whose folder has another mic's CSV) both converters write the same
    bytes; without a card the default device raises."""
    src = tmp_path / "in"
    for rel, text in (("a/s_mic000.wav", "w0"), ("a/s_mic000.csv", "c0"), ("a/s_mic001.wav", "w1"),
                      ("a/s_mic001.csv", "c1"), ("b/lone.wav", "w2"), ("c/x_mic000.wav", "w3"), ("c/y.csv", "c3")):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(text)
    _run_reference(monkeypatch, "scripts/generate/convert_to_dcase_format.py",
                   ["--input-dir", str(src), "--output-dir", str(tmp_path / "want"), "--fmt", "foa"], 0)
    assert dcase_format.main(["--input-dir", str(src), "--output-dir", str(tmp_path / "got"), "--fmt", "foa",
                              "--device", "cpu"]) == 3
    names = _same_scene_files(tmp_path / "got", tmp_path / "want")
    for name in names:
        assert (tmp_path / "got" / name).read_bytes() == (tmp_path / "want" / name).read_bytes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dcase_format.main(["--input-dir", str(src), "--output-dir", str(tmp_path / "x")])


def test_scene_timing_matches_the_reference(tmp_path, monkeypatch, capsys):
    """The synthetic pool byte for byte, then one scene from it: the same
    files and metadata, and the reference's printed line."""
    ref_bench = _reference("scripts/generate/benchmark.py")
    for mod, d in ((ref_bench, tmp_path / "pool_want"), (scene_timing, tmp_path / "pool")):
        d.mkdir()
        mod.make_pool(d, 24000)
    for p in sorted((tmp_path / "pool").rglob("*.wav")):
        assert p.read_bytes() == (tmp_path / "pool_want" / p.relative_to(tmp_path / "pool")).read_bytes()

    argv = ["--n-scenes", "1", "--duration", "5", "--fg-dir", str(tmp_path / "pool"), "--seed", "3"]
    _run_reference(monkeypatch, "scripts/generate/benchmark.py", [*argv, "--output-dir", str(tmp_path / "want")], 9)
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    tutils.seed_everything(9)
    total, done = scene_timing.main([*argv, "--output-dir", str(tmp_path / "got"), "--device", "cpu"])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    pattern = r"total_seconds=\d+\.\d\d avg_seconds_per_scene=\d+\.\d\d\d"
    assert re.fullmatch(pattern, got_line) and re.fullmatch(pattern, want_line)
    assert done == 1 and total > 0
    names = _same_scene_files(tmp_path / "got", tmp_path / "want")
    assert names[0] == "scene_00000/audio_out_mic000.wav"
    # A second run resumes: the written scene is skipped
    assert scene_timing.main([*argv, "--output-dir", str(tmp_path / "got"), "--device", "cpu"])[1] == 0


def test_acoustic_images_matches_the_reference(fg, tmp_path, monkeypatch):
    argv = ["--fg-dir", str(fg), "--n-scenes", "1", "--duration", "5", "--max-events", "2", "--nbands", "3",
            "--sh-order", "3", "--seed", "1"]
    _run_reference(monkeypatch, "scripts/imaging/generate_acoustic_images.py",
                   [*argv, "--output-dir", str(tmp_path / "want")], seed=2)
    tutils.seed_everything(2)
    seconds = acoustic_images.main([*argv, "--output-dir", str(tmp_path / "got"), "--device", "cpu"])
    assert len(seconds) == 1
    names = _same_scene_files(tmp_path / "got", tmp_path / "want")
    assert names == [f"scene_0000/{n}" for n in ("acoustic_image_metadata_mic000.json", "acoustic_image_mic000.hdf",
                                                 "audio_out_mic000.wav", "metadata_out.json",
                                                 "metadata_out_mic000.csv")]
    with h5py.File(tmp_path / "got/scene_0000/acoustic_image_mic000.hdf") as fg_, \
            h5py.File(tmp_path / "want/scene_0000/acoustic_image_mic000.hdf") as fw:
        assert dict(fg_.attrs) == dict(fw.attrs)
        got, want = fg_["ai_apgd"][()], fw["ai_apgd"][()]
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (64, 3, 50)
        # The image of the port's own audio (its IRs 1e-4 of peak from the
        # reference's): 5e-6 of peak apart at this size
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    key = ("metadata_frame_index", "instance_id", "category_id", "distance")
    js = [json.loads((tmp_path / w / "scene_0000/acoustic_image_metadata_mic000.json").read_text())
          for w in ("got", "want")]
    assert [tuple(d[k] for k in key) for d in js[0]] == [tuple(d[k] for k in key) for d in js[1]]
    # A second run skips the imaged scene
    assert acoustic_images.main([*argv, "--output-dir", str(tmp_path / "got"), "--device", "cpu"]) == []
