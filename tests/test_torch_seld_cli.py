"""The port's SELD dataset CLI (`python -m audiblelight_tpu_torch.seld`) on the
CPU, against the JAX package's own script.

The CLI runs at a tiny size (a 6 x 4 x 3 m nonconvex room as an OBJ, two 4 s
scenes, 128 rays x 4 bounces, 0.1 s IRs) in both DCASE formats. It writes
the reference script's file names; its DCASE CSVs are byte-identical and
its JSONs equal (but for the creation time) to those of the reference
script's own `build_scene` and `generate_dcase2024_metadata` for the same
--seed (the reference render is not run: the metadata depends only on the
placement); its WAVs are 4-channel 24 kHz int16 and not silent. A second run
skips the finished scenes, `--backend sofa` without `--sofa` raises the
reference's error (and `--assets` on it without `--sofa-dir` exits with the
reference's message), the fused pipeline and the
pooled driver exit with the reference's messages on the shoebox and SOFA
backends, `--mesh-devices 2` raises without a card and exits on a host
with one, and the flags that
take the plan path (`--pipeline compiled`, `--no-device-mix`,
`--no-mesh-simplification`) write the same files. `--pipeline classic`
and `--augmentations` run, on rlr and on the shoebox, and place what the
reference script places, augmentation parameters included.

The CLI's default backend, the shoebox (no --backend; order 2, 0.1 s IRs,
two 4 s scenes per format, the plan path), is held the same way: the
reference's layout, CSVs byte-identical and JSONs equal to the reference
script's `build_scene` for the same --seed, and 4-channel 24 kHz int16 WAVs
with sound. Its plan path draws the host ambience bed from numpy's global
stream before the next scene is placed, as the reference script's
`generate` does, so the reference's scenes draw their beds too.
"""

import importlib
import json
import random
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu import utils as jutils
from audiblelight_tpu.synthesize import generate_dcase2024_metadata
from audiblelight_tpu_torch import seld
from audiblelight_tpu_torch.geometry.mesh import save_obj, scanned_like_room
from audiblelight_tpu_torch.io.audio import wav_read

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = 5


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them, so the test files that run after it in
    the same process draw what they would have drawn without it."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")
    return root


def _argv(root: Path, layout: str, out: str) -> list:
    return ["--fg-dir", str(root / "fg"), "--output-dir", str(root / out), "--backend", "rlr",
            "--mesh", str(root / "room.obj"), "--channel-layout", layout, "--n-scenes", "2",
            "--train-frac", "0.5", "--duration", "4", "--rays", "128", "--ray-depth", "4",
            "--ir-seconds", "0.1", "--max-events-static", "2", "--max-events-moving", "1",
            "--seed", str(SEED)]


def _names(layout: str) -> list:
    out = []
    for split, fold in (("train", 1), ("test", 2)):
        stem = f"dev-{split}-alight/fold{fold}_scene1_000"
        out += [f"{layout}_dev/{stem}_mic000.wav", f"metadata_dev/{stem}.json",
                f"metadata_dev/{stem}_mic000.csv"]
    return sorted(out)


@pytest.fixture(scope="module", params=["mic", "foa"])
def run(request, assets):
    layout = request.param
    seconds = seld.main(_argv(assets, layout, f"port_{layout}") + ["--device", "cpu"])
    return assets, layout, seconds


def test_cli_writes_the_reference_layout_and_wavs(run):
    root, layout, seconds = run
    out = root / f"port_{layout}"
    assert len(seconds) == 2
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) == _names(layout)
    for wav in out.rglob("*.wav"):
        data, sr = wav_read(wav)
        assert sr == 24000 and data.shape == (4, 4 * 24000)
        with open(wav, "rb") as f:
            assert f.read(36)[20:22] == b"\x01\x00" and f.read(0) == b""  # PCM format tag
        assert np.abs(data).max() > 100 / 32768


def test_cli_metadata_matches_reference_script(run):
    """The reference script's build_scene for the same seed places the same
    scenes: the same CSV bytes and JSON."""
    root, layout, _ = run
    sys.path.insert(0, str(REPO / "scripts" / "seld"))
    try:
        sys.modules.pop("generate_dataset", None)  # the other script of that name, if a test loaded it
        gd = importlib.import_module("generate_dataset")
    finally:
        sys.path.remove(str(REPO / "scripts" / "seld"))
    args = seld.build_parser().parse_args(_argv(root, layout, f"ref_{layout}"))
    args.pipeline = "fused"
    jutils.seed_everything(SEED)
    rng = np.random.default_rng(SEED)
    for split, fold in (("train", 1), ("test", 2)):
        scene, _, _ = gd.build_scene(args, split, 1, 0, rng)
        stem = root / f"port_{layout}/metadata_dev/dev-{split}-alight/fold{fold}_scene1_000"
        want = json.loads(json.dumps(scene.to_dict()))
        got = json.loads(stem.with_suffix(".json").read_text())
        want.pop("creation_time"), got.pop("creation_time")
        assert got == want
        csv = generate_dcase2024_metadata(scene)["mic000"].to_csv(sep=",", encoding="utf-8", header=None)
        assert Path(f"{stem}_mic000.csv").read_text() == csv


def test_cli_resumes(run):
    """A second run over the same output folder skips the finished scenes."""
    root, layout, _ = run
    out = root / f"port_{layout}"
    before = {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()}
    assert seld.main(_argv(root, layout, f"port_{layout}") + ["--device", "cpu"]) == []
    assert {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()} == before


@pytest.mark.parametrize("flags", [["--backend", "sofa"], ["--assets", "9A"]], ids=lambda f: " ".join(f))
def test_cli_unported_flags_raise(tmp_path, flags):
    """A flag the CLI cannot run as given raises before anything is
    written. Every flag is ported: `--backend sofa` without `--sofa` raises
    the reference script's error, and `--assets` (its runs are held in
    test_torch_assets.py) on the sofa backend without `--sofa-dir` exits with
    the reference script's message. The multi-device flags are ported
    (their runs are held in test_torch_prep.py)."""
    argv = ["--fg-dir", str(tmp_path), "--output-dir", str(tmp_path / "out"), "--backend", "rlr",
            "--mesh", str(tmp_path / "room.obj"), "--device", "cpu"] + flags
    if flags == ["--backend", "sofa"]:
        raises = pytest.raises(ValueError, match="--sofa or --assets is required")
    else:
        argv += ["--backend", "sofa"]
        raises = pytest.raises(SystemExit, match="--sofa-dir is required with --assets on the sofa backend")
    with raises:
        seld.main(argv)
    assert not (tmp_path / "out").exists()


SOFA_FIXTURE = REPO / "tests/resources/torch_sofa/reference_writer.sofa"


@pytest.mark.parametrize("backend,flags,message", [
    ("shoebox", ["--pipeline", "fused"], "--pipeline fused requires the rlr backend"),
    ("sofa", ["--sofa", str(SOFA_FIXTURE), "--pipeline", "fused"], "--pipeline fused requires the rlr backend"),
    ("shoebox", ["--placement-workers", "2"], "--placement-workers/--mesh-devices require --backend rlr"),
    ("sofa", ["--sofa", str(SOFA_FIXTURE), "--mesh-devices", "2"],
     "--placement-workers/--mesh-devices require --backend rlr"),
], ids=["shoebox fused", "sofa fused", "shoebox pooled", "sofa mesh-devices"])
def test_cli_rlr_only_paths_exit_on_other_backends(tmp_path, backend, flags, message):
    """The fused pipeline and the pooled driver run on rlr only: on the
    shoebox and SOFA backends the CLI exits with the reference script's
    message before anything is written."""
    argv = ["--fg-dir", str(tmp_path), "--output-dir", str(tmp_path / "out"), "--backend", backend,
            "--device", "cpu"] + flags
    with pytest.raises(SystemExit, match=message):
        seld.main(argv)
    assert not (tmp_path / "out").exists()


def test_cli_mesh_devices_without_a_card_raises(tmp_path, monkeypatch):
    """`--mesh-devices 2` on the default device (a card) raises the port's
    no-card error on a machine without cards, before a rank is spawned."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--fg-dir", str(tmp_path), "--output-dir", str(tmp_path / "out"), "--backend", "rlr",
            "--mesh", str(tmp_path / "room.obj"), "--mesh-devices", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        seld.main(argv)
    assert not (tmp_path / "out").exists()


def test_cli_mesh_devices_beyond_the_cards_exits(tmp_path, monkeypatch):
    """`--mesh-devices 2` on a host with one card exits with the reference
    script's message, before a rank is spawned (NCCL refuses two ranks on
    one card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = ["--fg-dir", str(tmp_path), "--output-dir", str(tmp_path / "out"), "--backend", "rlr",
            "--mesh", str(tmp_path / "room.obj"), "--mesh-devices", "2"]
    with pytest.raises(SystemExit, match="--mesh-devices 2 but only 1 devices"):
        seld.main(argv)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("flags", [["--pipeline", "compiled"], ["--no-device-mix"], ["--no-mesh-simplification"]],
                         ids=lambda f: " ".join(f))
def test_cli_plan_path_flags(run, flags):
    """The plan path (traced IR banks, device stems, host mix and bed) writes
    the fused path's files and WAVs with sound. Its first scene's CSV is the
    fused run's; the host bed draws from numpy's global stream, which the
    next scene's placement draws from too, as in the reference."""
    root, layout, _ = run
    name = f"plan_{layout}_{flags[-1].strip('-')}"
    seconds = seld.main(_argv(root, layout, name) + ["--device", "cpu"] + flags)
    out, fused = root / name, root / f"port_{layout}"
    assert len(seconds) == 2
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) == _names(layout)
    first = "metadata_dev/dev-train-alight/fold1_scene1_000_mic000.csv"
    assert (out / first).read_text() == (fused / first).read_text()
    for wav in out.rglob("*.wav"):
        data, sr = wav_read(wav)
        assert sr == 24000 and data.shape == (4, 4 * 24000) and np.abs(data).max() > 100 / 32768


def _shoebox_argv(root: Path, layout: str, out: str) -> list:
    return ["--fg-dir", str(root / "fg"), "--output-dir", str(root / out), "--channel-layout", layout,
            "--n-scenes", "2", "--train-frac", "0.5", "--duration", "4", "--ism-order", "2", "--ir-seconds", "0.1",
            "--max-events-static", "2", "--max-events-moving", "1", "--seed", str(SEED)]


@pytest.fixture(scope="module", params=["mic", "foa"])
def shoebox_run(request, assets):
    layout = request.param
    seconds = seld.main(_shoebox_argv(assets, layout, f"shoebox_{layout}") + ["--device", "cpu"])
    return assets, layout, seconds


def test_shoebox_cli_writes_the_reference_layout_and_wavs(shoebox_run):
    root, layout, seconds = shoebox_run
    out = root / f"shoebox_{layout}"
    assert len(seconds) == 2
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) == _names(layout)
    for wav in out.rglob("*.wav"):
        data, sr = wav_read(wav)
        assert sr == 24000 and data.shape == (4, 4 * 24000)
        with open(wav, "rb") as f:
            assert f.read(36)[20:22] == b"\x01\x00"  # PCM format tag
        assert np.abs(data).max() > 100 / 32768


def test_shoebox_cli_metadata_matches_reference_script(shoebox_run):
    """The reference script's build_scene for the same seed places the same
    shoebox scenes (room sizes, then positions): the same CSV bytes and
    JSON."""
    root, layout, _ = shoebox_run
    sys.path.insert(0, str(REPO / "scripts" / "seld"))
    try:
        sys.modules.pop("generate_dataset", None)  # the other script of that name, if a test loaded it
        gd = importlib.import_module("generate_dataset")
    finally:
        sys.path.remove(str(REPO / "scripts" / "seld"))
    args = seld.build_parser().parse_args(_shoebox_argv(root, layout, f"ref_shoebox_{layout}"))
    args.pipeline = "compiled"
    jutils.seed_everything(SEED)
    rng = np.random.default_rng(SEED)
    for split, fold in (("train", 1), ("test", 2)):
        scene, _, _ = gd.build_scene(args, split, 1, 0, rng)
        for amb in scene.ambience.values():
            amb.load_ambience()  # the render's host bed, drawn before the next scene is placed
        assert scene.state.name == "SHOEBOX" and scene.state.max_order == 2
        stem = root / f"shoebox_{layout}/metadata_dev/dev-{split}-alight/fold{fold}_scene1_000"
        want = json.loads(json.dumps(scene.to_dict()))
        got = json.loads(stem.with_suffix(".json").read_text())
        want.pop("creation_time"), got.pop("creation_time")
        assert got == want
        csv = generate_dcase2024_metadata(scene)["mic000"].to_csv(sep=",", encoding="utf-8", header=None)
        assert Path(f"{stem}_mic000.csv").read_text() == csv


AUGS = ["pitchshift", "speedup", "reverse", "invert", "distortion"]


@pytest.mark.parametrize("backend,flags", [
    ("rlr", ["--pipeline", "classic"]),
    ("rlr", ["--augmentations", *AUGS]),
    ("shoebox", ["--pipeline", "classic", "--augmentations", *AUGS]),
], ids=["rlr classic", "rlr augmentations", "shoebox classic augmentations"])
def test_cli_classic_and_augmentations_match_reference_script(assets, backend, flags):
    """`--pipeline classic` (every scene through the classic per-event
    render) and `--augmentations` (one augmentation per event from the
    reference script's table) run and write the reference's layout, WAVs
    with sound; the reference script's build_scene for the same seed and
    flags places the same scenes with the same augmentations (their
    parameters in the JSON): the same CSV bytes and JSON. A render that
    draws its bed on the host (the classic render, the shoebox's plan path)
    draws it from numpy's global stream before the next scene is placed, as
    the reference script's does; the classic render's simulate() refreshes
    the emitters' coordinates relative to the mic before the JSON is
    written, as the reference's does."""
    name = f"{backend}_{'_'.join(f.strip('-') for f in flags[:3])}"
    argv = (_argv if backend == "rlr" else _shoebox_argv)(assets, "mic", name) + flags
    seconds = seld.main(argv + ["--device", "cpu"])
    out = assets / name
    assert len(seconds) == 2
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) == _names("mic")
    for wav in out.rglob("*.wav"):
        data, sr = wav_read(wav)
        assert sr == 24000 and data.shape == (4, 4 * 24000) and np.abs(data).max() > 100 / 32768

    sys.path.insert(0, str(REPO / "scripts" / "seld"))
    try:
        sys.modules.pop("generate_dataset", None)  # the other script of that name, if a test loaded it
        gd = importlib.import_module("generate_dataset")
    finally:
        sys.path.remove(str(REPO / "scripts" / "seld"))
    args = seld.build_parser().parse_args((_argv if backend == "rlr" else _shoebox_argv)(assets, "mic", f"ref_{name}")
                                          + flags)
    args.pipeline = args.pipeline or ("fused" if backend == "rlr" else "compiled")
    host_bed = backend == "shoebox" or args.pipeline == "classic"
    jutils.seed_everything(SEED)
    rng = np.random.default_rng(SEED)
    n_augmented = 0
    for split, fold in (("train", 1), ("test", 2)):
        scene, _, _ = gd.build_scene(args, split, 1, 0, rng)
        if host_bed:
            for amb in scene.ambience.values():
                amb.load_ambience()
        if args.pipeline == "classic":
            scene.state._update()  # the classic render's simulate() refreshes the relative coordinates
        stem = out / f"metadata_dev/dev-{split}-alight/fold{fold}_scene1_000"
        want = json.loads(json.dumps(scene.to_dict()))
        got = json.loads(stem.with_suffix(".json").read_text())
        want.pop("creation_time"), got.pop("creation_time")
        assert got == want
        n_augmented += sum(len(e["augmentations"]) for e in got["events"].values())
        csv = generate_dcase2024_metadata(scene)["mic000"].to_csv(sep=",", encoding="utf-8", header=None)
        assert Path(f"{stem}_mic000.csv").read_text() == csv
    assert (n_augmented > 0) == ("--augmentations" in flags)
