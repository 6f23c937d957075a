"""The port's SSSEG dataset entry (`python -m audiblelight_tpu_torch.ssseg`) on
the CPU, against the JAX package's script (scripts/ssseg/generate_dataset.py).

A tiny run (two 10 s scenes at 32 kHz, image sources to order 2) from the
same --seed and the same seeded global streams in both: the reference's
file layout (int16 FOA mixtures, JSON and CSV under mixtures/, one float32
dry stem per event under stems/), the JSONs equal (but for the creation
time) and the CSVs byte-identical, each scene's shoebox IRs within 1e-4 of
peak of the reference's (the engines' own agreement), and each dry stem
within 1e-4 of peak of the reference's, starting at its event's direct path.
A second run skips the finished scenes.
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
from audiblelight_tpu.core import Scene as JaxScene
from audiblelight_tpu_torch import ssseg
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.io.audio import wav_read

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = 3
SR = 32000
# The repo's WAVs under DCASE2025Task4 class folders (the script's class mapping)
DCASE2025_LABELS = {"femaleSpeech": "Speech", "maleSpeech": "Speech", "musicInstrument": "MusicalKeyboard",
                    "telephone": "AlarmClock"}


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams:
    leave them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssseg")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        label = DCASE2025_LABELS[wav.parent.name]
        (root / "fg" / label).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / label / wav.name)
    argv = ["--fg-dir", str(root / "fg"), "--n-scenes", "2", "--ism-order", "2", "--seed", str(SEED)]

    tutils.seed_everything(SEED)
    seconds = ssseg.main(argv + ["--output-dir", str(root / "port"), "--device", "cpu"])

    sys.path.insert(0, str(REPO / "scripts" / "ssseg"))
    try:
        sys.modules.pop("generate_dataset", None)  # the other script of that name, if a test loaded it
        gd = importlib.import_module("generate_dataset")
    finally:
        sys.path.remove(str(REPO / "scripts" / "ssseg"))
    ref_scenes = []
    jorig = JaxScene.generate

    def keep(self, *args, **kwargs):
        ref_scenes.append(self)
        return jorig(self, *args, **kwargs)

    JaxScene.generate = keep
    try:
        jutils.seed_everything(SEED)
        args = ssseg.build_parser().parse_args(argv + ["--output-dir", str(root / "ref")])
        rng = np.random.default_rng(args.seed)
        for idx in range(args.n_scenes):
            gd.generate_scene(args, idx, rng)
    finally:
        JaxScene.generate = jorig
    return root, seconds, ref_scenes


def first_arrival(h: np.ndarray) -> int:
    """The first arrival of an impulse response: the peak within 16 samples
    of its first tap at 20 % of its peak or more (near a wall, reflections
    that arrive together can top the direct path)."""
    h = np.abs(h)
    first = int(np.flatnonzero(h >= 0.2 * h.max())[0])
    return first + int(np.argmax(h[first : first + 16]))


def direct_lag(dry: np.ndarray, audio: np.ndarray) -> int:
    """The first arrival (samples) of a dry stem `dry` from its event's
    start: that of its IR window, deconvolved from the event's audio by
    regularised spectral division."""
    n = len(dry) + len(audio)
    a = np.fft.rfft(audio, n)
    h = np.fft.irfft(np.fft.rfft(dry, n) * np.conj(a) / (np.abs(a) ** 2 + 1e-6 * np.abs(a).max() ** 2), n)
    return first_arrival(h[: len(dry)])


def dry_window(ir: np.ndarray, sr: int, low_ms: float = 5, high_ms: float = 50) -> tuple:
    """(window, its start) of a reference-channel IR as compute_dry_audio cuts
    it: [peak - low, peak + high] around the IR's (signed) peak."""
    peak = int(np.argmax(ir))
    lo, hi = max(peak - int(low_ms * sr / 1000), 0), peak + int(high_ms * sr / 1000)
    win = np.zeros_like(ir)
    win[lo:hi] = ir[lo:hi]
    return win, lo


def stem_correlation(dry: np.ndarray, audio: np.ndarray, win: np.ndarray) -> float:
    """Correlation of a dry stem `dry` (its event's span in the scene) with
    its event's audio convolved with the IR window `win`: the stem
    compute_dry_audio makes, up to its scale."""
    n = len(audio) + len(win) - 1
    want = np.fft.irfft(np.fft.rfft(audio, n) * np.fft.rfft(win, n), n)[: len(dry)]
    got = dry[: len(want)]
    return float(np.dot(got, want) / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))


def test_layout_and_formats(runs):
    root, seconds, _ = runs
    assert len(seconds) == 2
    files = lambda d: sorted(str(p.relative_to(root / d)) for p in (root / d).rglob("*") if p.is_file())
    assert files("port") == files("ref")
    assert sum(1 for f in files("port") if f.startswith("stems/")) >= 2
    for wav in (root / "port" / "mixtures").glob("*.wav"):
        with open(wav, "rb") as f:
            assert f.read(36)[20:22] == b"\x01\x00"  # PCM int16
        data, sr = wav_read(wav)
        assert sr == SR and data.shape == (4, 10 * SR) and np.abs(data).max() > 100 / 32768
    for wav in (root / "port" / "stems").rglob("*.wav"):
        with open(wav, "rb") as f:
            header = f.read(36)
        assert header[20:22] == b"\x03\x00" and header[34:36] == b"\x20\x00"  # IEEE float32


def test_metadata_matches_reference_script(runs):
    root, _, _ = runs
    for i in range(2):
        stem = f"mixtures/scene_{i:05d}"
        got = json.loads((root / "port" / f"{stem}.json").read_text())
        want = json.loads((root / "ref" / f"{stem}.json").read_text())
        got.pop("creation_time"), want.pop("creation_time")
        assert got == want
        assert all(e["ref_ir_channel"] == 0 and e["direct_path_time_ms"] == [5, 50] for e in got["events"].values())
        assert (root / "port" / f"{stem}_mic000.csv").read_text() == (root / "ref" / f"{stem}_mic000.csv").read_text()


def test_irs_and_dry_stems_match_reference(runs):
    """The dry stems (the W channel's IR windowed to [peak - 5 ms, peak + 50
    ms], convolved with the event's audio) within 1e-4 of peak of the
    reference's, from IRs within 1e-4 of peak; each is silent before its
    event and correlated (> 0.999) with the event's audio through the
    window of its W IR, and its first arrival (deconvolved from the event's
    audio) is within 2 samples of the direct path's d/c where that window
    holds the direct path."""
    root, _, ref_scenes = runs
    from audiblelight_tpu_torch.core import Scene as PortScene

    assert len(ref_scenes) == 2
    for i, want in enumerate(ref_scenes):
        got = PortScene.from_json(root / "port" / f"mixtures/scene_{i:05d}.json", device="cpu")
        got.state.simulate()
        ir_g = np.asarray(got.state.irs["mic000"])
        ir_w = np.asarray(want.state.irs["mic000"])
        assert ir_g.shape == ir_w.shape and np.abs(ir_g - ir_w).max() <= 1e-4 * np.abs(ir_w).max()
        mic = want.state.microphones["mic000"].coordinates_center
        for wav in sorted((root / "ref" / f"stems/scene_{i:05d}").glob("*.wav")):
            w, _ = wav_read(wav)
            g, _ = wav_read(root / "port" / f"stems/scene_{i:05d}" / wav.name)
            assert g.shape == w.shape == (1, 10 * SR)
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
            alias = wav.name.split("_")[0]
            event = want.events[alias]
            start = round(event.scene_start * SR)
            assert not g[0, :start].any()
            d_c = np.linalg.norm(event.start_coordinates_absolute - mic) / 343.0 * SR
            win, lo = dry_window(ir_w[0, list(want.events).index(alias)], SR)
            assert stem_correlation(g[0, start : round(event.scene_end * SR)], event.load_audio(), win) > 0.999
            if d_c >= lo:  # the window holds the direct path
                assert abs(direct_lag(g[0, start:], event.load_audio()) - d_c) <= 2.0


def test_second_run_skips_finished_scenes(runs):
    root, _, _ = runs
    before = {p: p.stat().st_mtime_ns for p in (root / "port").rglob("*") if p.is_file()}
    argv = ["--fg-dir", str(root / "fg"), "--n-scenes", "2", "--ism-order", "2", "--seed", str(SEED),
            "--output-dir", str(root / "port"), "--device", "cpu"]
    assert ssseg.main(argv) == []
    assert {p: p.stat().st_mtime_ns for p in (root / "port").rglob("*") if p.is_file()} == before
