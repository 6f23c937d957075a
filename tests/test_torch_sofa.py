"""The port's SOFA backend (io/sofa.py, worldstate/sofa_backend.py) against
the JAX package's.

Both packages read the same files, written by the reference's `write_sofa`
(the port reads them with its own HDF5 reader):

- the world state: the same seed places the same emitters (their `sofa_idx`
  and positions), defines the same grid-snapped trajectories and gives the
  same `to_dict`; each package's dict loads into the other; `get_irs` is
  identical at the file's rate and within 1e-12 when it resamples; a point
  far from the grid logs the reference's error;
- the golden scene of tests/golden_gen.py built with the port's Scene: its
  DCASE CSV equals tests/fixtures/golden_dcase.csv byte for byte; with the
  ambience off its plan path's float stems are the reference's within 1e-5
  of peak, and its mix (`render_scene_audio_compiled`, after both packages
  quantise the stems to int16) within one int16 step of the stems, 1 LSB
  as a WAV; its pink bed has the reference's slope and level;
- the SELD CLI with `--backend sofa --device cpu` writes the reference
  script's file set from one file; the reference script itself stops at
  `scene.add_microphone` on a SOFA state (its validate_kwargs refuses the
  base class's `*args, **kwargs`), so the port's run is held to the files
  the reference's layout names and to the measured grid.
"""

import json
import logging
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene as JaxScene
from audiblelight_tpu import pipeline as jpipe
from audiblelight_tpu.io.audio import wav_write
from audiblelight_tpu.io.sofa import write_sofa as jax_write_sofa
from audiblelight_tpu.worldstate.sofa_backend import WorldStateSOFA as JaxSOFA
from audiblelight_tpu_torch import pipeline as tpipe
from audiblelight_tpu_torch import seld
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.io.audio import wav_read
from audiblelight_tpu_torch.io.sofa import SOFAFile
from audiblelight_tpu_torch.synthesize import dcase_csv_text, generate_dcase2024_metadata
from audiblelight_tpu_torch.utils import cartesian_to_polar
from audiblelight_tpu_torch.worldstate import get_worldstate_from_string
from audiblelight_tpu_torch.worldstate.sofa_backend import WorldStateSOFA

torch.set_num_threads(1)

SR = 24000
REPO = Path(__file__).resolve().parents[1]
LISTENER = [2.6, 2.1, 1.3]  # off the measured grid


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """A measured room on a 12 x 8 x 2 grid around the listener, 4 capsules,
    300 samples at 48 kHz: a spike at d/c and a decaying tail."""
    rng = np.random.default_rng(0)
    grid = np.stack(np.meshgrid(np.arange(1, 4, 0.25), np.arange(1, 3, 0.25), [1.0, 1.5], indexing="ij"),
                    -1).reshape(-1, 3)
    irs = rng.standard_normal((len(grid), 4, 300)) * 0.02 * np.exp(-np.arange(300) / 60.0)
    for m, p in enumerate(grid):
        irs[m, :, int(np.linalg.norm(p - LISTENER) / 343 * 48000)] += 1.0
    path = tmp_path_factory.mktemp("sofa") / "room_mic.sofa"
    jax_write_sofa(path, irs, grid, LISTENER, rng.uniform(-0.02, 0.02, (4, 3)), 48000)
    return path, grid


def _placed(cls, path, sr, **kw):
    state = cls(path, seed=3, sample_rate=sr, **kw)
    state.add_emitters(n_emitters=3)
    state.add_emitter(position=[1.51, 1.24, 1.02], alias="near", keep_existing=True)
    state._add_emitters_without_validating(state.define_trajectory(duration=2.0, velocity=1.0, resolution=2.0),
                                           "moving")
    return state


def _canon(d):
    return json.loads(json.dumps(d))


@pytest.mark.parametrize("sr", [48000, 24000, 44100])
def test_world_state_matches_reference(room, sr):
    path, grid = room
    got, want = _placed(WorldStateSOFA, path, sr, device="cpu"), _placed(JaxSOFA, path, sr)
    assert got.name == want.name == "SOFA" and got.device.type == "cpu"
    assert _canon(got.to_dict()) == _canon(want.to_dict())
    idx = [e.sofa_idx for lst in got.emitters.values() for e in lst]
    assert idx == [e.sofa_idx for lst in want.emitters.values() for e in lst] and len(idx) >= 6
    np.testing.assert_array_equal(
        np.stack([e.coordinates_absolute for lst in got.emitters.values() for e in lst]), grid[idx])
    irs_g, irs_w = got.get_irs()["mic000"], want.get_irs()["mic000"]
    assert irs_g.dtype == np.float64 and irs_g.shape == irs_w.shape == (4, len(idx), round(300 * sr / 48000))
    assert got.ir_read == "rows"
    if sr == 48000:
        np.testing.assert_array_equal(irs_g, irs_w)
    else:
        np.testing.assert_allclose(irs_g, irs_w, rtol=0, atol=1e-12)
    back = WorldStateSOFA.from_dict(_canon(want.to_dict()), device="cpu")
    assert _canon(back.to_dict()) == _canon(want.to_dict())
    assert _canon(JaxSOFA.from_dict(_canon(got.to_dict())).to_dict()) == _canon(got.to_dict())


def test_microphone_and_refusals_match_reference(room):
    path, _ = room
    got, want = WorldStateSOFA(path, device="cpu"), JaxSOFA(path)
    assert got.microphones["mic000"].to_dict() == want.microphones["mic000"].to_dict()
    assert got.microphones["mic000"].channel_layout_type == "mic"
    with pytest.raises(NotImplementedError, match="defined by the SOFA file"):
        got.clear_microphones()
    with pytest.raises(AssertionError, match="valid emitters"):
        got.simulate()
    assert get_worldstate_from_string("sofa") is WorldStateSOFA


def test_far_point_logs_the_reference_error(room, caplog):
    path, grid = room
    got = WorldStateSOFA(path, device="cpu")
    with caplog.at_level(logging.ERROR, logger="audiblelight_tpu_torch"):
        idx = got.get_nearest_source_idx([[9.0, 9.0, 9.0], grid[5]])
    assert list(idx) == list(JaxSOFA(path).get_nearest_source_idx([[9.0, 9.0, 9.0], grid[5]]))
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "audiblelight_tpu_torch" and "Could not find a match" in r.getMessage()]
    assert len(msgs) == 1 and "within 0.1 metres" in msgs[0]


def test_chunked_data_ir_is_read_whole():
    """A chunked Data.IR (the gzip fixture) reads whole; a contiguous one by rows."""
    fixtures = REPO / "tests/resources/torch_sofa"
    with SOFAFile(fixtures / "chunked_gzip.sofa") as f:
        assert f.ir_layout == "chunked" and f.read_ir_rows([3, 1, 3]).shape == (3, 2, 100)
        np.testing.assert_array_equal(f.read_ir_rows([3, 1])[0], f.data_ir[3])
    with SOFAFile(fixtures / "reference_writer.sofa") as f:
        assert f.ir_layout == "contiguous" and f.listener_positions.shape == (12, 3)
        assert f.receiver_positions.shape == (4, 3) and f.get_global_attributes()["ListenerShortName"] == "mic"


# ---------------------------------------------------------------------------
# The golden scene (tests/golden_gen.py)
# ---------------------------------------------------------------------------


def _golden_files(tmp: Path):
    """tests/golden_gen.py's file, grid and audio, drawn the same way."""
    rng = np.random.default_rng(5)
    grid = rng.uniform([1, 1, 1], [4, 3, 2], (8, 3))
    irs = np.zeros((8, 4, 2048))
    for m in range(8):
        for c in range(4):
            d = int(np.linalg.norm(grid[m] - [2.5, 2.0, 1.5]) / 343 * SR)
            irs[m, c, d] = 1.0 / (1 + d / 100)
            tail = 2048 - d - 50
            irs[m, c, d + 50:] = rng.standard_normal(tail) * 0.01 * np.exp(-np.linspace(0, 6, tail))
    sofa_path = jax_write_sofa(tmp / "room_mic.sofa", irs, grid, [2.5, 2.0, 1.5],
                               rng.uniform(-0.02, 0.02, (4, 3)), SR)
    fg = tmp / "fg"
    t = np.arange(SR * 2) / SR
    (fg / "music").mkdir(parents=True)
    wav_write(fg / "music" / "tone.wav", (0.6 * np.sin(2 * np.pi * 440 * t) * np.exp(-t)).astype(np.float32), SR)
    (fg / "maleSpeech").mkdir()
    wav_write(fg / "maleSpeech" / "speech.wav",
              (0.4 * np.sign(np.sin(2 * np.pi * 180 * t)) * np.exp(-0.5 * t)).astype(np.float32), SR)
    return sofa_path, grid, fg


def _golden_scene(scene_cls, sofa_path, grid, fg, ambience=True, **device):
    scene = scene_cls(duration=5.0, sample_rate=SR, backend="sofa", backend_kwargs=dict(sofa=sofa_path, seed=11),
                      fg_path=fg, **device)
    scene.add_event(event_type="static", position=grid[3], alias="ev_static", scene_start=1.0, event_start=0.0,
                    duration=2.0, snr=10.0, filepath=fg / "music" / "tone.wav")
    scene.add_event(event_type="moving", alias="ev_moving", shape="linear", scene_start=2.5, event_start=0.0,
                    duration=1.5, snr=8.0, filepath=fg / "maleSpeech" / "speech.wav", spatial_resolution=2.0,
                    spatial_velocity=1.0)
    if ambience:
        scene.add_ambience(noise="pink")
    return scene


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return _golden_files(tmp_path_factory.mktemp("golden"))


def test_golden_scene_csv_is_the_fixture(golden):
    got = _golden_scene(PortScene, *golden, device="cpu")
    csv = dcase_csv_text(generate_dcase2024_metadata(got)[got.state.mic_alias])
    assert csv == (REPO / "tests/fixtures/golden_dcase.csv").read_text()
    want = _golden_scene(JaxScene, *golden)
    d_got, d_want = _canon(got.to_dict()), _canon(want.to_dict())
    d_got.pop("creation_time"), d_want.pop("creation_time")
    assert d_got == d_want
    assert got.get_ambience("ambience000").channels == want.get_ambience("ambience000").channels == 4


def _float_stems(render_fn, plan):
    return render_fn(plan.static_audio, plan.static_irs, plan.static_mask, plan.static_snr, plan.static_len,
                     plan.static_place_len, plan.moving_audio, plan.moving_irs, plan.moving_w, plan.moving_mask,
                     plan.moving_snr, plan.moving_len, plan.moving_place_len, plan.ref_db)


def test_golden_scene_plan_path_matches_reference(golden):
    """Without the ambience, the port's plan path is the reference's: the IR
    banks identical, the float stems within 1e-5 of peak, and the scene mix
    of `render_scene_audio_compiled` within one int16 step of each stem
    (both packages quantise the stems to int16 before the mix: a rounding
    that lands on the other side of a step moves a sample by 1/32767 of
    its stem's peak) and within 1 LSB once written as int16."""
    from audiblelight_tpu.render import build_scene_plan as jax_build_scene_plan
    from audiblelight_tpu.render import render_event_stems_arrays as jax_stems
    from audiblelight_tpu_torch.render import build_scene_plan, quantize_mix_wav, render_event_stems_arrays

    got = _golden_scene(PortScene, *golden, ambience=False, device="cpu")
    want = _golden_scene(JaxScene, *golden, ambience=False)
    plan_g, plan_w = build_scene_plan(got, plan_path=True), jax_build_scene_plan(want)
    for name in ("static_irs", "moving_irs"):
        np.testing.assert_array_equal(getattr(plan_g, name).numpy(), np.asarray(getattr(plan_w, name)))
    stems_g, stems_w = _float_stems(render_event_stems_arrays, plan_g).numpy(), np.asarray(_float_stems(jax_stems,
                                                                                                         plan_w))
    gap = float(np.abs(stems_g - stems_w).max() / np.abs(stems_w).max())
    print(f"golden SOFA scene, float stems: max |diff| / peak {gap:.2e}")
    assert stems_g.shape == stems_w.shape and gap <= 1e-5
    a_got = tpipe.render_scene_audio_compiled(got, plan_g)["mic000"]
    a_want = np.asarray(jpipe.render_scene_audio_compiled(want, plan_w)["mic000"])
    assert a_got.shape == a_want.shape == (4, 5 * SR) and np.abs(a_want).max() > 1e-3
    step = np.abs(stems_w).max(axis=(1, 2)).sum() / 32767
    assert np.abs(a_got - a_want).max() <= 1.01 * step
    wav_g = quantize_mix_wav(torch.from_numpy(a_got)).numpy().astype(np.int32)
    wav_w = quantize_mix_wav(torch.from_numpy(a_want)).numpy().astype(np.int32)
    assert np.abs(wav_w).max() > 100 and np.abs(wav_g - wav_w).max() <= 1


def _psd_slope(x, sr):
    spec = np.abs(np.fft.rfft(x, axis=-1)) ** 2
    f = np.fft.rfftfreq(x.shape[-1], 1 / sr)
    band = (f > 50) & (f < 5000)
    return np.polyfit(np.log10(f[band]), np.log10(spec.mean(axis=0)[band]), 1)[0]


def test_golden_scene_ambience_matches_reference_statistically(golden, tmp_path):
    """The host pink bed (drawn from another stream) has the reference's
    spectral slope and level; `generate` writes the reference's files."""
    from audiblelight_tpu.render import build_scene_plan as jax_build_scene_plan
    from audiblelight_tpu_torch.render import build_scene_plan

    got = _golden_scene(PortScene, *golden, device="cpu")
    want = _golden_scene(JaxScene, *golden)
    bed_g = build_scene_plan(got, plan_path=True).ambience
    bed_w = np.asarray(jax_build_scene_plan(want).ambience)
    assert bed_g.shape == bed_w.shape == (4, 5 * SR)
    assert abs(_psd_slope(bed_g, SR) - _psd_slope(bed_w, SR)) < 0.1 and _psd_slope(bed_g, SR) < -0.7
    np.testing.assert_allclose(np.abs(bed_g).mean(), np.abs(bed_w).mean(), rtol=0.05)
    got.generate(output_dir=tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "audio_out_mic000.wav", "metadata_out.json", "metadata_out_mic000.csv"]
    assert (tmp_path / "metadata_out_mic000.csv").read_text() == (REPO / "tests/fixtures/golden_dcase.csv").read_text()
    data, sr = wav_read(tmp_path / "audio_out_mic000.wav")
    assert sr == SR and data.shape == (4, 5 * SR) and np.abs(data).max() > 100 / 32768


# ---------------------------------------------------------------------------
# The SELD CLI
# ---------------------------------------------------------------------------


def test_cli_writes_the_reference_file_set(room, tmp_path):
    path, grid = room
    fg = tmp_path / "fg"
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (fg / wav.parent.name).mkdir(parents=True, exist_ok=True)
        (fg / wav.parent.name / wav.name).write_bytes(wav.read_bytes())
    argv = ["--fg-dir", str(fg), "--output-dir", str(tmp_path / "out"), "--backend", "sofa", "--sofa", str(path),
            "--channel-layout", "mic", "--n-scenes", "2", "--train-frac", "0.5", "--duration", "4",
            "--max-events-static", "2", "--max-events-moving", "1", "--seed", "5", "--device", "cpu"]
    seconds = seld.main(argv)
    assert len(seconds) == 2
    out = tmp_path / "out"
    names = []
    for split, fold in (("train", 1), ("test", 2)):
        stem = f"dev-{split}-alight/fold{fold}_scene1_000"
        names += [f"mic_dev/{stem}_mic000.wav", f"metadata_dev/{stem}.json", f"metadata_dev/{stem}_mic000.csv"]
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) == sorted(names)
    for wav in out.rglob("*.wav"):
        data, sr = wav_read(wav)
        assert sr == SR and data.shape == (4, 4 * SR) and np.abs(data).max() > 100 / 32768
    polar = cartesian_to_polar(grid - np.asarray(LISTENER))
    triples = {(round(a), round(e), round(d * 100)) for a, e, d in polar}
    for meta in out.rglob("*.json"):
        state = json.loads(meta.read_text())["state"]
        assert state["backend"] == "SOFA" and state["sofa"] == str(path)
        for alias, pts in state["emitters"].items():
            assert np.isin(np.round(np.asarray(pts), 9), np.round(grid, 9)).all(axis=1).all(), alias
    for csv in out.rglob("*.csv"):  # a static event's rows: one measured grid point
        tracks = {}
        for line in csv.read_text().splitlines():
            _, cls, src, *pos = (int(v) for v in line.split(","))
            tracks.setdefault((cls, src), set()).add(tuple(pos))
        static = [pos for pos in tracks.values() if len(pos) == 1]
        assert static and all(pos <= triples for pos in static), csv
    with pytest.raises(ValueError, match="--sofa or --assets is required"):
        seld.main(argv[:6] + argv[8:])
    assert not (tmp_path / "out" / "mic_dev" / "dev-train-alight" / "fold1_scene1_001_mic000.wav").exists()
