"""The port's shoebox backend (worldstate/shoebox_backend.py) and a shoebox
Scene against the JAX package's.

The world states take the same absorption in all five forms to the same
(6, B) table, and the same points to the same validity mask and line of
sight. The same Scene is built in both packages from the same seeds, calls
and folder of WAVs: placement draws only from host streams, so both place
the same events at the same positions (1e-6 m), `to_dict` is identical (but
for the creation time) and the DCASE CSV byte-identical. IRs, the plan
path's IR banks among them, are held within 1e-4 of the reference's peak,
as tests/test_torch_image_source.py holds the engine; the plans' other
fields agree to 1e-6 (audio exactly); the plan path's mix without its
ambience within 1 LSB of int16; the host ambience bed, drawn from the
global numpy stream after a different number of draws, by its spectral
slope and level.
"""

import json
import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene as JaxScene
from audiblelight_tpu import pipeline as jpipe
from audiblelight_tpu import utils as jutils
from audiblelight_tpu.render import build_scene_plan as jax_build_scene_plan
from audiblelight_tpu.synthesize import generate_dcase2024_metadata as jax_dcase
from audiblelight_tpu.worldstate.shoebox_backend import WorldStateShoebox as JaxShoebox
from audiblelight_tpu_torch import pipeline as tpipe
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.render import build_scene_plan, quantize_mix_wav
from audiblelight_tpu_torch.synthesize import dcase_csv_text, generate_dcase2024_metadata
from audiblelight_tpu_torch.worldstate import get_worldstate_from_string
from audiblelight_tpu_torch.worldstate.shoebox_backend import WorldStateShoebox
from audiblelight_tpu_torch.worldstate.sofa_backend import WorldStateSOFA

torch.set_num_threads(1)

SR = 24000
REPO = Path(__file__).resolve().parents[1]
PLAN_KW = dict(max_static=4, max_moving=1, max_traj=32, pad_audio_seconds=2.0)
BOX = dict(dimensions=[6.0, 4.5, 3.0], max_order=2, max_ir_length=0.1, seed=11)


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


def _gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("absorption", [
    0.25, "Carpet", np.linspace(0.1, 0.6, 6), np.random.default_rng(0).uniform(0.05, 0.9, (6, 4)),
    {"x0": 0.5, "yL": "Brick", "zL": 0.05},
], ids=["scalar", "material", "per-wall", "per-wall-per-band", "dict"])
def test_absorption_forms_match_reference(absorption):
    got = WorldStateShoebox(absorption=absorption, device="cpu").absorption
    want = JaxShoebox(absorption=absorption).absorption
    assert got.shape == want.shape == (6, 4)
    np.testing.assert_array_equal(got, want)


def test_backend_resolves_by_name_and_sofa_raises():
    """Each backend resolves by name as the reference's does: "sofa", which
    raised until the SOFA backend was ported, now resolves to it (held to
    the reference in test_torch_sofa.py), and an unknown name raises."""
    from audiblelight_tpu.worldstate import get_worldstate_from_string as jax_get

    assert get_worldstate_from_string("shoebox") is WorldStateShoebox
    assert get_worldstate_from_string("sofa") is WorldStateSOFA
    for name in ("shoebox", "SOFA", "rlr"):
        assert get_worldstate_from_string(name).name == jax_get(name).name
    with pytest.raises(ValueError, match="Cannot find backend"):
        get_worldstate_from_string("pyroomacoustics")


def test_validity_mask_and_line_of_sight_match_reference():
    """The closed-form mask (surface margin, distance to the mic, its
    capsules and the emitters) and line of sight, on points inside, near the
    walls and outside the room."""
    rng = np.random.default_rng(2)
    got = WorldStateShoebox(seed=3, dimensions=BOX["dimensions"], device="cpu")
    want = JaxShoebox(seed=3, dimensions=BOX["dimensions"])
    for ws in (got, want):
        ws.add_microphone(microphone_type="ambeovr", position=[3.0, 2.0, 1.5])
        ws.add_emitter(position=[1.0, 1.0, 1.0])
    pts = rng.uniform(-0.5, np.array(BOX["dimensions"]) + 0.5, (4000, 3))
    mask = got._get_valid_positions_mask(pts)
    np.testing.assert_array_equal(mask, want._get_valid_positions_mask(pts))
    assert 0.3 < mask.mean() < 0.9
    for a, b in zip(pts[:200], pts[200:400]):
        assert got.path_exists_between_points(a, b) is want.path_exists_between_points(a, b)


def _placed_states():
    out = []
    for cls, kw in ((WorldStateShoebox, dict(device="cpu")), (JaxShoebox, {})):
        ws = cls(absorption="Carpet", **BOX, **kw)
        ws.add_microphone(microphone_type="ambeovr", alias="mic")
        ws.add_emitters(n_emitters=3, keep_existing=True)
        out.append(ws)
    return out


def test_to_dict_and_from_dict_match_reference():
    """The same seed places the same mic and emitters; `to_dict` equals the
    reference's, and each package's dict loads into the other and gives it
    back."""
    got, want = _placed_states()
    d_got, d_want = json.loads(json.dumps(got.to_dict())), json.loads(json.dumps(want.to_dict()))
    assert d_got == d_want
    back = WorldStateShoebox.from_dict(d_want, device="cpu")
    assert json.loads(json.dumps(back.to_dict())) == d_want and back.device.type == "cpu"
    assert json.loads(json.dumps(JaxShoebox.from_dict(d_got).to_dict())) == d_got


@pytest.mark.parametrize("mic", ["ambeovr", "foalistener", "hoalistener", "binaural"])
def test_get_irs_match_reference(mic):
    """Each rig's IRs on the state's device: the AmbeoVR omni at its four
    capsules, FOA, HOA3 and the analytic head at its centre."""
    states = []
    for cls, kw in ((WorldStateShoebox, dict(device="cpu")), (JaxShoebox, {})):
        ws = cls(sample_rate=SR, absorption=[0.2, 0.3, 0.4, 0.25, 0.5, 0.1], **BOX, **kw)
        ws.add_microphone(microphone_type=mic, position=[3.1, 2.2, 1.4], alias="m")
        ws.add_emitters(n_emitters=2, keep_existing=True)
        ws.simulate()
        states.append(ws)
    got, want = states[0].irs["m"], states[1].irs["m"]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu" and got.dtype == torch.float32
    assert states[0].microphones["m"].irs is got
    gap = _gap(got.numpy(), want)
    print(f"{mic}: {tuple(got.shape)}, max |diff| / peak {gap:.2e}")
    assert gap <= 1e-4


@pytest.fixture(scope="module")
def fg(tmp_path_factory):
    root = tmp_path_factory.mktemp("fg")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / wav.parent.name / wav.name)
    return root


def _build(scene_cls, seed_everything, fg, mic, **device):
    seed_everything(7)
    scene = scene_cls(duration=8.0, sample_rate=SR, backend="shoebox", fg_path=fg, max_overlap=2,
                      backend_kwargs=dict(BOX), **device)
    scene.add_microphone(microphone_type=mic)
    for event_type in ("static", "static", "static", "moving"):
        try:
            scene.add_event(event_type=event_type, max_place_attempts=100)
        except ValueError:
            pass
    scene.add_ambience(noise="gaussian")
    return scene


def _canon(d: dict) -> dict:
    d = json.loads(json.dumps(d))
    d.pop("creation_time")
    return d


@pytest.fixture(scope="module", params=["ambeovr", "foalistener"])
def scenes(request, fg):
    want = _build(JaxScene, jutils.seed_everything, fg, request.param)
    got = _build(PortScene, tutils.seed_everything, fg, request.param, device="cpu")
    return got, want


def test_scene_placement_to_dict_and_csv_match_reference(scenes):
    got, want = scenes
    assert got.state.name == "SHOEBOX" and len(want.events) >= 3 and any(e.is_moving for e in want.events.values())
    (m_got,), (m_want,) = got.state.microphones.values(), want.state.microphones.values()
    np.testing.assert_allclose(m_got.coordinates_absolute, m_want.coordinates_absolute, rtol=0, atol=1e-6)
    for alias, ems in want.state.emitters.items():
        np.testing.assert_allclose(np.stack([e.coordinates_absolute for e in got.state.emitters[alias]]),
                                   np.stack([e.coordinates_absolute for e in ems]), rtol=0, atol=1e-6)
    assert list(got.events) == list(want.events)
    assert _canon(got.to_dict()) == _canon(want.to_dict())
    text = jax_dcase(want)["mic000"].to_csv(sep=",", encoding="utf-8", header=None)
    assert len(text.splitlines()) > 10
    assert dcase_csv_text(generate_dcase2024_metadata(got)["mic000"]) == text
    assert got.get_ambience("ambience000").channels == want.get_ambience("ambience000").channels == 4


def _psd_slope(x, sr):
    """Slope of log10 power against log10 frequency over 50 Hz - 5 kHz."""
    spec = np.abs(np.fft.rfft(x, axis=-1)) ** 2
    f = np.fft.rfftfreq(x.shape[-1], 1 / sr)
    band = (f > 50) & (f < 5000)
    return np.polyfit(np.log10(f[band]), np.log10(spec.mean(axis=0)[band]), 1)[0]


def test_plan_path_matches_reference(scenes):
    """The plan path's plan against the reference's `build_scene_plan` (which
    simulates the shoebox's IRs): IR banks within 1e-4 of peak, the other
    fields to 1e-6; its mix without the ambience within 1 LSB of int16; the
    host bed white at the reference's level."""
    got, want = scenes
    plan_w = jax_build_scene_plan(want, **PLAN_KW)
    plan_g = build_scene_plan(got, plan_path=True, **PLAN_KW)
    for name in ("static_irs", "moving_irs"):
        gap = _gap(getattr(plan_g, name).numpy(), getattr(plan_w, name))
        print(f"{name}: max |diff| / peak {gap:.2e}")
        assert gap <= 1e-4
    np.testing.assert_array_equal(plan_g.static_audio.numpy(), np.asarray(plan_w.static_audio))
    for name in ("static_mask", "static_snr", "static_start", "static_len", "static_place_len", "moving_w",
                 "moving_mask", "moving_snr", "moving_start", "moving_len", "moving_place_len", "ref_db"):
        np.testing.assert_allclose(getattr(plan_g, name).numpy(), np.asarray(getattr(plan_w, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    bed_g, bed_w = plan_g.ambience, np.asarray(plan_w.ambience)
    assert bed_g.shape == bed_w.shape == (4, 8 * SR) and bed_g.dtype == np.float32
    assert abs(_psd_slope(bed_g, SR) - _psd_slope(bed_w, SR)) < 0.1 and abs(_psd_slope(bed_g, SR)) < 0.15
    np.testing.assert_allclose(np.abs(bed_g).mean(), np.abs(bed_w).mean(), rtol=1e-3)
    plan_g.ambience = plan_w.ambience = None
    mix_g = tpipe.mix_plan_host(plan_g, *tpipe.stems_from_plan(plan_g))
    mix_w = jpipe.mix_plan_host(plan_w, *jpipe.stems_from_plan(plan_w))
    wav_g = quantize_mix_wav(torch.from_numpy(mix_g)).numpy().astype(np.int32)
    wav_w = quantize_mix_wav(torch.from_numpy(mix_w)).numpy().astype(np.int32)
    assert np.abs(wav_w).max() > 100 and np.abs(wav_g - wav_w).max() <= 1


@pytest.mark.parametrize("compiled", [False, True], ids=["default", "compiled"])
def test_generate_writes_the_reference_files(scenes, tmp_path, compiled):
    """`Scene.generate` on a shoebox scene (the classic render by default, the
    plan path with `compiled=True`; the fused renderer refuses the state)
    writes the reference's files: an int16 WAV of the rig's 4 channels with
    sound, the JSON and the DCASE CSV."""
    got, want = scenes
    got.generate(output_dir=tmp_path, compiled=compiled)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "audio_out_mic000.wav", "metadata_out.json", "metadata_out_mic000.csv"]
    with open(tmp_path / "audio_out_mic000.wav", "rb") as f:
        header = f.read(44)
    assert header[20:24] == b"\x01\x00\x04\x00" and header[34:36] == b"\x10\x00"  # PCM, 4 channels, 16-bit
    audio = got.audio["mic000"]
    assert audio.shape == (4, 8 * SR) and np.abs(audio).max() * 32768 > 100
    assert _canon(json.loads((tmp_path / "metadata_out.json").read_text())) == _canon(want.to_dict())
    text = jax_dcase(want)["mic000"].to_csv(sep=",", encoding="utf-8", header=None)
    assert (tmp_path / "metadata_out_mic000.csv").read_text() == text
    with pytest.raises(ValueError, match="RLR"):
        tpipe.FusedSceneRenderer.from_scene(got, build_scene_plan(got, **PLAN_KW))
