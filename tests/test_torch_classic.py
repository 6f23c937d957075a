"""The port's classic per-event render against the JAX package's, on the CPU.

Each function of the classic chain (`ops.convolve.tv_convolve` and
synthesize's level helpers, convolutions, STFT pieces, per-event renders,
dry stems and scene mix) takes the same seeded numpy inputs as its JAX twin
and agrees within 1e-5 of the output's peak (max |diff| / max |want|):
static, moving and emitter-less events, a dry stem and half a dry stem (the
reference's warning, word for word), and the scene mix.

Then whole scenes: a small shoebox scene (its events augmented, the
augmentations run on the host in both packages) and a small rlr scene (128
rays x 4 bounces), placed alike in both packages from the same seeds, go
through `Scene.generate()` (the classic render in both) with the JAX state's
IR banks carried into the port's state: every event's spatial audio, dry
stem and the scene mix within 1e-5 of peak, the int16 WAVs within 1 LSB,
the CSV byte-identical. The port's classic render of a scene and its own
plan path (`generate(compiled=True)`) agree within 5e-3 of peak, the
reference's own bound between its two paths.
"""

import json
import random
import shutil
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene as JaxScene
from audiblelight_tpu import synthesize as jsyn
from audiblelight_tpu import utils as jutils
from audiblelight_tpu.event import Event as JaxEvent
from audiblelight_tpu.io.audio import wav_read as jax_wav_read
from audiblelight_tpu.ops import convolve as jconv
from audiblelight_tpu_torch import synthesize as tsyn
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.event import Event as PortEvent
from audiblelight_tpu_torch.geometry.mesh import save_obj, scanned_like_room
from audiblelight_tpu_torch.io.audio import wav_read
from audiblelight_tpu_torch.ops import convolve as tconv

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 16000
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement and augmentations draw from the global `random`, numpy and
    torch streams: leave them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("classic")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")
    return root


@pytest.fixture(scope="module")
def wav_file(assets):
    return sorted((assets / "fg").rglob("*.wav"))[0]


# ---------------------------------------------------------------------------
# The chain's functions
# ---------------------------------------------------------------------------


def test_level_helpers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 1000)).astype(np.float32)
    np.testing.assert_array_equal(tsyn.apply_snr(x, 12.5), jsyn.apply_snr(x, 12.5))
    assert tsyn.db_to_multiplier(-40.0, 0.123) == jsyn.db_to_multiplier(-40.0, 0.123)
    irs = rng.standard_normal((4, 3, 500)).astype(np.float32)
    assert _rel(tsyn.normalize_irs(irs, device="cpu"), jsyn.normalize_irs(irs)) <= TOL


def test_convolutions_and_stft_match_reference():
    rng = np.random.default_rng(1)
    audio = rng.standard_normal(5000).astype(np.float32)
    ir = rng.standard_normal((700, 4)).astype(np.float32)
    assert _rel(tsyn.time_invariant_convolution(audio, ir, device="cpu"),
                jsyn.time_invariant_convolution(audio, ir)) <= TOL
    for dims_first in (True, False):
        assert _rel(tsyn.stft(audio, stft_dims_first=dims_first, device="cpu"),
                    jsyn.stft(audio, stft_dims_first=dims_first)) <= TOL
    times = np.linspace(0, 0.3, 4)
    np.testing.assert_array_equal(tsyn.generate_interpolation_matrix(times, SR, 128, 50),
                                  jsyn.generate_interpolation_matrix(times, SR, 128, 50))
    s_audio = jsyn.stft(audio)
    irs = rng.standard_normal((4, 4, 300)).astype(np.float32)
    s_ir = jsyn.stft(irs)
    w = jsyn.generate_interpolation_matrix(times, SR, 128, s_audio.shape[0])
    want = jsyn.perform_time_variant_convolution(s_audio, s_ir, w)
    assert _rel(tsyn.perform_time_variant_convolution(s_audio, s_ir, w, device="cpu"), want) <= TOL
    assert _rel(tsyn.istft_overlap_synthesis(want, device="cpu"), jsyn.istft_overlap_synthesis(want)) <= TOL
    # The ops-level moving render against the reference's (overlap-save blocks)
    got = tconv.tv_convolve(torch.as_tensor(audio), torch.as_tensor(irs), w)
    assert _rel(got.numpy(), np.asarray(jconv.tv_convolve(audio, irs, w))) <= TOL


def _events(wav, n_emitters: int, **kwargs):
    """The same Event in both packages, with `n_emitters` emitters on a line."""
    pos = [np.array([1.0 + 0.3 * i, 2.0, 1.5]) for i in range(n_emitters)]
    mine = PortEvent(filepath=wav, alias="ev", emitters=pos or None, sample_rate=SR, snr=17.0, duration=1.5,
                     device="cpu", **kwargs)
    theirs = JaxEvent(filepath=wav, alias="ev", emitters=pos or None, sample_rate=SR, snr=17.0, duration=1.5,
                      **kwargs)
    return mine, theirs


def _bank(n_emitters: int, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    irs = (rng.standard_normal((4, n_emitters, 1600)) * np.exp(-np.arange(1600) / 300.0)).astype(np.float32)
    irs[:, :, 40] += 3.0  # a direct path
    return irs


@pytest.mark.parametrize("n_emitters", [1, 5], ids=["static", "moving"])
def test_render_event_audio_matches_reference(wav_file, n_emitters):
    """render_event_audio (time-invariant for one emitter, time-variant for
    a trajectory), time_variant_convolution, and the dry stem of an event
    with both dry-stem parameters."""
    mine, theirs = _events(wav_file, n_emitters, ref_ir_channel=1, direct_path_time_ms=[2, 20])
    irs = _bank(n_emitters)
    tsyn.render_event_audio(mine, irs, "mic000", ref_db=-50, device="cpu")
    jsyn.render_event_audio(theirs, irs, "mic000", ref_db=-50)
    assert mine.spatial_audio["mic000"].dtype == np.float32
    assert _rel(mine.spatial_audio["mic000"], theirs.spatial_audio["mic000"]) <= TOL
    assert _rel(mine._spatial_audio_dry["mic000"], theirs._spatial_audio_dry["mic000"]) <= TOL
    if n_emitters > 1:
        assert _rel(tsyn.time_variant_convolution(irs, mine, device="cpu"),
                    jsyn.time_variant_convolution(irs, theirs)) <= TOL


def test_render_event_without_emitters_tiles_with_warning(wav_file, caplog):
    """An event with no IRs is tiled over the channels, with the reference's warning."""
    mine, theirs = _events(wav_file, 1)
    irs = np.zeros((4, 0, 100), np.float32)
    with caplog.at_level("WARNING"):
        jsyn.render_event_audio(theirs, irs, "mic000")
        tsyn.render_event_audio(mine, irs, "mic000", device="cpu")
    msgs = {r.name: r.getMessage() for r in caplog.records if "No IRs were found" in r.getMessage()}
    assert msgs["audiblelight_tpu"] == msgs["audiblelight_tpu_torch"]
    assert _rel(mine.spatial_audio["mic000"], theirs.spatial_audio["mic000"]) <= TOL


@pytest.mark.parametrize("which", ["ref_ir_channel", "direct_path_time_ms"])
def test_half_a_dry_stem_warns_as_reference(wav_file, caplog, which):
    kwargs = dict(ref_ir_channel=0) if which == "ref_ir_channel" else dict(direct_path_time_ms=[5, 50])
    mine, theirs = _events(wav_file, 1, **kwargs)
    with caplog.at_level("WARNING"):
        jsyn.compute_dry_audio(theirs, _bank(1), 1.0, "mic000")
        tsyn.compute_dry_audio(mine, _bank(1), 1.0, "mic000", device="cpu")
    msgs = [(r.name, r.getMessage()) for r in caplog.records]
    assert [m for _, m in msgs if _ == "audiblelight_tpu_torch"] == [m for _, m in msgs if _ == "audiblelight_tpu"]
    assert len(msgs) == 2 and not mine._spatial_audio_dry


def test_validate_scene_errors_match_reference():
    """validate_scene raises the reference's errors, in its order."""
    def errors(scene_cls, validate, **device):
        scene = scene_cls(duration=6.0, sample_rate=SR, backend="shoebox",
                          backend_kwargs=dict(dimensions=[6.0, 4.5, 3.0], max_order=1, seed=3), **device)
        out = []
        for step in (lambda: None, lambda: scene.state.add_emitter(position=[1.0, 1.0, 1.0]),
                     lambda: scene.add_microphone(microphone_type="ambeovr", position=[3.0, 2.0, 1.5])):
            step()
            with pytest.raises(ValueError) as err:
                validate(scene)
            out.append(str(err.value))
        return out

    want = errors(JaxScene, jsyn.validate_scene)
    assert errors(PortScene, tsyn.validate_scene, device="cpu") == want
    assert want == ["WorldState has no emitters!", "WorldState has no microphones!", "Scene has no events!"]


# ---------------------------------------------------------------------------
# Whole scenes: the classic render of the same placed scene and IR banks
# ---------------------------------------------------------------------------


def _build(scene_cls, seed_everything, assets, backend: str, **device):
    seed_everything(9)
    if backend == "shoebox":
        kw = dict(backend="shoebox", backend_kwargs=dict(dimensions=[6.0, 4.5, 3.0], max_order=2,
                                                         max_ir_length=0.1, seed=3))
    else:
        kw = dict(backend="rlr", backend_kwargs=dict(
            mesh=str(assets / "room.obj"), seed=11, add_to_context=False,
            rlr_kwargs=dict(indirect_ray_count=128, indirect_ray_depth=4, max_ir_length=0.1)))
    scene = scene_cls(duration=6.0, sample_rate=SR, fg_path=assets / "fg", max_overlap=3, **kw, **device)
    scene.add_microphone(microphone_type="ambeovr")
    augment = 1 if backend == "shoebox" else None
    scene.add_event(event_type="static", max_place_attempts=100, augmentations=augment, ref_ir_channel=0,
                    direct_path_time_ms=[5, 50])
    scene.add_event(event_type="static", max_place_attempts=100, augmentations=augment)
    scene.add_event(event_type="moving", max_place_attempts=100, augmentations=augment)
    scene.add_ambience(noise="gaussian")
    return scene


@pytest.fixture(scope="module", params=["shoebox", "rlr"])
def generated(request, assets, tmp_path_factory):
    backend = request.param
    want = _build(JaxScene, jutils.seed_everything, assets, backend)
    got = _build(PortScene, tutils.seed_everything, assets, backend, device="cpu")
    out_w, out_g = tmp_path_factory.mktemp(f"ref_{backend}"), tmp_path_factory.mktemp(f"port_{backend}")
    want.state.simulate()
    got.state._irs = OrderedDict((k, np.array(v)) for k, v in want.state.irs.items())  # the JAX banks
    got.state._update()  # the engine context, as the JAX state's simulate() set it
    seed_everything_both(5)
    want.generate(output_dir=out_w)
    seed_everything_both(5)
    got.generate(output_dir=out_g)
    return got, want, out_g, out_w


def seed_everything_both(seed: int) -> None:
    jutils.seed_everything(seed)
    tutils.seed_everything(seed)


def test_scene_generate_matches_reference(generated):
    got, want, out_g, out_w = generated
    assert [e.to_dict()["augmentations"] for e in got.events.values()] == \
        [e.to_dict()["augmentations"] for e in want.events.values()]
    assert any(e.is_moving for e in got.events.values())
    for alias, ev in want.events.items():
        mine = got.events[alias]
        assert _rel(mine.spatial_audio["mic000"], ev.spatial_audio["mic000"]) <= TOL, alias
        assert _rel(mine._spatial_audio_padded["mic000"], ev._spatial_audio_padded["mic000"]) <= TOL, alias
        assert mine._spatial_audio_dry.keys() == ev._spatial_audio_dry.keys()
        for mic, dry in ev._spatial_audio_dry_padded.items():
            assert np.abs(mine._spatial_audio_dry_padded[mic]).max() > 0
            assert _rel(mine._spatial_audio_dry_padded[mic], dry) <= TOL, alias
    assert list(got.events.values())[0]._spatial_audio_dry_padded
    assert _rel(got.audio["mic000"], want.audio["mic000"]) <= TOL
    (w_got, _), (w_want, _) = wav_read(out_g / "audio_out_mic000.wav"), jax_wav_read(out_w / "audio_out_mic000.wav")
    lsb = np.abs(np.round(w_got * 32768).astype(np.int64) - np.round(w_want * 32768).astype(np.int64)).max()
    assert lsb <= 1 and np.abs(w_got).max() > 100 / 32768
    assert (out_g / "metadata_out_mic000.csv").read_text() == (out_w / "metadata_out_mic000.csv").read_text()
    mine_json = json.loads((out_g / "metadata_out.json").read_text())
    theirs_json = json.loads((out_w / "metadata_out.json").read_text())
    mine_json.pop("creation_time"), theirs_json.pop("creation_time")
    assert mine_json == theirs_json


def test_classic_against_plan_path(generated, tmp_path):
    """The port's classic render and its plan path on the same scene, IR
    banks (the port's own, simulated by the classic render and reused by the
    plan path) and bed: within 5e-3 of peak, the reference's own bound
    between its two paths."""
    got, _, _, _ = generated
    got.state._irs = None
    for event in got.events.values():
        event.spatial_audio.clear()  # rendered from the JAX banks
    got.generate(output_dir=tmp_path)
    classic = np.array(got.audio["mic000"])
    got.generate(output_dir=tmp_path, compiled=True)
    plan = np.asarray(got.audio["mic000"], dtype=np.float32)
    assert plan.shape == classic.shape and np.abs(classic).max() > 0
    assert float(np.abs(plan - classic).max()) <= 5e-3 * float(np.abs(classic).max())
