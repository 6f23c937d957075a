"""The port's 27 event augmentations against the JAX package's, on the CPU.

Under one seed of the global streams, every class draws the reference's
parameters (scipy `rvs()` and `np.random.choice` on numpy's global stream),
so `to_dict` is identical; each package's `from_dict` loads the other's
dict. On the CPU an augmentation runs the host FX, as the reference does
there, and its output is within 1e-6 of peak of the reference's (the
TimeWarp classes draw Python's `random()` per frame from the same seed).
An Event applies its chain before normalising, as the reference's does;
the validation errors are the reference's; a Scene's events run their
chain on the scene's device, and `add_event(augmentations=<count>)` draws
the same augmentations as the reference's Scene.
"""

import json
import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats

from audiblelight_tpu import augmentation as jaug
from audiblelight_tpu import utils as jutils
from audiblelight_tpu.core import Scene as JaxScene
from audiblelight_tpu.event import Event as JaxEvent
from audiblelight_tpu_torch import augmentation as taug
from audiblelight_tpu_torch import seld
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.event import Event as PortEvent

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 24000
NAMES = [cls.__name__ for cls in jaug.ALL_EVENT_AUGMENTATIONS]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """The augmentations draw from the global `random` and numpy streams:
    leave them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


@pytest.fixture(autouse=True)
def _numpy_fx(monkeypatch):
    """The reference's host FX (its default on the CPU, forced here)."""
    monkeypatch.setenv("AUDIBLELIGHT_FX_BACKEND", "numpy")


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(3)
    t = np.arange(SR) / SR
    x = 0.5 * np.sin(2 * np.pi * 330.0 * t) * np.exp(-t) + 0.05 * rng.standard_normal(SR)
    return x.astype(np.float32)


def _pair(name: str, seed: int = 7):
    random.seed(seed)
    np.random.seed(seed)
    theirs = getattr(jaug, name)(sample_rate=SR)
    random.seed(seed)
    np.random.seed(seed)
    mine = getattr(taug, name)(sample_rate=SR, device="cpu")
    return mine, theirs


def test_the_same_27_classes():
    assert [c.__name__ for c in taug.ALL_EVENT_AUGMENTATIONS] == NAMES and len(NAMES) == 27


@pytest.mark.parametrize("name", NAMES)
def test_parameters_dict_and_output_match_reference(audio, name):
    mine, theirs = _pair(name)
    assert mine.to_dict() == theirs.to_dict()
    assert json.dumps(mine.to_dict()) == json.dumps(theirs.to_dict())
    # Either package loads the other's dict
    assert taug.EventAugmentation.from_dict(theirs.to_dict(), device="cpu").to_dict() == theirs.to_dict()
    assert jaug.EventAugmentation.from_dict(mine.to_dict()).to_dict() == mine.to_dict()
    random.seed(11)
    want = theirs(audio)
    random.seed(11)
    got = mine(audio)
    assert got.shape == want.shape == audio.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1e-30)


def test_event_applies_the_chain_as_reference(tmp_path):
    """The chain runs before the peak normalisation; registering or clearing
    an augmentation drops the cached audio."""
    wav = sorted((REPO / "tests/resources/soundevents").rglob("*.wav"))[0]
    chain = ["Gain", "LowpassFilter", "SpeedUp", "Reverse"]
    np.random.seed(1)
    j_augs = [getattr(jaug, n)(sample_rate=SR) for n in chain]
    np.random.seed(1)
    t_augs = [getattr(taug, n)(sample_rate=SR) for n in chain]
    want = JaxEvent(filepath=wav, alias="e", sample_rate=SR, augmentations=j_augs, duration=1.0)
    got = PortEvent(filepath=wav, alias="e", sample_rate=SR, augmentations=t_augs, duration=1.0, device="cpu")
    assert all(a.device == "cpu" for a in got.get_augmentations())
    w, g = want.load_audio(), got.load_audio()
    assert np.abs(g - w).max() <= 1e-6 and np.abs(g).max() == pytest.approx(1.0, rel=1e-6)
    assert got.get_augmentation(2).name == "SpeedUp"
    with pytest.raises(IndexError):
        got.get_augmentation(9)
    got.clear_augmentation(3)
    assert not got.is_audio_loaded and len(got.augmentations) == 3
    with pytest.raises(IndexError):
        got.clear_augmentation(9)
    got.register_augmentations(taug.Invert)  # a class: made at the event's rate
    assert got.augmentations[-1].sample_rate == SR and got.augmentations[-1].device == "cpu"
    got.clear_augmentations()
    assert got.augmentations == [] and got.to_dict is not None


def test_validation_errors():
    with pytest.raises(ValueError, match="callable"):
        taug.validate_event_augmentation(3)
    with pytest.raises(ValueError, match="instance"):
        taug.validate_event_augmentation(taug.Gain)
    with pytest.raises(ValueError, match="subclass"):
        taug.validate_event_augmentation(lambda x: x)
    with pytest.raises(ValueError, match="sample rate"):
        taug.MP3Compressor(sample_rate=22000)
    with pytest.raises(ValueError, match="shape"):
        taug.Fade(sample_rate=SR, fade_in_shape="square")
    with pytest.raises(KeyError, match="not found"):
        taug.EventAugmentation.from_dict({"name": "Wobble"})
    with pytest.raises(KeyError, match="name"):
        taug.EventAugmentation.from_dict({"gain_db": 3.0})
    wav = sorted((REPO / "tests/resources/soundevents").rglob("*.wav"))[0]
    with pytest.raises(ValueError, match="mismatching sample rate"):
        PortEvent(filepath=wav, alias="e", sample_rate=SR, augmentations=[taug.Gain(sample_rate=16000)])
    with pytest.raises(ValueError, match="not a valid parameter"):
        seld.get_augmentations(["wobble"])


def test_seld_table_is_the_reference_scripts():
    """The SELD CLI's table, its degenerate PitchShift included: -7 semitones always."""
    entries = seld.get_augmentations(list(seld.AUGMENTATIONS))
    assert [cls.__name__ for cls, _ in entries] == ["PitchShift", "SpeedUp", "Reverse", "Invert", "Distortion"]
    assert all(kw["sample_rate"] == SR for _, kw in entries)
    pitch = entries[0][0](**entries[0][1])
    assert pitch.semitones == -7
    assert isinstance(seld.AUGMENTATIONS["speedup"][1]["stretch_factor"], type(stats.uniform(0.9, 0.2)))


@pytest.fixture(scope="module")
def fg(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / wav.parent.name / wav.name)
    return root


def _scene(cls, seed_everything, fg, pool=None, **device):
    seed_everything(5)
    scene = cls(duration=8.0, sample_rate=SR, backend="shoebox", fg_path=fg, max_overlap=3,
                backend_kwargs=dict(dimensions=[6.0, 5.0, 3.0], max_order=1, max_ir_length=0.05, seed=2),
                event_augmentations=pool, **device)
    scene.add_microphone(microphone_type="ambeovr")
    scene.add_event(event_type="static", augmentations=2, max_place_attempts=100)
    scene.add_event(event_type="moving", augmentations=3, max_place_attempts=100)
    scene.add_event(event_type="static", augmentations=[taug.Invert if cls is PortScene else jaug.Invert],
                    max_place_attempts=100)
    return scene


@pytest.mark.parametrize("pool", ["all", "pool"])
def test_scene_draws_the_references_augmentations(fg, pool):
    """`augmentations=<count>` samples from the Scene's pool (or every class)
    with Python's random.sample, as the reference's Scene; the events run
    their chains on the scene's device; the pool's kwargs are validated."""
    j_pool = t_pool = None
    if pool == "pool":
        j_pool = [jaug.Gain, (jaug.Distortion, dict(drive_db=stats.uniform(0, 5))), jaug.Reverse, jaug.Invert]
        t_pool = [taug.Gain, (taug.Distortion, dict(drive_db=stats.uniform(0, 5))), taug.Reverse, taug.Invert]
    want = _scene(JaxScene, jutils.seed_everything, fg, j_pool)
    got = _scene(PortScene, tutils.seed_everything, fg, t_pool, device="cpu")
    for alias, ev in want.events.items():
        mine = got.events[alias]
        assert [a.to_dict() for a in mine.augmentations] == [a.to_dict() for a in ev.augmentations]
        assert all(a.device == got.state.device for a in mine.augmentations)
    assert sum(len(e.augmentations) for e in got.events.values()) == 6
    with pytest.raises(TypeError, match="EventAugmentation"):
        PortScene(duration=8.0, sample_rate=SR, backend="shoebox", event_augmentations=[int], device="cpu",
                  backend_kwargs=dict(dimensions=[6.0, 5.0, 3.0]))
    with pytest.raises(ValueError, match="sample rate"):
        PortScene(duration=8.0, sample_rate=SR, backend="shoebox", device="cpu",
                  event_augmentations=[(taug.Gain, dict(sample_rate=16000))], backend_kwargs=dict(dimensions=[6, 5, 3]))
    # The JSON carries the augmentations both ways
    loaded = PortScene.from_dict(json.loads(json.dumps(want.to_dict())), device="cpu")
    assert [[a.to_dict() for a in e.augmentations] for e in loaded.events.values()] == \
        [[a.to_dict() for a in e.augmentations] for e in want.events.values()]
    assert all(a.device == loaded.state.device for e in loaded.events.values() for a in e.augmentations)
    back = JaxScene.from_dict(json.loads(json.dumps(got.to_dict())))
    assert [[a.to_dict() for a in e.augmentations] for e in back.events.values()] == \
        [[a.to_dict() for a in e.augmentations] for e in got.events.values()]
