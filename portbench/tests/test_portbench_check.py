"""The output check on the CPU at a tiny size: the reference agrees with
the port, the control fails the limit, and a run whose timed path is broken
underneath (the mix altered where it is made, the engine's responses a
sample late) reads `correct` false. A backend's reference may report
numbers of its own: each is held to its limit, and one with no reading
fails.

    python -m pytest portbench/tests -p no:cacheprovider
"""

from __future__ import annotations

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, manifest
from portbench.control import readings
from portbench.reference.audio import payload_gap
from portbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]

# Tiny sizes: 4 s scenes of one static and one moving event, 0.1 s IRs of
# image order 2. The events are loud (SNR 25-30 dB), as the cells' loudest
# events are: in a scene of two quiet events bfloat16's relative error stays
# under an int16 step or two, which no payload comparison can see
TINY_MIX = dict(static=1, moving=1, moving_seconds=2.0, static_seconds=[1.0, 1.5], trajectory_length_m=[1.5, 1.9],
                clips=2, clip_seconds=2.0, ring=3, snr_db=[25.0, 30.0])
TINY = {
    "shoebox_foa.dcase5": dict(
        duration_s=4.0,
        engine=dict(manifest.load_config("shoebox_foa")["engine"], max_order=2, max_ir_length=0.1),
        pipeline=dict(manifest.load_config("shoebox_foa")["pipeline"],
                      plan_kwargs=dict(max_static=16, max_moving=8, max_traj=32, pad_audio_seconds=2.0))),
}
CELLS = list(TINY)


def _limit(workload: str) -> int:
    cell = manifest.cell(manifest.load_manifest(ROOT), workload)
    return manifest.load_config(cell["config"])["check"]["payload_gap_lsb"]


def _run(workload: str, seed: int) -> dict:
    return run_cell(workload, seed, 8.0, False, ROOT, device="cpu", config_overrides=TINY[workload],
                    mix_overrides=TINY_MIX)


@pytest.fixture(autouse=True)
def _streams():
    """Runs seed numpy's global stream (the host bed): restore it after."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


@pytest.mark.parametrize("workload", CELLS)
def test_the_reference_equals_the_port_on_the_cpu(workload):
    r = _run(workload, 2**33 + 5)
    assert r["correct"], r["check"]
    # float32 against float64: a WAV sample truncated on the other side of
    # an int16 step, and a stem's int16 step rounded the other way
    assert r["check"]["payload_gap_lsb"]["value"] <= 2
    assert r["check"]["scenes_checked"]["value"] >= 1 and r["failed"] == 0
    # The line's check: the one number beside its limit, then the scenes
    assert list(r["check"]) == ["payload_gap_lsb", "scenes_checked"]
    assert r["check"]["payload_gap_lsb"]["limit"] == _limit(workload) and r["check"]["scenes_checked"]["limit"] == 1


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limit(workload):
    for r in readings(workload, [11, 12, 13], ROOT, device="cpu", config_overrides=TINY[workload],
                      mix_overrides=TINY_MIX):
        assert r["payload_gap_lsb"] > _limit(workload), r


def _stand_in(monkeypatch, numbers=None):
    """A backend `standin` whose reference renders a fixed payload and,
    given `numbers`, reports them beside the payload gap."""
    ref = types.ModuleType("portbench.reference.standin")
    ref.render = lambda config, spec, clips, bed_seed, device, lowp: np.zeros((4, 100), np.int16)
    if numbers is not None:
        ref.numbers = lambda program, reference: dict(payload_gap_lsb=payload_gap(program, reference), **numbers)
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    return dict(backend="standin", check=dict(payload_gap_lsb=12, tail_db=1.0, sample=2))


SPEC = dict(bed_seed=0)


def _kept(*gaps):
    """A sample of scenes whose program payloads lie `gaps` int16 steps off."""
    return [(dict(index=i), np.full((4, 100), g, np.int16)) for i, g in enumerate(gaps)]


@pytest.mark.parametrize("tail,correct", [(0.5, True), (1.5, False)])
def test_a_reference_number_is_held_to_its_limit(tail, correct, monkeypatch):
    config = _stand_in(monkeypatch, dict(tail_db=tail))
    numbers = check.compare(config, {0: SPEC, 1: SPEC}, [], _kept(3, 5), "cpu")
    assert numbers == dict(payload_gap_lsb=5, tail_db=tail, checked=2)
    ok, table = check.judge(config["check"], numbers)
    assert ok is correct and table == dict(payload_gap_lsb=dict(value=5, limit=12), tail_db=dict(value=tail, limit=1.0),
                                           scenes_checked=dict(value=2, limit=1))
    assert not check.judge(config["check"], dict(numbers, payload_gap_lsb=13))[0]


def test_a_limited_number_with_no_reading_reads_incorrect(monkeypatch):
    config = _stand_in(monkeypatch)  # the reference reports the payload gap alone
    numbers = check.compare(config, {0: SPEC}, [], _kept(1), "cpu")
    assert numbers == dict(payload_gap_lsb=1, checked=1)
    ok, table = check.judge(config["check"], numbers)
    assert not ok and table["tail_db"] == dict(value=None, limit=1.0)
    assert not check.judge(dict(payload_gap_lsb=12), dict(checked=0))[0]


def test_the_shoebox_check_reads_as_before():
    config = manifest.load_config("shoebox_foa")
    assert check.numbers_of(config)(np.zeros((4, 9), np.int16), np.full((4, 9), -7, np.int16)) == dict(payload_gap_lsb=7)
    ok, table = check.judge(config["check"], dict(payload_gap_lsb=1, checked=2))
    assert ok and list(table.items()) == [("payload_gap_lsb", dict(value=1, limit=12)),
                                          ("scenes_checked", dict(value=2, limit=1))]


def _alter_plan(orig):
    def broken(plan, q, scales):
        mixed = orig(plan, q, scales)
        mixed[:, mixed.shape[1] // 2] += 256 / 32767
        return mixed
    return broken


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_where_it_is_made_reads_incorrect(workload, monkeypatch):
    from audiblelight_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "mix_plan_host", _alter_plan(pipeline.mix_plan_host))
    r = _run(workload, 2**33 + 6)
    assert not r["correct"] and r["check"]["payload_gap_lsb"]["value"] >= 256


@pytest.mark.parametrize("workload", CELLS)
def test_responses_one_sample_late_read_incorrect(workload, monkeypatch):
    from audiblelight_tpu_torch.worldstate import shoebox_backend

    orig = shoebox_backend.shoebox_rirs
    monkeypatch.setattr(shoebox_backend, "shoebox_rirs", lambda *a, **k: torch.roll(orig(*a, **k), 1, dims=-1))
    r = _run(workload, 2**33 + 7)
    assert not r["correct"] and r["check"]["payload_gap_lsb"]["value"] > _limit(workload)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "shoebox_foa.dcase5", "--seed",
                          str(2**32 + 1), "--seconds", "3", "--trace", "1"], cwd=ROOT, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert list(r)[-1] == "check"
