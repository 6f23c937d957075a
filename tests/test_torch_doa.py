"""The port's MUSIC DOA (audiblelight_tpu_torch/doa.py) and its `music_doa`
entry against the reference's (audiblelight_tpu/doa.py,
scripts/experiments/music_doa.py).

`doa.py` is host numpy in both packages, so the grid, the steering vectors,
the pseudo-spectrum and the estimates are held bit for bit. The entry's
per-trial errors are held to the reference script's for the same seed
within one grid step (5 degrees): the port's shoebox IRs are 1e-4 of peak
from the reference's (tests/test_torch_image_source.py), which can move a
peak to the neighbouring grid direction; the test prints how many trials
agree exactly."""

import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu import doa as ref
from audiblelight_tpu.micarrays import Eigenmike32 as JaxEigenmike32
from audiblelight_tpu_torch import doa as port
from audiblelight_tpu_torch import music_doa

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SR = 16000


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Scenes draw from the global `random`, numpy and torch streams: leave
    them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


def _plane_wave(mic_xyz, az_deg, el_deg, seconds=0.5, seed=0):
    """A far-field two-tone-plus-noise source at (az, el), delayed per capsule
    by fractional-delay FFT shifts."""
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    sig = np.sin(2 * np.pi * 1500 * t) + 0.7 * np.sin(2 * np.pi * 3100 * t) + 0.3 * rng.standard_normal(n)
    direction = np.array([np.cos(np.radians(el_deg)) * np.cos(np.radians(az_deg)),
                          np.cos(np.radians(el_deg)) * np.sin(np.radians(az_deg)), np.sin(np.radians(el_deg))])
    advance = mic_xyz @ direction / 343.0
    freqs = np.fft.rfftfreq(n, 1 / SR)
    spec = np.fft.rfft(sig)
    out = np.stack([np.fft.irfft(spec * np.exp(2j * np.pi * freqs * a), n) for a in advance])
    return out + 0.01 * rng.standard_normal(out.shape)


def test_grid_and_steering_equal_the_reference():
    np.testing.assert_array_equal(port.direction_grid(), ref.direction_grid())
    np.testing.assert_array_equal(port.direction_grid(36, 9, (-60.0, 30.0)), ref.direction_grid(36, 9, (-60.0, 30.0)))
    mic = JaxEigenmike32().coordinates_cartesian
    dirs = ref.direction_grid()
    np.testing.assert_array_equal(port.steering_vectors(mic, dirs, 2000.0), ref.steering_vectors(mic, dirs, 2000.0))


@pytest.mark.parametrize("az,el,n_sources", [(40.0, 0.0, 1), (-125.0, 20.0, 1), (100.0, -10.0, 2)])
def test_music_spectrum_and_estimate_equal_the_reference(az, el, n_sources):
    mic = JaxEigenmike32().coordinates_cartesian
    audio = _plane_wave(mic, az, el, seed=int(abs(az)))
    if n_sources == 2:
        audio = audio + 0.8 * _plane_wave(mic, az - 150.0, 0.0, seed=7)
    got_p, got_d = port.music_spectrum(audio, mic, SR, n_sources=n_sources)
    want_p, want_d = ref.music_spectrum(audio, mic, SR, n_sources=n_sources)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_d, want_d)
    got = port.estimate_doa(audio, mic, SR, n_sources=n_sources, nfft=512, freq_range=(800.0, 3500.0))
    want = ref.estimate_doa(audio, mic, SR, n_sources=n_sources, nfft=512, freq_range=(800.0, 3500.0))
    np.testing.assert_array_equal(got, want)
    assert abs((got[0, 0] - az + 180) % 360 - 180) <= 10.0


def _reference_script():
    spec = importlib.util.spec_from_file_location("ref_music_doa", REPO / "scripts/experiments/music_doa.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_music_doa_entry_matches_the_reference_script(monkeypatch, capsys):
    """Four azimuths at seed 0: each trial's error equal to the reference
    script's, or within one 5-degree grid step, and the summary line's form."""
    ref_script = _reference_script()
    trials = []
    run_trial = ref_script.run_trial

    def recorded(az_gt, fg, seed):
        trials.append(run_trial(az_gt, fg, seed))
        return trials[-1]

    monkeypatch.setattr(ref_script, "run_trial", recorded)
    monkeypatch.setattr("sys.argv", ["music_doa.py", "--n-azimuths", "4", "--seed", "0"])
    ref_script.main()
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    got = music_doa.main(["--n-azimuths", "4", "--seed", "0", "--device", "cpu"])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    exact = sum(g == w for g, w in zip(got, trials))
    print(f"music_doa: port {got}, reference {trials}; {exact} of {len(got)} trials equal")
    assert len(got) == len(trials) == 4
    np.testing.assert_allclose(got, trials, atol=5.0)
    assert got_line.split("=")[0] == want_line.split("=")[0] == "mean_error_deg"
    if exact == len(got):
        assert got_line == want_line
    assert max(got) <= 20.0
