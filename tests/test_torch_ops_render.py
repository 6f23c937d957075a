"""The port's convolution, STFT and stem-render functions against the JAX ones.

Inputs are the arrays of JAX ScenePlans (a shoebox scene and a ray-traced box
scene, as tests/test_pipeline.py builds them), handed to both packages as
numpy. Tolerances: float outputs within 1e-5 of the reference's peak
(max-abs, relative); int16 outputs within 1 LSB (a float difference at 1e-7
can flip a rounding). The ambience noise is random in both packages, so it
is held by its spectral slope and level only.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene
from audiblelight_tpu import render as jrender
from audiblelight_tpu.io.audio import wav_write
from audiblelight_tpu.ops.convolve import (
    fft_convolve as j_fft_convolve,
    interpolation_matrix as j_interpolation_matrix,
    time_variant_convolve_spec as j_tv_spec,
)
from audiblelight_tpu.ops.scaling import normalize_irs as j_normalize_irs
from audiblelight_tpu.ops.stft import (
    istft_overlap_add as j_istft,
    n_stft_frames as j_n_stft_frames,
    stft as j_stft,
)
from audiblelight_tpu_torch import render as trender
from audiblelight_tpu_torch.ops import convolve as tconv
from audiblelight_tpu_torch.ops import scaling as tscale

# The module: the ops package exports its `stft` function under the same name
tstft = importlib.import_module("audiblelight_tpu_torch.ops.stft")

torch.set_num_threads(1)

SR = 44100


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def fg_dir(tmp_path_factory):
    rng = np.random.default_rng(1)
    root = tmp_path_factory.mktemp("fg")
    for cls, freq in [("maleSpeech", 220.0), ("music", 660.0)]:
        d = root / cls
        d.mkdir()
        t = np.arange(SR * 3) / SR
        sig = 0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-t * 0.5) + 0.01 * rng.standard_normal(len(t))
        wav_write(d / f"{cls}.wav", sig.astype(np.float32), SR)
    return root


def _add_events(scene, fg_dir, moving_start):
    scene.add_event(
        event_type="static", position=[1.0, 1.0, 1.0], alias="s0",
        scene_start=1.0, event_start=0.0, duration=2.0, snr=10.0,
        filepath=fg_dir / "maleSpeech" / "maleSpeech.wav",
    )
    scene.add_event(
        event_type="moving", alias="m0", shape="linear",
        scene_start=moving_start, event_start=0.0, duration=2.0, snr=8.0,
        spatial_velocity=1.0, spatial_resolution=2.0,
        filepath=fg_dir / "music" / "music.wav",
    )


def _shoebox_plan(fg_dir):
    scene = Scene(
        duration=8.0, backend="shoebox", fg_path=fg_dir,
        backend_kwargs=dict(dimensions=[6.0, 4.0, 3.0], max_order=4, max_ir_length=0.15,
                            frequency_bands=1, seed=0),
    )
    scene.add_microphone(microphone_type="ambeovr", position=[3.0, 2.0, 1.5], alias="m")
    _add_events(scene, fg_dir, 4.0)
    return jrender.build_scene_plan(scene)


def _rlr_box_plan(fg_dir):
    from audiblelight_tpu.geometry.mesh import box_mesh

    scene = Scene(
        duration=6.0, sample_rate=24000, backend="rlr", fg_path=fg_dir,
        backend_kwargs=dict(
            mesh=box_mesh(extents=[6.0, 4.0, 3.0], center=[3.0, 2.0, 1.5]), seed=0,
            rlr_kwargs=dict(indirect_ray_count=200, indirect_ray_depth=6, max_ir_length=0.15,
                            diffraction=False),
        ),
    )
    scene.add_microphone(microphone_type="ambeovr", position=[3.0, 2.0, 1.5], alias="m")
    _add_events(scene, fg_dir, 3.0)
    return jrender.build_scene_plan(scene)


@pytest.fixture(scope="module", params=["shoebox", "rlr_box"])
def plan(request, fg_dir):
    build = _shoebox_plan if request.param == "shoebox" else _rlr_box_plan
    p = build(fg_dir)
    return {k: (v if k in ("ambience", "n_scene_samples") else np.asarray(v)) for k, v in vars(p).items()}


_STEM_FIELDS = (
    "static_audio", "static_irs", "static_mask", "static_snr", "static_len", "static_place_len",
    "moving_audio", "moving_irs", "moving_w", "moving_mask", "moving_snr", "moving_len",
    "moving_place_len", "ref_db",
)


@pytest.fixture(scope="module")
def stems(plan):
    want = np.asarray(jrender.render_event_stems_arrays(*(jnp.asarray(plan[k]) for k in _STEM_FIELDS)))
    p = trender.ScenePlan.from_numpy(plan, "cpu")
    got = trender.render_event_stems_arrays(*(getattr(p, k) for k in _STEM_FIELDS)).numpy()
    return got, want


def test_render_event_stems_arrays(stems):
    got, want = stems
    assert got.dtype == np.float32
    assert np.abs(want).max() > 0
    _close(got, want)


def test_quantize_stems(stems):
    _, want_f = stems
    q_j, s_j = map(np.asarray, jrender.quantize_stems(jnp.asarray(want_f)))
    q_t, s_t = trender.quantize_stems(_t(want_f))
    assert q_t.dtype == torch.int16 and s_t.dtype == torch.float32
    assert np.abs(q_t.numpy().astype(np.int32) - q_j.astype(np.int32)).max() <= 1
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-6)


def test_place_and_quantize_mix(plan, stems):
    _, want_f = stems
    starts = np.concatenate([plan["static_start"], plan["moving_start"]]).astype(np.int32)
    t = int(plan["n_scene_samples"])
    mix_j = np.asarray(jrender.place_stems_device(jnp.asarray(want_f), jnp.asarray(starts), t))
    mix_t = trender.place_stems_device(_t(want_f), _t(starts), t)
    np.testing.assert_array_equal(mix_t.numpy(), mix_j)
    # Scale past full scale so the clip is exercised too
    loud = mix_j * (1.5 / np.abs(mix_j).max())
    w_j = np.asarray(jrender.quantize_mix_wav(jnp.asarray(loud)))
    w_t = trender.quantize_mix_wav(torch.from_numpy(loud)).numpy()
    assert w_t.dtype == np.int16 and np.abs(w_t).max() == 32767
    assert np.abs(w_t.astype(np.int32) - w_j.astype(np.int32)).max() <= 1


def test_normalize_irs_and_fft_convolve(plan):
    irs = plan["static_irs"]
    _close(tscale.normalize_irs(_t(irs)).numpy(), np.asarray(j_normalize_irs(jnp.asarray(irs))))
    audio = plan["static_audio"]
    want = np.asarray(j_fft_convolve(jnp.asarray(audio), jnp.asarray(irs)))
    _close(tconv.fft_convolve(_t(audio), _t(irs)).numpy(), want)


def test_stft_istft_and_time_variant(plan):
    audio = plan["moving_audio"][0]
    irs = plan["moving_irs"][0]  # (C, J, L)
    w = plan["moving_w"][0]
    assert tstft.n_stft_frames(len(audio)) == j_n_stft_frames(len(audio)) == w.shape[0]
    sa_j, si_j = j_stft(jnp.asarray(audio)), j_stft(jnp.asarray(irs))
    sa_t, si_t = tstft.stft(_t(audio)), tstft.stft(_t(irs))
    _close(sa_t.numpy(), np.asarray(sa_j))
    _close(si_t.numpy(), np.asarray(si_j))
    spec_j = j_tv_spec(sa_j, si_j, jnp.asarray(w))
    spec_t = tconv.time_variant_convolve_spec(sa_t, si_t, _t(w))
    _close(spec_t.numpy(), np.asarray(spec_j))
    _close(tstft.istft_overlap_add(spec_t).numpy(), np.asarray(j_istft(spec_j)))


@pytest.mark.parametrize("n_frames", [None, 40])
def test_interpolation_matrix(n_frames):
    times = np.linspace(0, 2.0, 5)
    np.testing.assert_array_equal(
        tconv.interpolation_matrix(times, 24000, 128, n_frames),
        j_interpolation_matrix(times, 24000, 128, n_frames),
    )


def _psd_slope(x, sr):
    """Slope of log10 power against log10 frequency over 50 Hz - 5 kHz."""
    spec = np.abs(np.fft.rfft(x, axis=-1)) ** 2
    f = np.fft.rfftfreq(x.shape[-1], 1 / sr)
    band = (f > 50) & (f < 5000)
    return np.polyfit(np.log10(f[band]), np.log10(spec.mean(axis=0)[band]), 1)[0]


@pytest.mark.parametrize("beta", [0.0, 1.0, 2.0])
def test_ambience_bed_slope_and_level(beta):
    sr, t, ref_db = 24000, 48000, -30.0
    bed_j = np.asarray(jrender.ambience_bed_device(jax.random.PRNGKey(0), beta, ref_db, 4, t))
    gen = torch.Generator().manual_seed(0)
    bed_t = trender.ambience_bed_device(gen, beta, ref_db, 4, t, device="cpu").numpy()
    assert bed_t.shape == bed_j.shape and bed_t.dtype == np.float32
    assert abs(_psd_slope(bed_t, sr) - _psd_slope(bed_j, sr)) < 0.1
    assert abs(_psd_slope(bed_t, sr) + beta) < 0.15
    np.testing.assert_allclose(np.abs(bed_t).mean(), 10 ** (ref_db / 20), rtol=1e-5)
