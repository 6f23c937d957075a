"""The port's acoustic imaging (audiblelight_tpu_torch/imaging.py and
`Scene.generate_acoustic_image`) against the reference's
(audiblelight_tpu/imaging.py, core.py).

Tolerances: the host half (field, steering operator, visibilities, mel
frequencies, the label half) is the reference's numpy and scipy, so it is
held bit for bit. `eigh_max` within rtol 1e-5. The solve (`apgd_solve`,
`get_visibility_matrix`) runs in complex64 in both packages, with matrix
products that XLA and PyTorch sum in other orders, so it is held within
1e-4 of the image's peak. `Scene.generate_acoustic_image` is given the
reference's audio: h5py reads the port's HDF to the reference's dataset
(within 1e-4 of peak), dtype and attributes; with the reference's image
the port writes the reference's JSON and HDF data exactly, since the
labels are host code."""

import json
import random
import shutil
from pathlib import Path

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene as JaxScene
from audiblelight_tpu import imaging as ref
from audiblelight_tpu import utils as jutils
from audiblelight_tpu.micarrays import AmbeoVR as JaxAmbeoVR
from audiblelight_tpu.micarrays import Eigenmike32 as JaxEigenmike32
from audiblelight_tpu_torch import imaging as port
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.micarrays import Eigenmike32

torch.set_num_threads(2)

SR = 24000
REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


def _peak_gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# Host half: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 3, 10])
def test_field_and_steering_equal_the_reference(n):
    np.testing.assert_array_equal(port.fibonacci(n), ref.fibonacci(n))
    np.testing.assert_array_equal(port.fibonacci(n, direction=[0.2, -0.4, 1.0], fo_v=np.deg2rad(100)),
                                  ref.fibonacci(n, direction=[0.2, -0.4, 1.0], fo_v=np.deg2rad(100)))
    np.testing.assert_array_equal(port.get_field(n), ref.get_field(n))
    mic = JaxEigenmike32().coordinates_cartesian.T
    r = ref.get_field(n)
    for kw in ({}, dict(fmin=500, fmax=8000, n_bands=5)):
        np.testing.assert_array_equal(port.steering_operator(mic, r, **kw), ref.steering_operator(mic, r, **kw))
    for bad in (dict(n=-1), dict(n=3, direction=[0, 0, 1]), dict(n=3, direction=[0, 0, 1], fo_v=np.deg2rad(400))):
        with pytest.raises(ValueError):
            ref.fibonacci(**bad)
        with pytest.raises(ValueError):
            port.fibonacci(**bad)


def test_visibilities_and_mel_equal_the_reference():
    rng = np.random.default_rng(3)
    audio = rng.standard_normal((SR, 4))
    for args in ((SR, 0.1, 2000.0, 100.0, 1.0), (SR, 0.01, 3000.0, 50.0, 0.5)):
        np.testing.assert_array_equal(port.extract_visibilities(audio, *args), ref.extract_visibilities(audio, *args))
    np.testing.assert_array_equal(port.form_visibility(audio, SR, 2000.0, 100.0, 0.01, 0.1),
                                  ref.form_visibility(audio, SR, 2000.0, 100.0, 0.01, 0.1))
    np.testing.assert_array_equal(port._mel_frequencies(9, 1500, 4500), ref._mel_frequencies(9, 1500, 4500))
    np.testing.assert_array_equal(port._mel_frequencies(4, 200, 900), ref._mel_frequencies(4, 200, 900))
    with pytest.raises(ValueError):
        port.extract_visibilities(audio, SR, 1e-6, 2000.0, 100.0, 1.0)


def _metadata(rng, n_frames: int, rows: int) -> np.ndarray:
    frames = np.sort(rng.integers(0, n_frames + 2, rows))
    return np.stack([frames, rng.integers(0, 13, rows), rng.integers(0, 3, rows),
                     rng.integers(-180, 180, rows), rng.integers(-60, 60, rows), rng.integers(50, 400, rows)], 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_labels_equal_the_reference(seed):
    """The label half from the same image and DCASE rows: the reference's
    dicts exactly, standardised or not (frames past the image are skipped)."""
    rng = np.random.default_rng(seed)
    img = rng.gamma(0.3, 2e-4, (4 * 16, 3, 6)).astype(np.float32)
    img[rng.integers(0, 64, 5), :, :] += 3e-3
    meta = _metadata(rng, 6, 10)
    kw = dict(resolution=(72, 36), polygon_mask_threshold=4e-5, circle_radius=30.0)
    got, want = port.generate_acoustic_image_json(img, meta, **kw), ref.generate_acoustic_image_json(img, meta, **kw)
    assert got == want and any(d["segmentation"] for d in got)
    assert port.standardise_acoustic_image_amplitude(got) == ref.standardise_acoustic_image_amplitude(want)
    np.testing.assert_array_equal(port.create_target_grid(72, 36), ref.create_target_grid(72, 36))
    np.testing.assert_array_equal(port.create_2d_gaussian(10.5, 3.0, 72, 36), ref.create_2d_gaussian(10.5, 3.0, 72, 36))
    blob = (rng.uniform(size=(36, 72)) > 0.8) * rng.uniform(size=(36, 72))
    assert port.find_segmentations(blob) == ref.find_segmentations(blob)
    np.testing.assert_array_equal(port.sigmoid(np.linspace(-50, 50, 11)), ref.sigmoid(np.linspace(-50, 50, 11)))
    with pytest.raises(ValueError):
        port.create_2d_gaussian(80.0, 3.0, 72, 36)
    with pytest.raises(ValueError):
        port.generate_acoustic_image_json(img[0], meta)


# ---------------------------------------------------------------------------
# The solve: within 1e-4 of the peak
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rig,sh_order", [(JaxAmbeoVR, 3), (JaxEigenmike32, 3), (JaxEigenmike32, 10)])
def test_eigh_max_matches_the_reference(rig, sh_order):
    a = ref.steering_operator(rig().coordinates_cartesian.T, ref.get_field(sh_order))
    got, want = port.eigh_max(a, device="cpu"), ref.eigh_max(a)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_apgd_solve_matches_the_reference_and_recovers_a_point_source():
    """The reference's point-source recovery on the port (a plane wave from
    field direction 40 peaks within 15 degrees of it), and the image within
    1e-4 of the reference's peak."""
    em = Eigenmike32()
    mic_xyz = em.coordinates_cartesian.T
    r = port.get_field(6)
    a = port.steering_operator(mic_xyz, r)
    target_idx = 40
    a0 = a[:, target_idx]
    sigma = np.outer(a0, a0.conj())

    l_ = torch.tensor(2.0 * port.eigh_max(a, device="cpu"), dtype=torch.float32)
    x = port.apgd_solve(torch.as_tensor(sigma, dtype=torch.complex64), torch.as_tensor(a, dtype=torch.complex64),
                        l_, torch.zeros(a.shape[1]), n_iter=100).numpy()
    assert x.min() >= 0
    peak_idx = int(np.argmax(x))
    assert float(r[:, peak_idx] @ r[:, target_idx]) > np.cos(np.deg2rad(15.0))

    l_j = jnp.asarray(2.0 * ref.eigh_max(a), dtype=jnp.float32)
    want = np.asarray(ref.apgd_solve(jnp.asarray(sigma, dtype=jnp.complex64), jnp.asarray(a, dtype=jnp.complex64),
                                     l_j, jnp.zeros(a.shape[1]), n_iter=100))
    assert _peak_gap(x, want) <= 1e-4


@pytest.mark.parametrize("rig", ["ambeovr", "eigenmike32"])
def test_visibility_matrix_matches_the_reference(rig):
    """sh_order 3, 3 bands, 4 frames: the whole image within 1e-4 of its peak,
    on a synthetic capsule signal with a dominant source."""
    coords = (JaxAmbeoVR() if rig == "ambeovr" else JaxEigenmike32()).coordinates_polar
    rng = np.random.default_rng(7)
    mic_xyz = jutils.polar_to_cartesian(coords).T
    a = ref.steering_operator(mic_xyz, ref.get_field(3))
    n = SR // 2
    carrier = np.sin(2 * np.pi * 3000.0 * np.arange(n) / SR)
    audio = np.real(np.outer(carrier, a[:, 10].conj())) + 0.05 * rng.standard_normal((n, a.shape[0]))
    kw = dict(sr=SR, nbands=3, sh_order=3, frame_cap=4)
    got = port.get_visibility_matrix(audio, coords, device="cpu", **kw)
    want = ref.get_visibility_matrix(audio, coords, **kw)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (64, 3, 4)
    assert got.max() > 0 and got.min() >= 0
    assert _peak_gap(got, want) <= 1e-4
    # The mel scale and the errors of both
    np.testing.assert_array_equal(port.band_frequencies(3, 1500, 4500, "log"), ref._mel_frequencies(3, 1500, 4500))
    for bad in (dict(fmin=5000, fmax=1000), dict(scale="sqrt")):
        with pytest.raises(ValueError):
            port.get_visibility_matrix(audio[: SR // 4], coords, device="cpu", **dict(kw, **bad))
        with pytest.raises(ValueError):
            ref.get_visibility_matrix(audio[: SR // 4], coords, **dict(kw, **bad))


def test_apgd_band_chains_frames_as_the_reference():
    """One band's frames, each warm-started from the last, through the
    port's `_apgd_band` against the reference's."""
    em = JaxEigenmike32()
    a = ref.steering_operator(em.coordinates_cartesian.T, ref.get_field(3))
    rng = np.random.default_rng(11)
    audio = rng.standard_normal((SR // 2, 32)) + np.real(np.outer(np.sin(np.arange(SR // 2) * 0.7), a[:, 5]))
    sig = ref.form_visibility(audio, SR, 2500.0, 50.0, 0.01, 0.1)[:4]
    l_ = 2.0 * ref.eigh_max(a)
    got = port._apgd_band(sig, a, np.float32(l_), device="cpu").numpy()
    s64, a64 = sig.astype(np.complex64), a.astype(np.complex64)
    want = np.asarray(ref._apgd_band(jnp.asarray(s64.real), jnp.asarray(s64.imag), jnp.asarray(a64.real),
                                     jnp.asarray(a64.imag), jnp.asarray(l_, dtype=jnp.float32)))
    assert got.shape == want.shape == (4, 64)
    assert _peak_gap(got, want) <= 1e-4


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fg_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("fg")
    d = root / "maleSpeech"
    d.mkdir()
    rng = np.random.default_rng(5)
    t = np.arange(SR * 2) / SR
    # Broadband in the imaging band (1500..4500 Hz)
    sig = sum(0.25 * np.sin(2 * np.pi * f * t) for f in (1800.0, 2700.0, 3900.0))
    sig += 0.05 * rng.standard_normal(len(t))
    from audiblelight_tpu_torch.io.audio import wav_write

    wav_write(d / "src.wav", sig.astype(np.float32), SR)
    return root


def test_acoustic_image_peak_matches_source_direction(fg_dir, tmp_path):
    """The reference's end-to-end check on the port: a source placed 1.2 m
    from an Eigenmike32 in a nonconvex rlr room, rendered on the CPU, and
    the APGD peak within 25 degrees of its direction."""
    from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
    from audiblelight_tpu_torch.synthesize import render_scene_classic

    mesh = scanned_like_room(extents=(6.0, 5.0, 3.0), n_furniture=2, subdivision_levels=2, seed=9)
    assert not mesh.is_convex
    scene = PortScene(duration=2.0, sample_rate=SR, backend="rlr", fg_path=fg_dir, device="cpu",
                      backend_kwargs=dict(mesh=mesh, seed=3, rlr_kwargs=dict(
                          indirect_ray_count=256, indirect_ray_depth=6, max_ir_length=0.15,
                          mesh_simplification=400, diffraction=False)))
    mic_pos = np.array([3.0, 2.5, 1.5])
    scene.add_microphone(microphone_type="eigenmike32", position=mic_pos, alias="em")
    src_pos = mic_pos + np.array([1.2, 0.0, 0.3])
    scene.add_event(event_type="static", position=src_pos, alias="s0", scene_start=0.2, event_start=0.0,
                    duration=1.5, snr=30.0)
    render_scene_classic(scene)
    assert "em" in scene.audio and np.abs(scene.audio["em"]).max() > 0

    scene.generate_acoustic_image(output_dir=tmp_path, nbands=3, frame_cap=40, sh_order=8)
    img = scene.acoustic_image["em"]
    assert img.shape[0] == 4 * (8 + 1) ** 2
    assert img.min() >= 0 and np.isfinite(img).all()

    gt_vec = scene.get_event("s0").emitters[0].coordinates_relative_cartesian["em"]
    gt_dir = gt_vec / np.linalg.norm(gt_vec)
    r = port.get_field(8)
    med = np.median(img, axis=1)
    peak_px = int(np.argmax(med.max(axis=1)))
    cos = float(r[:, peak_px] @ gt_dir)
    assert cos > np.cos(np.deg2rad(25.0)), f"APGD peak {np.rad2deg(np.arccos(np.clip(cos, -1, 1))):.1f} deg off"
    assert json.loads((tmp_path / "acoustic_image_metadata_em.json").read_text())
    assert (tmp_path / "acoustic_image_em.hdf").is_file()


@pytest.fixture(scope="module")
def shoebox_scenes(tmp_path_factory):
    """A shoebox Eigenmike32 scene rendered by the reference, and the port's
    Scene loaded from its dict and given its audio."""
    root = tmp_path_factory.mktemp("sb")
    fg = root / "fg"
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav"))[:3]:
        (fg / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, fg / wav.parent.name / wav.name)
    jutils.seed_everything(3)
    want = JaxScene(duration=5.0, sample_rate=SR, backend="shoebox", fg_path=fg, class_mapping="DCASE2023Task3",
                    backend_kwargs=dict(dimensions=[6.0, 5.0, 3.0], absorption=0.5, max_order=2,
                                        max_ir_length=0.1, seed=4))
    want.add_microphone(microphone_type="eigenmike32")
    for _ in range(2):
        want.add_event(event_type="static", max_place_attempts=100)
    want.generate(output_dir=root, compiled=True)
    got = PortScene.from_dict(json.loads(json.dumps(want.to_dict())), device="cpu")
    got.audio = {k: np.array(v) for k, v in want.audio.items()}
    return got, want


def test_generate_acoustic_image_matches_the_reference(shoebox_scenes, tmp_path):
    """The entry on the reference's audio: the same file names; h5py reads
    the port's HDF to the reference's dataset (within 1e-4 of peak), dtype
    and attributes (`ai_n_frames` the tesselation size, as the reference
    writes it); the JSON's (frame, instance, class, distance) entries equal."""
    got, want = shoebox_scenes
    kw = dict(nbands=3, sh_order=3, frame_cap=None, resolution=(72, 36))
    (tmp_path / "got").mkdir()
    (tmp_path / "want").mkdir()
    got.generate_acoustic_image(output_dir=tmp_path / "got", **kw)
    want.generate_acoustic_image(output_dir=tmp_path / "want", **kw)
    names = sorted(p.name for p in (tmp_path / "got").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "want").iterdir())
    assert names == ["acoustic_image_metadata_mic000.json", "acoustic_image_mic000.hdf"]
    with h5py.File(tmp_path / "got/acoustic_image_mic000.hdf") as fg, \
            h5py.File(tmp_path / "want/acoustic_image_mic000.hdf") as fw:
        assert sorted(fg.keys()) == sorted(fw.keys()) == ["ai_apgd"]
        assert fg["ai_apgd"].dtype == fw["ai_apgd"].dtype == np.float32
        assert dict(fg.attrs) == dict(fw.attrs)
        assert fg.attrs["ai_n_frames"] == 64 and fg.attrs["ai_n_bands"] == 3
        assert _peak_gap(fg["ai_apgd"][()], fw["ai_apgd"][()]) <= 1e-4
        np.testing.assert_array_equal(fg["ai_apgd"][()], got.acoustic_image["mic000"])
    js_got = json.loads((tmp_path / "got/acoustic_image_metadata_mic000.json").read_text())
    js_want = json.loads((tmp_path / "want/acoustic_image_metadata_mic000.json").read_text())
    key = ("metadata_frame_index", "instance_id", "category_id", "distance")
    assert [tuple(d[k] for k in key) for d in js_got] == [tuple(d[k] for k in key) for d in js_want]
    assert js_got and got.acoustic_image_json["mic000"] == js_got


def test_generate_acoustic_image_with_the_reference_image_is_exact(shoebox_scenes, tmp_path, monkeypatch):
    """Given the reference's image, the port's entry writes the reference's
    JSON and HDF data bit for bit (the labels and the writer are host code);
    missing audio raises the reference's error."""
    got, want = shoebox_scenes
    kw = dict(nbands=3, sh_order=3, frame_cap=None, resolution=(72, 36))
    (tmp_path / "got").mkdir()
    (tmp_path / "want").mkdir()
    want.generate_acoustic_image(output_dir=tmp_path / "want", **kw)
    monkeypatch.setattr(port, "get_visibility_matrix", lambda *a, **k: want.acoustic_image["mic000"])
    got.generate_acoustic_image(output_dir=tmp_path / "got", **kw)
    for name in ("acoustic_image_metadata_mic000.json",):
        assert (tmp_path / "got" / name).read_text() == (tmp_path / "want" / name).read_text()
    with h5py.File(tmp_path / "got/acoustic_image_mic000.hdf") as fg, \
            h5py.File(tmp_path / "want/acoustic_image_mic000.hdf") as fw:
        np.testing.assert_array_equal(fg["ai_apgd"][()], fw["ai_apgd"][()])
        assert dict(fg.attrs) == dict(fw.attrs)
    audio = got.audio
    got.audio = {}
    try:
        with pytest.raises(ValueError, match="No audio for microphone"):
            got.generate_acoustic_image(output_dir=tmp_path / "got", **kw)
    finally:
        got.audio = audio


def test_eigenmike_chain_drifts_alike_in_both_packages():
    """The float32 APGD chain of an Eigenmike32 (sh_order 10, 9 bands, 30
    frames) drifts from a float64 evaluation of the same chain, the
    reference's as the port's (ROADMAP section 3): both past 1e-3 of peak,
    neither past 5e-2; the AmbeoVR chain stays within 1e-4. A single frame
    from the chain's own warm start agrees with the chain to 1e-6 of peak,
    so long Eigenmike32 chains are compared frame by frame."""
    from audiblelight_tpu_torch.micarrays import AmbeoVR
    from audiblelight_tpu_torch.utils import polar_to_cartesian

    sr = 24000
    gaps = {}
    for rig in (AmbeoVR, Eigenmike32):
        coords = rig().coordinates_polar
        rng = np.random.default_rng(3)
        xyz = polar_to_cartesian(coords).T
        a3 = port.steering_operator(xyz, port.get_field(3))
        audio = np.real(np.outer(np.sin(2 * np.pi * 3000.0 * np.arange(3 * sr) / sr), a3[:, 10].conj()))
        audio = audio + 0.05 * rng.standard_normal(audio.shape)
        got = port.get_visibility_matrix(audio, coords, device="cpu", sr=sr, frame_cap=30)
        want = ref.get_visibility_matrix(audio, coords, sr=sr, frame_cap=30)
        a = port.steering_operator(xyz, port.get_field(10))
        sig = port.band_visibilities(audio, port.band_frequencies(9, 1500, 4500, "linear"), sr, 50.0, 10e-3, 30)
        s64 = port.normalised_visibilities(torch.as_tensor(sig))
        l64 = torch.tensor(2.0 * port.eigh_max(a, "cpu"), dtype=torch.float64)
        x64 = port.apgd_frames(s64, torch.as_tensor(a), l64).permute(2, 0, 1).numpy()
        gaps[rig.__name__] = (_peak_gap(got, x64), _peak_gap(want, x64), _peak_gap(got, want))
        s32 = s64.to(torch.complex64)
        a32, l32 = torch.as_tensor(a, dtype=torch.complex64), torch.tensor(float(l64), dtype=torch.float32)
        chain = port.apgd_frames(s32, a32, l32)
        warm = torch.cat([torch.zeros_like(chain[:, :1]), chain[:, :-1]], dim=1)
        assert _peak_gap(port.apgd_solve(s32, a32, l32, warm), chain) <= 1e-6
    print(f"30-frame chains against float64 (port, reference, port against reference): {gaps}")
    assert max(gaps["AmbeoVR"]) <= 1e-4
    assert 1e-3 < gaps["Eigenmike32"][0] < 5e-2 and 1e-3 < gaps["Eigenmike32"][1] < 5e-2
