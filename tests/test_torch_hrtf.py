"""The port's measured HRTFs (rir/hrtf.py) against the JAX package's.

One SimpleFreeFieldHRIR set, written by the reference's `write_hrtf_sofa`
at 44.1 kHz (126 directions, 96 taps: a fractional-delay windowed sinc at
the analytic head's Woodworth delay, scaled by its shadow gain and
coloured), is read by both packages at 24 kHz; the port's set is also
built from the JAX set's arrays (`HRTFSet.from_numpy`), so both packages
hold the same set. Held:

- reading: the port's reader and resampler give the reference's arrays
  bit for bit, on this file and on a netCDF-4-like file with fixed-length
  string attributes;
- `interp_weights`: indices identical and weights to rtol 1e-6, on grid,
  off grid and on ties (duplicated directions: the reference's top_k puts
  the lower index first); `band_powers` to 1e-5 relative;
- the direct paths within 5e-5 and the diffracted paths within 1e-4 of the
  reference's peak (the analytic head's tolerances), the image-source
  engine within 1e-4 of peak at order 2;
- the tail statistically (per-band energy within 5 %, T30 within 10 %, per
  ear); K5's plain version on one traced bounce's measured-gain deposits
  equals the reference's XLA scatter bit for bit, and the interpret-mode
  Pallas kernel to rtol 1e-6 with the same non-zero cells (its one-hot
  dot sums each bin's rays in blocks, another order: 3.6e-7 at most);
- `Binaural(hrtf_sofa=...)` serialises as the reference's, and its scenes
  render on the rlr fused path, the rlr plan path and the shoebox.
"""

import json
import random
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu import micarrays as jmic
from audiblelight_tpu.geometry.mesh import scanned_like_room
from audiblelight_tpu.ops.pallas_kernels import bin_histogram as jax_bin_histogram
from audiblelight_tpu.ops.pallas_kernels import bin_histogram_pallas
from audiblelight_tpu.rir import hrtf as jhrtf
from audiblelight_tpu.rir import image_source as jis
from audiblelight_tpu.rir import raytracer as jrt
from audiblelight_tpu_torch import micarrays as tmic
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.geometry.mesh import save_obj
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.rir import hrtf as thrtf
from audiblelight_tpu_torch.rir import image_source as tis
from audiblelight_tpu_torch.rir import raytracer as trt
from audiblelight_tpu_torch.rir.sh import spherical_head_gains, woodworth_itd
from test_torch_raytracer import BANDS, CASES, SR, _close, _t, _t30

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FILE_SR = 44100


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


def head_hrirs(az_deg, el_deg, n_taps: int, sr: int, seed: int = 0) -> np.ndarray:
    """(M, 2, n_taps) HRIRs of the analytic head: a windowed sinc at 16
    samples plus each ear's Woodworth delay, scaled by the ear's mean
    shadow gain over 125 Hz - 8 kHz, with a short coloured tail."""
    az, el = np.deg2rad(az_deg), np.deg2rad(el_deg)
    dirs = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1).astype(np.float32)
    itd = woodworth_itd(torch.from_numpy(dirs)).numpy()  # (M, 2)
    gain = spherical_head_gains(torch.from_numpy(dirs), np.geomspace(125, 8000, 8)).numpy().mean(-1)  # (M, 2)
    t = np.arange(n_taps)
    delay = 16.0 + itd * sr
    x = t[None, None, :] - delay[..., None]
    pulse = np.sinc(x) * (np.abs(x) < 12) * (0.5 + 0.5 * np.cos(np.pi * np.clip(x / 12, -1, 1)))
    tail = np.random.default_rng(seed).standard_normal(pulse.shape) * 0.05 * np.exp(-t / 6.0) * (x > 2)
    return gain[..., None] * (pulse + tail)


def _grid():
    az, el = np.meshgrid(np.arange(0.0, 360.0, 20.0), [-40.0, -20.0, 0.0, 20.0, 40.0, 60.0, 80.0])
    return az.ravel(), el.ravel()


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """(file, JAX set, port set from the JAX arrays) at SR on the CPU."""
    path = tmp_path_factory.mktemp("hrtf") / "head.sofa"
    az, el = _grid()
    jhrtf.write_hrtf_sofa(path, head_hrirs(az, el, 96, FILE_SR), az, el, FILE_SR)
    want = jhrtf.load_hrtf_sofa(str(path), SR)
    got = thrtf.HRTFSet.from_numpy(np.asarray(want.dirs), np.asarray(want.hrirs), want.sr, "cpu")
    return path, want, got


def _unit(rng, n):
    q = rng.standard_normal((n, 3)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_port_reads_the_reference_set(sets, monkeypatch):
    """The port's own reader and resampler give the reference's arrays, bit
    for bit, with h5py out of reach, and cache one copy per (path, rate,
    device)."""
    path, want, _ = sets
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    got = thrtf.load_hrtf_sofa(path, SR, "cpu")
    assert got.sr == want.sr == SR and got.device.type == "cpu"
    np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))
    np.testing.assert_array_equal(got.hrirs.numpy(), np.asarray(want.hrirs))
    assert thrtf.load_hrtf_sofa(str(path), SR, "cpu") is got
    assert thrtf.load_hrtf_sofa(path, 16000, "cpu") is not got


def test_netcdf_set_with_byte_string_attributes():
    """A netCDF-4-like set (dense links, dimension scales, fixed-length
    byte-string Units and Type) reads as the reference reads it."""
    path = REPO / "tests/resources/torch_sofa/netcdf_latest.sofa"
    want = jhrtf.load_hrtf_sofa(str(path), SR)
    dirs, hrirs = thrtf.read_hrtf_sofa(path, SR)
    np.testing.assert_array_equal(dirs, np.asarray(want.dirs))
    np.testing.assert_array_equal(hrirs, np.asarray(want.hrirs))


@pytest.mark.parametrize("kind", ["on_grid", "off_grid", "tied"])
def test_interp_weights_match_reference(sets, kind):
    _, want, got = sets
    rng = np.random.default_rng(3)
    dirs = np.asarray(want.dirs)
    hrirs = np.asarray(want.hrirs)
    if kind == "on_grid":
        q = dirs[rng.permutation(len(dirs))]
    elif kind == "off_grid":
        q = _unit(rng, 2000)
    else:  # every direction also at a higher index, one of them nine times
        dirs = np.concatenate([dirs, dirs, np.repeat(dirs[40:41], 9, axis=0)])
        hrirs = np.concatenate([hrirs, hrirs, np.repeat(hrirs[40:41], 9, axis=0)])
        want = jhrtf.HRTFSet(dirs, hrirs, SR)
        got = thrtf.HRTFSet.from_numpy(dirs, hrirs, SR, "cpu")
        q = np.concatenate([dirs[:126], _unit(rng, 500)])
    idx_w, w_w = want.interp_weights(jnp.asarray(q))
    idx_g, w_g = got.interp_weights(torch.from_numpy(q))
    np.testing.assert_array_equal(idx_g.numpy(), np.asarray(idx_w))
    np.testing.assert_allclose(w_g.numpy(), np.asarray(w_w), rtol=1e-6, atol=1e-7)
    if kind == "tied":
        assert (idx_g[:126, :2].numpy() == np.stack([np.arange(126), np.arange(126) + 126], 1)).all()
        assert idx_g[40].tolist() == [40, 166, 252]


def test_band_powers_and_hrirs_at_match_reference(sets):
    _, want, got = sets
    bp_w = np.asarray(want.band_powers(jnp.asarray(BANDS)))
    bp_g = got.band_powers(torch.from_numpy(BANDS)).numpy()
    assert bp_g.shape == bp_w.shape == (126, 2, 4)
    np.testing.assert_allclose(bp_g, bp_w, rtol=1e-5, atol=1e-5 * np.abs(bp_w).max())
    q = _unit(np.random.default_rng(4), 300)
    _close(got.hrirs_at(torch.from_numpy(q)).numpy(), np.asarray(want.hrirs_at(jnp.asarray(q))), 1e-5)
    _close(got.band_power_at(torch.from_numpy(q), torch.from_numpy(bp_w.copy())).numpy(),
           np.asarray(want.band_power_at(jnp.asarray(q), jnp.asarray(bp_w))), 1e-5)


def test_ties_past_the_candidates():
    """More equal dots than the candidates the float32 product picks: the
    first k of a stable descending sort, as the reference's top_k."""
    rng = np.random.default_rng(8)
    dirs = _unit(rng, 40)
    dirs[3:20] = dirs[25]  # 18 copies of one direction
    hrirs = rng.standard_normal((40, 2, 8)).astype(np.float32)
    q = np.concatenate([dirs[[25, 0]], _unit(rng, 64)])
    idx_w, w_w = jhrtf.HRTFSet(dirs, hrirs, SR).interp_weights(jnp.asarray(q))
    idx_g, w_g = thrtf.HRTFSet.from_numpy(dirs, hrirs, SR, "cpu").interp_weights(torch.from_numpy(q))
    assert idx_g[0].tolist() == [3, 4, 5]
    np.testing.assert_array_equal(idx_g.numpy(), np.asarray(idx_w))
    np.testing.assert_allclose(w_g.numpy(), np.asarray(w_w), rtol=1e-6, atol=1e-7)
    q64, d64 = q.astype(np.float64), dirs.astype(np.float64)
    ref_dots = np.asarray(jnp.asarray(q) @ jnp.asarray(dirs).T)
    np.testing.assert_array_equal(thrtf._dots(torch.from_numpy(q)[:, None], torch.from_numpy(dirs)[None]).numpy(),
                                  ref_dots)
    assert np.abs(ref_dots - q64 @ d64.T).max() < thrtf.DOT_SLACK


@pytest.mark.parametrize("name", sorted(CASES))
def test_direct_and_diffracted_match_reference(sets, name):
    _, want_set, got_set = sets
    make, src, centre, order = CASES[name]
    tris = make().triangles.astype(np.float32)
    src, lis, n = np.asarray(src, np.float32), np.asarray([centre], np.float32), SR // 2
    kw = dict(sr=SR, encoding="binaural", sh_order=3)
    want_d = np.asarray(jrt.direct_paths_ir(jnp.asarray(tris), jnp.asarray(src), jnp.asarray(lis), n,
                                            hrtf=want_set, **kw))
    want_g = np.asarray(jax.vmap(lambda s: jrt.diffracted_path_ir(
        jnp.asarray(tris), s, jnp.asarray(lis), jnp.asarray(BANDS), n, order=order, hrtf=want_set,
        **kw))(jnp.asarray(src)))
    got_d = trt.direct_paths_ir(_t(tris), _t(src), _t(lis), n, hrtf=got_set, **kw).numpy()
    got_g = trt.diffracted_path_ir(_t(tris), _t(src), _t(lis), _t(BANDS), n, order=order, hrtf=got_set,
                                   **kw).numpy()
    assert got_d.shape == want_d.shape == (3, 2, n)
    _close(got_d, want_d, 5e-5)
    _close(got_g, want_g, 1e-4)
    occluded = np.abs(want_d).max(axis=(1, 2)) == 0
    assert occluded.any() and (~occluded).any() and np.abs(want_g).max() > 1e-8


def test_image_source_matches_reference(sets):
    _, want_set, got_set = sets
    rng = np.random.default_rng(6)
    room = np.array([6.0, 4.5, 3.0], np.float32)
    src = rng.uniform(0.5, room - 0.5, (3, 3)).astype(np.float32)
    lis = np.array([[3.0, 2.0, 1.5]], np.float32)
    log_beta, bands = jis.wall_log_betas_from_absorption(rng.uniform(0.1, 0.6, (6, 4)))
    kw = dict(n_samples=2048, max_order=2, sr=SR, encoding="binaural")
    want = np.asarray(jis.shoebox_rirs(jnp.asarray(room), jnp.asarray(src), jnp.asarray(lis), jnp.asarray(log_beta),
                                       jnp.asarray(bands), hrtf=want_set, **kw))
    got = tis.shoebox_rirs(room, src, lis, log_beta, bands, hrtf=got_set, device="cpu", **kw).numpy()
    assert got.shape == want.shape == (2, 3, 2048)
    gap = np.abs(got - want).max() / np.abs(want).max()
    print(f"image sources with a measured set: max |diff| / peak {gap:.2e}")
    assert gap <= 1e-4


def _tail_inputs():
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=1, seed=0)
    tris = mesh.triangles.astype(np.float32)
    normals = mesh.face_normals.astype(np.float32)
    absorption = np.tile(np.array([[0.10, 0.15, 0.20, 0.30]], np.float32), (len(tris), 1))
    scattering = np.full(len(tris), 0.4, np.float32)
    src = np.array([[5.6, 3.9, 1.1], [1.0, 4.0, 1.5]], np.float32)
    lis = np.array([[3.5, 2.5, 1.5]], np.float32)
    return tris, normals, absorption, scattering, src, lis


def test_unfused_tail_statistics(sets):
    """The measured set's band powers weight the tail: per-band energies of
    both ears within 5 % and T30 within 10 % of the reference's."""
    _, want_set, got_set = sets
    tris, normals, absorption, scattering, src, lis = _tail_inputs()
    kw = dict(n_rays=2048, max_depth=30, n_bins=150, bin_dt=0.002, decimate=True, encoding="binaural")
    occ_j = jrt.face_rain_occlusion(jnp.asarray(tris), jnp.asarray(normals), jnp.asarray(lis))
    want = np.asarray(jrt.trace_energy_histogram_multi(
        jax.random.PRNGKey(0), jnp.asarray(tris), jnp.asarray(absorption), jnp.asarray(scattering),
        jnp.asarray(src), jnp.asarray(lis), n_sources=2, tri_normals=jnp.asarray(normals), face_occlusion=occ_j,
        hrtf=want_set, **kw))
    occ_t = trt.face_rain_occlusion(_t(tris), _t(normals), _t(lis))
    got = trt.trace_energy_histogram_multi(
        torch.Generator().manual_seed(0), _t(tris), _t(absorption), _t(scattering), _t(src), _t(lis),
        tri_normals=_t(normals), face_occlusion=occ_t, hrtf=got_set, **kw).numpy()
    analytic = trt.trace_energy_histogram_multi(
        torch.Generator().manual_seed(0), _t(tris), _t(absorption), _t(scattering), _t(src), _t(lis),
        tri_normals=_t(normals), face_occlusion=occ_t, **kw).numpy()
    assert got.shape == want.shape == (2, 2, 4, 150)
    np.testing.assert_allclose(got.sum(-1), want.sum(-1), rtol=0.05)
    assert np.abs(got.sum(-1) / analytic.sum(-1) - 1).max() > 0.05  # the measured gains took effect
    for e in range(2):
        for c in range(2):
            t_got, t_want = _t30(got[e, c].sum(0), 0.002), _t30(want[e, c].sum(0), 0.002)
            assert abs(t_got / t_want - 1) < 0.10, (e, c, t_got, t_want)


def test_bin_histogram_on_a_traced_bounce_matches_pallas(sets, monkeypatch):
    """K5's plain version folds one traced bounce's measured-gain deposits
    (2 sources x 512 rays, 2 ears x 4 bands) as the reference does."""
    _, _, got_set = sets
    tris, normals, absorption, scattering, src, lis = _tail_inputs()
    seen = []
    real = trt.bin_histogram

    def keep(bins, dep, n_bins):
        seen.append((bins.clone(), dep.clone(), n_bins))
        return real(bins, dep, n_bins)

    monkeypatch.setattr(trt, "bin_histogram", keep)
    trt.trace_energy_histogram_multi(
        torch.Generator().manual_seed(2), _t(tris), _t(absorption), _t(scattering), _t(src), _t(lis),
        n_rays=512, max_depth=1, n_bins=150, bin_dt=0.002, tri_normals=_t(normals),
        face_occlusion=trt.face_rain_occlusion(_t(tris), _t(normals), _t(lis)), encoding="binaural", hrtf=got_set)
    (bins, dep, n_bins), = seen
    assert dep.shape == (2, 512, 8) and int((dep != 0).sum()) > 1000
    want = np.asarray(bin_histogram_pallas(jnp.asarray(bins.numpy()), jnp.asarray(dep.numpy()), n_bins,
                                           interpret=True))
    want_xla = np.asarray(jax_bin_histogram(jnp.asarray(bins.numpy()), jnp.asarray(dep.numpy()), n_bins))
    got = ck.bin_histogram_plain(bins, dep, n_bins).numpy()
    print("K5 plain vs interpret-mode Pallas: max |diff| / |value|",
          float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30))))
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_binaural_with_a_file_serialises_as_reference(sets):
    path, want_set, _ = sets
    want, got = jmic.Binaural(hrtf_sofa=str(path)), tmic.Binaural(hrtf_sofa=str(path))
    for mic in (want, got):
        mic.set_absolute_coordinates([2.0, 1.5, 1.2])
    assert got.to_dict() == want.to_dict() and got.to_dict()["hrtf_sofa"] == str(path)
    back = tmic.MicArray.from_dict(json.loads(json.dumps(want.to_dict())))
    assert type(back) is tmic.Binaural and back.hrtf_sofa == str(path)
    loaded = back.load_hrtf(SR, "cpu")
    np.testing.assert_array_equal(loaded.hrirs.numpy(), np.asarray(want_set.hrirs))
    assert tmic.Binaural().load_hrtf(SR, "cpu") is None


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("rigs")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    return root / "fg", save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")


def _scene(backend, fg, obj, hrtf_path):
    tutils.seed_everything(7)
    if backend == "rlr":
        kwargs = dict(mesh=str(obj), seed=11, add_to_context=False,
                      rlr_kwargs=dict(indirect_ray_count=64, indirect_ray_depth=4, max_ir_length=0.1,
                                      mesh_simplification=True))
    else:
        kwargs = dict(dimensions=[6.0, 4.5, 3.0], max_order=2, max_ir_length=0.1, seed=11)
    scene = PortScene(duration=6.0, sample_rate=SR, backend=backend, fg_path=fg, max_overlap=2,
                      backend_kwargs=kwargs, device="cpu")
    scene.add_microphone(microphone_type=tmic.Binaural(hrtf_sofa=str(hrtf_path)))
    for event_type in ("static", "static", "moving"):
        try:
            scene.add_event(event_type=event_type, max_place_attempts=100)
        except ValueError:
            pass
    scene.add_ambience(noise="gaussian")
    return scene


@pytest.mark.parametrize("backend,compiled", [("rlr", False), ("rlr", True), ("shoebox", False)],
                         ids=["rlr-fused", "rlr-plan", "shoebox"])
def test_scene_with_measured_hrtfs_renders(sets, assets, tmp_path, monkeypatch, backend, compiled):
    """A scene with `Binaural(hrtf_sofa=...)` renders to a 2-channel int16
    WAV with sound on each path (rlr: the fused renderer, `render_scenes_pipelined`,
    and the plan path; the shoebox: `generate()`'s classic render), its
    trace or engine given the measured set."""
    path, _, _ = sets
    fg, obj = assets
    given = []
    real = trt.trace_rirs_multi if backend == "rlr" else tis.shoebox_rirs
    target = trt if backend == "rlr" else __import__(
        "audiblelight_tpu_torch.worldstate.shoebox_backend", fromlist=["x"])
    name = "trace_rirs_multi" if backend == "rlr" else "shoebox_rirs"

    def spy(*args, **kwargs):
        given.append(kwargs.get("hrtf"))
        return real(*args, **kwargs)

    monkeypatch.setattr(target, name, spy)
    scene = _scene(backend, fg, obj, path)
    if backend == "rlr" and not compiled:
        from audiblelight_tpu_torch.core import write_outputs
        from audiblelight_tpu_torch.pipeline import render_scenes_pipelined

        render_scenes_pipelined([scene], lambda s, payloads: setattr(s, "audio", payloads),
                                device_mix=True)
        write_outputs(scene, tmp_path / "audio_out", tmp_path / "metadata_out")
    else:
        scene.generate(output_dir=tmp_path, compiled=compiled)
    audio = scene.audio["mic000"]
    peak = np.abs(audio).max() * (1 if audio.dtype == np.int16 else 32768)
    assert audio.shape == (2, 6 * SR) and peak > 100
    assert given and all(isinstance(h, thrtf.HRTFSet) for h in given)
    assert (tmp_path / "audio_out_mic000.wav").is_file()
