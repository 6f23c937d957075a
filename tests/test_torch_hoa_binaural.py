"""The port's HOA and binaural rigs against the JAX package.

- K5: the plain version of `bin_histogram` against the Pallas kernel in
  interpret mode and the reference's XLA scatter, with negative bins: the
  same non-zero pattern, values within rtol 1e-5 plus 1e-6 of the peak (fp32
  sums in another order; the signed ambisonic channels cancel, so an element
  near zero is held by the peak term).
- The analytic head (spherical-head shadow, Woodworth ITD, the broadband
  cardioid gains) within 1e-6 relative: f32 arccos and cos differ in the
  last bit between XLA and PyTorch on a few inputs.
- Binaural and third-order direct paths within 5e-5 and diffracted paths
  within 1e-4 of the reference's peak, the omni tolerances.
- The unfused tails (binaural, HOA3) held statistically: per-band energies
  within 5 % and T30 within 10 % of the reference's, the omni tolerances.
- `Binaural` (with and without `hrtf_sofa`) and `HOAListener` serialise as
  the reference's; scenes with them place as the reference's and render
  through the fused renderer. Measured HRTF sets are held in
  test_torch_hrtf.py.
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

from audiblelight_tpu import Scene as JaxScene
from audiblelight_tpu import micarrays as jmic
from audiblelight_tpu import utils as jutils
from audiblelight_tpu.geometry.mesh import scanned_like_room
from audiblelight_tpu.ops.pallas_kernels import bin_histogram as jax_bin_histogram
from audiblelight_tpu.ops.pallas_kernels import bin_histogram_pallas
from audiblelight_tpu.rir import raytracer as jrt
from audiblelight_tpu.rir import sh as jsh
from audiblelight_tpu_torch import micarrays as tmic
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.geometry.mesh import save_obj
from audiblelight_tpu_torch.io.audio import wav_read
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.rir import raytracer as trt
from audiblelight_tpu_torch.rir import sh as tsh
from test_torch_raytracer import BANDS, CASES, SR, _close, _t, _t30

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


@pytest.mark.parametrize("g,r,k,n_bins,crowd", [(16, 300, 64, 501, 0), (16, 300, 8, 501, 0), (3, 1000, 5, 40, 0),
                                                (16, 1250, 64, 501, 4), (16, 1237, 8, 501, 0)],
                         ids=["hoa3", "binaural", "ragged", "crowded", "r_odd"])
def test_bin_histogram_matches_pallas_and_scatter(g, r, k, n_bins, crowd):
    """HOA3 (16 channels x 4 bands) and binaural (2 x 4) widths at the
    flagship's 501 bins, and a ragged case; a tenth of the rays carry a
    negative bin. "crowded" puts every ray in one of `crowd` bins, as real
    arrivals crowd; "r_odd" has a ray count that no chunk or cluster share
    divides."""
    rng = np.random.default_rng(k)
    bins = rng.integers(0, n_bins, (g, r)).astype(np.int32)
    if crowd:
        bins = rng.choice(rng.integers(0, n_bins, crowd), (g, r)).astype(np.int32)
    bins[rng.random((g, r)) < 0.1] = -1 - rng.integers(0, 3)
    dep = rng.standard_normal((g, r, k)).astype(np.float32) * 1e-4
    want = np.asarray(bin_histogram_pallas(jnp.asarray(bins), jnp.asarray(dep), n_bins, interpret=True))
    want_xla = np.asarray(jax_bin_histogram(jnp.asarray(bins), jnp.asarray(np.where(bins[..., None] >= 0, dep, 0.0)),
                                            n_bins))
    got = ck.bin_histogram(torch.from_numpy(bins), torch.from_numpy(dep), n_bins).numpy()
    assert got.shape == want.shape == want_xla.shape == (g, n_bins, k) and got.dtype == np.float32
    for ref in (want, want_xla):
        np.testing.assert_array_equal(got != 0, ref != 0)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_head_model_matches_reference():
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((513, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[:3] = [[0, 1, 0], [0, -1, 0], [1, 0, 0]]  # on and across the ear axis
    freqs = np.concatenate([BANDS, np.arange(0, 12001, 250, dtype=np.float32)])
    jd, td = jnp.asarray(dirs), torch.from_numpy(dirs)
    pairs = [
        (jsh.spherical_head_gains(jd, jnp.asarray(freqs)), tsh.spherical_head_gains(td, freqs)),
        (jsh.woodworth_itd(jd), tsh.woodworth_itd(td)),
        (jsh.woodworth_itd(jd, c=340.0), tsh.woodworth_itd(td, c=340.0)),
        (jsh.binaural_encoding_gains(jd), tsh.binaural_encoding_gains(td)),
        (jsh.spherical_head_shadow(jd[:, 1], jnp.asarray(freqs[:8] * 1e-3)),
         tsh.spherical_head_shadow(td[:, 1], torch.from_numpy(freqs[:8] * 1e-3))),
    ]
    for want, got in pairs:
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("encoding", ["binaural", "sh3"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_direct_and_diffracted_match_reference(name, encoding):
    """The listener behind one barrier (single bend) and two (the multi-bend
    graph): the analytic head, and third order with the direct path at
    order 3."""
    make, src, centre, order = CASES[name]
    tris = make().triangles.astype(np.float32)
    src = np.asarray(src, np.float32)
    lis = np.asarray([centre], np.float32)
    n = SR // 2
    kw = dict(sr=SR, encoding=encoding, sh_order=3)
    want_d = np.asarray(jrt.direct_paths_ir(jnp.asarray(tris), jnp.asarray(src), jnp.asarray(lis), n, **kw))
    want_g = np.asarray(jax.vmap(lambda s: jrt.diffracted_path_ir(
        jnp.asarray(tris), s, jnp.asarray(lis), jnp.asarray(BANDS), n, order=order, **kw))(jnp.asarray(src)))
    got_d = trt.direct_paths_ir(_t(tris), _t(src), _t(lis), n, **kw).numpy()
    got_g = trt.diffracted_path_ir(_t(tris), _t(src), _t(lis), _t(BANDS), n, order=order, **kw).numpy()
    c_out = 2 if encoding == "binaural" else 16
    assert got_d.shape == want_d.shape == (3, c_out, n)
    _close(got_d, want_d, 5e-5)
    _close(got_g, want_g, 1e-4)
    occluded = np.abs(want_d).max(axis=(1, 2)) == 0
    assert occluded.any() and (~occluded).any() and np.abs(want_g).max() > 1e-8


@pytest.mark.parametrize("encoding", ["binaural", "sh3"])
def test_unfused_tail_statistics(encoding):
    """The unfused deposit chain (K5's fold) in a small nonconvex room with
    per-face rain visibility and decimation: per-band energies (both ears;
    W for HOA3) within 5 % and T30 within 10 % of the reference's."""
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=1, seed=0)
    tris = mesh.triangles.astype(np.float32)
    normals = mesh.face_normals.astype(np.float32)
    f = len(tris)
    absorption = np.tile(np.array([[0.10, 0.15, 0.20, 0.30]], np.float32), (f, 1))
    scattering = np.full(f, 0.4, np.float32)
    src = np.array([[5.6, 3.9, 1.1], [1.0, 4.0, 1.5]], np.float32)
    lis = np.array([[3.5, 2.5, 1.5]], np.float32)
    kw = dict(n_rays=2048, max_depth=30, n_bins=150, bin_dt=0.002, decimate=True, encoding=encoding, sh_order=3)
    occ_j = jrt.face_rain_occlusion(jnp.asarray(tris), jnp.asarray(normals), jnp.asarray(lis))
    want = np.asarray(jrt.trace_energy_histogram_multi(
        jax.random.PRNGKey(0), jnp.asarray(tris), jnp.asarray(absorption), jnp.asarray(scattering),
        jnp.asarray(src), jnp.asarray(lis), n_sources=2, tri_normals=jnp.asarray(normals), face_occlusion=occ_j,
        **kw))
    occ_t = trt.face_rain_occlusion(_t(tris), _t(normals), _t(lis))
    got = trt.trace_energy_histogram_multi(
        torch.Generator().manual_seed(0), _t(tris), _t(absorption), _t(scattering), _t(src), _t(lis),
        tri_normals=_t(normals), face_occlusion=occ_t, **kw).numpy()
    c_out = 2 if encoding == "binaural" else 16
    assert got.shape == want.shape == (2, c_out, 4, 150)
    chans = [0, 1] if encoding == "binaural" else [0]
    np.testing.assert_allclose(got[:, chans].sum(-1), want[:, chans].sum(-1), rtol=0.05)
    for e in range(2):
        for c in chans:
            t_got, t_want = _t30(got[e, c].sum(0), 0.002), _t30(want[e, c].sum(0), 0.002)
            assert abs(t_got / t_want - 1) < 0.10, (e, c, t_got, t_want)


def test_unfused_synthesis_binaural_keeps_each_ear():
    """Each ear's IR carries its own histogram energy (the envelope is the
    square root of the ear's energy on a shared carrier)."""
    n_bins, bin_dt, n = 126, 0.002, SR // 4
    hist = np.zeros((2, len(BANDS), n_bins), np.float32)
    hist[0, 1], hist[1, 1] = 2e-3, 5e-4
    want = np.asarray(jrt.synthesize_ir_from_histogram(
        jax.random.PRNGKey(1), jnp.asarray(hist), jnp.asarray(BANDS), n, bin_dt, sr=SR, encoding="binaural"))
    got = trt.synthesize_ir_from_histogram(
        torch.Generator().manual_seed(1), _t(hist), _t(BANDS), n, bin_dt, sr=SR, encoding="binaural").numpy()
    for ir in (got, want):
        np.testing.assert_allclose(ir[1], 0.5 * ir[0], rtol=0, atol=1e-5 * np.abs(ir[0]).max())
    np.testing.assert_allclose((got.astype(np.float64) ** 2).sum(-1), (want.astype(np.float64) ** 2).sum(-1),
                               rtol=0.05)


@pytest.mark.parametrize("layout", ["binaural", "hoa2", "hoa3"])
def test_rig_to_dict_matches_reference(layout):
    make = (lambda m: m.Binaural()) if layout == "binaural" else (lambda m: m.HOAListener(channel_layout_type=layout))
    want, got = make(jmic), make(tmic)
    for mic in (want, got):
        mic.set_absolute_coordinates([2.0, 1.5, 1.2])
    assert got.to_dict() == want.to_dict()
    assert got.n_channels == want.n_channels == {"binaural": 2, "hoa2": 9, "hoa3": 16}[layout]
    back = tmic.MicArray.from_dict(json.loads(json.dumps(want.to_dict())))
    assert type(back) is type(got) and back.to_dict() == want.to_dict()


def test_measured_hrtfs_raise():
    """`Binaural(hrtf_sofa=...)`, which raised until measured HRTFs were
    ported, builds and round-trips through to_dict / from_dict as the
    reference's does (the set itself is held in test_torch_hrtf.py)."""
    want, got = jmic.Binaural(hrtf_sofa="head.sofa"), tmic.Binaural(hrtf_sofa="head.sofa")
    for mic in (want, got):
        mic.set_absolute_coordinates([1.0, 1.0, 1.0])
    assert got.to_dict() == want.to_dict() and got.to_dict()["hrtf_sofa"] == "head.sofa"
    back = tmic.MicArray.from_dict(json.loads(json.dumps(want.to_dict())))
    assert type(back) is tmic.Binaural and back.hrtf_sofa == "head.sofa" and back.to_dict() == want.to_dict()


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("rigs")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    return root / "fg", save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")


def _scene(scene_cls, seed_everything, fg, obj, mic, **device):
    seed_everything(7)
    scene = scene_cls(
        duration=6.0, sample_rate=SR, backend="rlr", fg_path=fg, max_overlap=2,
        backend_kwargs=dict(mesh=str(obj), seed=11, add_to_context=False,
                            rlr_kwargs=dict(indirect_ray_count=64, indirect_ray_depth=4, max_ir_length=0.1,
                                            mesh_simplification=True)),
        **device,
    )
    scene.add_microphone(microphone_type=mic)
    for event_type in ("static", "static", "moving"):
        try:
            scene.add_event(event_type=event_type, max_place_attempts=100)
        except ValueError:
            pass
    scene.add_ambience(noise="gaussian")
    return scene


@pytest.mark.parametrize("mic,channels", [("binaural", 2), ("hoalistener", 16)])
def test_scene_with_rig_renders_on_the_fused_path(assets, tmp_path, mic, channels):
    """The rig places as the reference's (the same to_dict) and the scene
    renders through the fused renderer (`render_scenes_pipelined`, the SELD CLI's rlr
    path; per-face rain visibility) to an int16 WAV of the rig's channels."""
    from audiblelight_tpu_torch.core import write_outputs
    from audiblelight_tpu_torch.pipeline import render_scenes_pipelined

    fg, obj = assets
    want = _scene(JaxScene, jutils.seed_everything, fg, obj, mic)
    got = _scene(PortScene, tutils.seed_everything, fg, obj, mic, device="cpu")
    render_scenes_pipelined([got], lambda scene, payloads: setattr(scene, "audio", payloads),
                            device_mix=True)
    write_outputs(got, tmp_path / "audio_out", tmp_path / "metadata_out")
    audio = got.audio["mic000"]
    assert audio.dtype == np.int16 and audio.shape == (channels, 6 * SR) and np.abs(audio).max() > 100
    data, sr = wav_read(tmp_path / "audio_out_mic000.wav")
    assert sr == SR and data.shape == (channels, 6 * SR)
    want.state._update()
    got_d, want_d = (json.loads(json.dumps(s.to_dict())) for s in (got, want))
    got_d.pop("creation_time"), want_d.pop("creation_time")
    assert got_d == want_d
