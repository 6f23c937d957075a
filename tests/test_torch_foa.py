"""The port's FOA (first-order ambisonic) path against the JAX package.

- K4: the plain version of `deposit_histogram_foa` against the Pallas kernel
  in interpret mode. Bins identical (the same non-zero pattern); values
  within rtol 1e-5 plus 1e-6 of the histogram's peak (fp32 sums in another
  order; the X, Y and Z channels are signed and cancel, so an element near
  zero is held by the peak term).
- SH gains: identical, bit for bit.
- Direct path within 5e-5 and diffracted path within 1e-4 of the reference's
  peak, the omni tolerances of tests/test_torch_raytracer.py (last-bit f32
  transcendentals move a band-limited pulse).
- The tail synthesis and the whole trace draw other random numbers than the
  reference, so they are held statistically: the X/Y/Z envelopes at the
  histogram's signed ratios to W (exactly, as the carrier is shared), the
  W energy to the histogram's within 5 %, per-band energies within 5 % and
  T30 within 10 % (the omni tolerances), DRR within 1 dB, the X/Y/Z-to-W
  energy ratios within 10 % or 0.02, and EDT within 15 %: one realisation's
  EDT spreads by 5 % (standard deviation over 10 seeds, in either package)
  while the 10-seed means of the two packages agree within 3 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.mesh import scanned_like_room
from audiblelight_tpu.ops.pallas_kernels import deposit_histogram_foa_pallas
from audiblelight_tpu.rir import raytracer as jrt
from audiblelight_tpu.rir import sh as jsh
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.rir import raytracer as trt
from audiblelight_tpu_torch.rir import sh as tsh
from test_torch_cuda import deposit_inputs
from test_torch_raytracer import BANDS, CASES, SR, _close, _t, _t30

torch.set_num_threads(1)


def _assert_histograms_match(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize(
    "e,r,b,n_bins,dist_max",
    [(3, 200, 4, 51, 20.0), (16, 300, 4, 501, 300.0), (2, 100, 1, 128, 1.0), (16, 300, 4, 501, (10.0, 30.0, 100.0))],
)
def test_deposit_histogram_foa_matches_pallas(rng, e, r, b, n_bins, dist_max):
    """(16, 300, 4, 501) is the flagship FOA histogram shape (501 bins padded
    to 512), with arrivals in the padding and past it; the third case fills
    no padding; the last crowds each source's arrivals into a few bins, as a
    real bounce's are (`deposit_inputs` with a tuple of path lengths)."""
    args = deposit_inputs(rng, e, r, 1, b, dist_max)
    kw = dict(n_sources=e, n_bins=n_bins, bin_dt=0.002, c_sound=343.0)
    want = np.asarray(deposit_histogram_foa_pallas(*map(jnp.asarray, args), interpret=True, **kw))
    got = ck.deposit_histogram_foa(*map(torch.from_numpy, args), **kw).numpy()
    assert got.shape == (e, 4, b, n_bins)
    _assert_histograms_match(got, want)


def test_deposit_histogram_foa_bin_edges_and_padding():
    """Arrivals a few ULPs around bin edges land where int(arrival * (1 /
    bin_dt)) puts them, as in the Pallas kernel; arrivals in the padded bins
    (n_bins <= bin < 128) and beyond them (>= 128 bins) deposit nothing."""
    bin_dt, c_sound, n_bins = 0.002, 343.0, 16
    lis = np.array([[0.0, 0.0, 0.0]], np.float32)
    d = np.float32(3.0)  # d = |v| exactly, whatever the rounding of the norm
    edges = [np.float32(k * bin_dt * c_sound) - d for k in (7, 8, 9)]
    edges += [np.nextafter(x, np.float32(0)) for x in edges] + [np.nextafter(x, np.float32(1e9)) for x in edges]
    padded = [np.float32(40 * bin_dt * c_sound) - d, np.float32(127.5 * bin_dt * c_sound) - d]
    beyond = [np.float32(128 * bin_dt * c_sound), np.float32(300 * bin_dt * c_sound)]
    dist = np.array(edges + padded + beyond, np.float32)
    n = len(dist)
    hit = np.tile(np.array([[d, 0.0, 0.0]], np.float32), (n, 1))
    normal = np.tile(np.array([[-1.0, 0.0, 0.0]], np.float32), (n, 1))
    args = (hit, normal, np.ones((n, 2), np.float32), dist, np.zeros((1, n), bool), lis)
    kw = dict(n_sources=n, n_bins=n_bins, bin_dt=bin_dt, c_sound=c_sound)
    want = np.asarray(deposit_histogram_foa_pallas(*map(jnp.asarray, args), interpret=True, **kw))
    got = ck.deposit_histogram_foa(*map(torch.from_numpy, args), **kw).numpy()
    _assert_histograms_match(got, want)
    placed = (want != 0).any(axis=(1, 2, 3))
    assert placed[: len(edges)].all() and not placed[len(edges):].any()
    # The arrival vector (listener -> hit) is +x: X carries the deposit, Y and Z nothing
    np.testing.assert_array_equal(got[:, 1], got[:, 0])
    assert not got[:, 2:].any()


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_sh_gains_match_reference(rng, order):
    dirs = rng.standard_normal((257, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = np.asarray(jsh.sh_real(order, jnp.asarray(dirs)))
    got = tsh.sh_real(order, torch.from_numpy(dirs)).numpy()
    np.testing.assert_array_equal(got, want)
    for encoding in ("foa", "sh2", "sh3"):
        want = np.asarray(jsh.ambisonic_encoding_gains(jnp.asarray(dirs), order, encoding))
        got = tsh.ambisonic_encoding_gains(torch.from_numpy(dirs), order, encoding).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsh.foa_encoding_gains(torch.from_numpy(dirs)).numpy(),
                                  np.asarray(jsh.foa_encoding_gains(jnp.asarray(dirs))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_foa_direct_and_diffracted_match_reference(name):
    """The FOA listener behind one barrier (single bend) and two (the
    multi-bend graph), direct path encoded at order 3 clipped to 1."""
    make, src, centre, order = CASES[name]
    tris = make().triangles.astype(np.float32)
    src = np.asarray(src, np.float32)
    lis = np.asarray([centre], np.float32)
    n = SR // 2
    want_d = np.asarray(jrt.direct_paths_ir(jnp.asarray(tris), jnp.asarray(src), jnp.asarray(lis), n, sr=SR,
                                            encoding="foa", sh_order=3))
    want_g = np.asarray(jax.vmap(lambda s: jrt.diffracted_path_ir(
        jnp.asarray(tris), s, jnp.asarray(lis), jnp.asarray(BANDS), n, sr=SR, order=order,
        encoding="foa", sh_order=3))(jnp.asarray(src)))
    got_d = trt.direct_paths_ir(_t(tris), _t(src), _t(lis), n, sr=SR, encoding="foa", sh_order=3).numpy()
    got_g = trt.diffracted_path_ir(_t(tris), _t(src), _t(lis), _t(BANDS), n, sr=SR, order=order,
                                   encoding="foa", sh_order=3).numpy()
    assert got_d.shape == want_d.shape == (3, 4, n)
    _close(got_d, want_d, 5e-5)
    _close(got_g, want_g, 1e-4)
    occluded = np.abs(want_d).max(axis=-1)[:, 0] == 0
    assert occluded.any() and (~occluded).any() and np.abs(want_g).max() > 1e-8


def test_foa_tail_synthesis():
    """A W histogram with X/Y/Z at fixed signed ratios: the X/Y/Z IRs are
    those ratios times the W IR, and the W energy is the histogram's, in
    both packages."""
    n_bins, bin_dt, n = 126, 0.002, SR // 4
    ratios = np.array([0.6, -0.3, 0.2], np.float32)
    for b in range(len(BANDS)):
        hist = np.zeros((4, len(BANDS), n_bins), np.float32)
        hist[0, b] = 1e-3
        hist[1:, b] = ratios[:, None] * hist[0, b]
        want = np.asarray(jrt.synthesize_ir_from_histogram(
            jax.random.PRNGKey(b), jnp.asarray(hist), jnp.asarray(BANDS), n, bin_dt, sr=SR, encoding="foa"))
        got = trt.synthesize_ir_from_histogram(
            torch.Generator().manual_seed(b), _t(hist), _t(BANDS), n, bin_dt, sr=SR, encoding="foa").numpy()
        assert got.shape == want.shape == (4, n)
        for ir in (got, want):
            np.testing.assert_allclose(ir[1:], ratios[:, None] * ir[0], rtol=0, atol=1e-5 * np.abs(ir[0]).max())
        e_got = (got[0].astype(np.float64) ** 2).sum()
        e_want = (want[0].astype(np.float64) ** 2).sum()
        np.testing.assert_allclose(e_got, e_want, rtol=0.05)
        np.testing.assert_allclose(e_got, hist[0, b].sum() * n / (bin_dt * SR) / n_bins, rtol=0.05)


def _edt(ir: np.ndarray) -> float:
    """Early decay time (s) of an IR: the 0 to -10 dB Schroeder slope,
    extrapolated to 60 dB."""
    sch = np.cumsum((ir.astype(np.float64) ** 2)[::-1])[::-1]
    db = 10 * np.log10(np.maximum(sch / sch[0], 1e-30))
    sel = (db <= 0) & (db >= -10)
    return -60.0 / np.polyfit(np.arange(len(db))[sel] / SR, db[sel], 1)[0]


def _drr_db(ir: np.ndarray, arrival: float) -> float:
    """Direct-to-reverberant ratio (dB): energy within 1 ms of the direct
    arrival over the energy after it."""
    e = ir.astype(np.float64) ** 2
    lo, hi = int(arrival) - SR // 1000, int(arrival) + SR // 1000
    return 10 * np.log10(e[lo:hi].sum() / e[hi:].sum())


def test_foa_trace_matches_reference_statistics():
    """The whole FOA trace in a small nonconvex room with per-face rain
    visibility and wavefront decimation: the W histogram's per-band energy
    and T30, the IRs' W EDT and DRR, and the X/Y/Z-to-W IR energy ratios."""
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=1, seed=0)
    tris = mesh.triangles.astype(np.float32)
    normals = mesh.face_normals.astype(np.float32)
    f = len(tris)
    absorption = np.tile(np.array([[0.10, 0.15, 0.20, 0.30]], np.float32), (f, 1))
    scattering = np.full(f, 0.4, np.float32)
    src = np.array([[5.6, 3.9, 1.1], [1.0, 4.0, 1.5]], np.float32)  # both see the listener
    lis = np.array([[3.5, 2.5, 1.5]], np.float32)
    n = int(0.3 * SR)
    kw = dict(n_rays=2048, max_depth=30, bin_dt=0.002, decimate=True)
    n_bins = int(np.ceil(n / SR / kw["bin_dt"])) + 1
    occ_j = jrt.face_rain_occlusion(jnp.asarray(tris), jnp.asarray(normals), jnp.asarray(lis))
    jargs = (jnp.asarray(tris), jnp.asarray(absorption), jnp.asarray(scattering), jnp.asarray(src),
             jnp.asarray(lis))
    jkw = dict(tri_normals=jnp.asarray(normals), face_occlusion=occ_j, encoding="foa", **kw)
    k_trace, _ = jax.random.split(jax.random.PRNGKey(0))
    want_h = np.asarray(jrt.trace_energy_histogram_multi(k_trace, *jargs, n_sources=2, n_bins=n_bins, **jkw))
    want_ir = np.asarray(jrt.trace_rirs_multi(jax.random.PRNGKey(0), *jargs, n, sr=SR, **jkw))

    occ_t = trt.face_rain_occlusion(_t(tris), _t(normals), _t(lis))
    targs = (_t(tris), _t(absorption), _t(scattering), _t(src), _t(lis))
    tkw = dict(tri_normals=_t(normals), face_occlusion=occ_t, encoding="foa", **kw)
    got_h = trt.trace_energy_histogram_multi(torch.Generator().manual_seed(0), *targs, n_bins=n_bins,
                                             **tkw).numpy()
    got_ir = trt.trace_rirs_multi(torch.Generator().manual_seed(1), *targs, n, sr=SR, **tkw).numpy()

    assert got_h.shape == want_h.shape == (2, 4, 4, n_bins)
    assert got_ir.shape == want_ir.shape == (4, 2, n)
    np.testing.assert_allclose(got_h[:, 0].sum(-1), want_h[:, 0].sum(-1), rtol=0.05)
    for e in range(2):
        for b in range(4):
            t_got, t_want = _t30(got_h[e, 0, b], 0.002), _t30(want_h[e, 0, b], 0.002)
            assert abs(t_got / t_want - 1) < 0.10, (e, b, t_got, t_want)
        arrival = np.linalg.norm(src[e] - lis[0]) * SR / 343.0
        w_got, w_want = got_ir[0, e], want_ir[0, e]
        assert abs(_edt(w_got) / _edt(w_want) - 1) < 0.15
        assert abs(_drr_db(w_got, arrival) - _drr_db(w_want, arrival)) < 1.0
        e_got = (got_ir[:, e].astype(np.float64) ** 2).sum(-1)
        e_want = (want_ir[:, e].astype(np.float64) ** 2).sum(-1)
        np.testing.assert_allclose(e_got[1:] / e_got[0], e_want[1:] / e_want[0], rtol=0.10, atol=0.02)
