"""The port's tracer kernels (audiblelight_tpu_torch.ops.cuda_kernels).

On the CPU each wrapper runs its kernel's plain PyTorch version; these tests
hold that plain version against the Pallas kernel run in interpret mode, on
the cases of tests/test_pallas.py. tests/test_torch_cuda.py holds the CUDA
kernels against the plain versions on the card.

Tolerances:
- face indices and occlusion booleans: identical;
- first-hit t: rtol 1e-4, atol 2e-5 (the tolerance tests/test_pallas.py
  holds two f32 roundings of the same algebra to). XLA:CPU contracts the
  interpret-mode kernel body's multiply-adds into fused multiply-adds; the
  port keeps them uncontracted (eager PyTorch on the CPU, nvcc --fmad=false on
  the card), so t differs in the last bits, most where `a` cancels;
- deposit histograms: bins identical (same non-zero pattern), sums within
  1e-6 of the histogram's peak (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.mesh import box_mesh
from audiblelight_tpu.ops.pallas_kernels import (
    LANES,
    RAY_BLOCK,
    SMALL_F_MAX,
    deposit_histogram_pallas,
    ray_first_hit_pallas,
    segments_occluded_pallas,
)
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from test_torch_cuda import deposit_inputs, random_tris, unit_dirs

torch.set_num_threads(1)


def _first_hit_both(origins, dirs, tris):
    t_p, i_p = map(np.asarray, ray_first_hit_pallas(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(tris), interpret=True))
    t_t, i_t = ck.ray_first_hit(torch.from_numpy(origins), torch.from_numpy(dirs), torch.from_numpy(tris))
    return t_p, i_p, t_t.numpy(), i_t.numpy()


def _assert_first_hit_matches(origins, dirs, tris):
    t_p, i_p, t_t, i_t = _first_hit_both(origins, dirs, tris)
    assert t_t.dtype == np.float32 and i_t.dtype == np.int32
    np.testing.assert_array_equal(i_t, i_p)
    np.testing.assert_array_equal(np.isinf(t_t), np.isinf(t_p))
    np.testing.assert_allclose(t_t, t_p, rtol=1e-4, atol=2e-5)
    return t_t, i_t


@pytest.mark.parametrize(
    "case,n_faces,n_rays",
    [("small", 300, 200), ("big", 700, 300), ("duplicate", 600, 64)],
)
def test_first_hit_random_soup(rng, case, n_faces, n_rays):
    """Random soups on both sides of SMALL_F_MAX; "duplicate" repeats a
    300-face soup so every hit ties and the smallest index must win."""
    if case == "duplicate":
        tris = np.concatenate([random_tris(10, n_faces // 2)] * 2)
    else:
        tris = random_tris(n_faces, n_faces)
    origins = rng.uniform(-5, 5, (n_rays, 3)).astype(np.float32)
    _, idx = _assert_first_hit_matches(origins, unit_dirs(rng, n_rays), tris)
    if case == "duplicate":
        assert (idx[idx >= 0] < n_faces // 2).all()


def test_first_hit_box_interior(rng):
    tris = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25]).triangles.astype(np.float32)
    origins = rng.uniform([0.5] * 3, [3.5, 2.5, 2.0], (64, 3)).astype(np.float32)
    t, idx = _assert_first_hit_matches(origins, unit_dirs(rng, 64), tris)
    assert (idx >= 0).all() and (t <= np.linalg.norm([4, 3, 2.5]) + 1e-4).all()


def test_first_hit_escaping_rays():
    tris = random_tris(1, 40)
    origins = np.full((8, 3), 100.0, dtype=np.float32)
    dirs = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (8, 1))
    t, idx = _assert_first_hit_matches(origins, dirs, tris)
    assert np.isinf(t).all() and (idx == -1).all()


@pytest.mark.parametrize("r,f", [(1, 1), (7, 5), (RAY_BLOCK + 3, LANES + 1), (5, SMALL_F_MAX + 1)])
def test_first_hit_padding_shapes(rng, r, f):
    tris = random_tris(2, f)
    origins = rng.uniform(-3, 3, (r, 3)).astype(np.float32)
    t, idx = _assert_first_hit_matches(origins, unit_dirs(rng, r), tris)
    assert t.shape == (r,) and idx.shape == (r,)


def test_first_hit_big_variant_centring_excludes_sentinels(rng):
    """Sentinel faces at 1e9 are left out of the big variant's centre: the
    room far from the origin keeps its precision, and the sentinels never hit."""
    room = box_mesh(extents=[6.0, 4.0, 3.0], center=[503.0, 402.0, 301.5]).triangles
    tris = np.concatenate([np.tile(room, (50, 1, 1)), np.full((20, 3, 3), 1.0e9)]).astype(np.float32)
    assert tris.shape[0] > SMALL_F_MAX
    origins = (rng.uniform([-2.5, -1.5, -1.0], [2.5, 1.5, 1.0], (128, 3)) + [503.0, 402.0, 301.5])
    t, idx = _assert_first_hit_matches(origins.astype(np.float32), unit_dirs(rng, 128), tris)
    assert (idx >= 0).all() and (idx < 12).all()  # the first copy of the room wins every tie


def test_big_face_table_columns():
    """The (F, 16) table is [e2, w2, -e1, -w1, -n, -k] in centred coordinates."""
    tris = random_tris(3, SMALL_F_MAX + 8)
    got_center, tab = ck.big_face_table(torch.from_numpy(tris))
    tab = tab.numpy().astype(np.float64)
    verts = tris.reshape(-1, 3).astype(np.float64)
    center = 0.5 * (verts.min(0) + verts.max(0))
    np.testing.assert_allclose(got_center.numpy(), center, rtol=1e-6)
    a = tris[:, 0] - center
    e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2)
    want = np.concatenate(
        [e2, np.cross(a, e2), -e1, -np.cross(a, e1), -n, -np.sum(a * n, 1, keepdims=True)], 1
    )
    np.testing.assert_allclose(tab, want, rtol=1e-5, atol=1e-4)


def _occluded_both(starts, ends, tris):
    p = np.asarray(segments_occluded_pallas(
        jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(tris), interpret=True))
    t = ck.segments_occluded(torch.from_numpy(starts), torch.from_numpy(ends), torch.from_numpy(tris)).numpy()
    assert t.dtype == bool
    np.testing.assert_array_equal(t, p)
    return t


@pytest.mark.parametrize("n_faces,n_seg", [(200, 300), (SMALL_F_MAX + 100, 257)])
def test_occlusion_random_soup(rng, n_faces, n_seg):
    tris = random_tris(5 + n_faces, n_faces)
    starts = rng.uniform(-5, 5, (n_seg, 3)).astype(np.float32)
    ends = rng.uniform(-5, 5, (n_seg, 3)).astype(np.float32)
    occ = _occluded_both(starts, ends, tris)
    assert 0 < occ.sum() < len(occ)


def test_occlusion_box_walls_and_padding(rng):
    """Interior segments of a convex box are free, segments through a wall are
    blocked, and zero-length segments (the kernel's padding) never are."""
    tris = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25]).triangles.astype(np.float32)
    a = rng.uniform([0.3] * 3, [3.7, 2.7, 2.2], (32, 3)).astype(np.float32)
    b = rng.uniform([0.3] * 3, [3.7, 2.7, 2.2], (32, 3)).astype(np.float32)
    assert not _occluded_both(a, b, tris).any()
    assert _occluded_both(a, b + np.float32([10.0, 0.0, 0.0]), tris).all()
    assert not _occluded_both(a, a, tris).any()


def test_occlusion_endpoint_margin():
    tris = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25]).triangles.astype(np.float32)
    starts = np.array([[2.0, 1.5, 1.25]], np.float32)
    ends = np.array([[4.0, 1.5, 1.25]], np.float32)  # on the +x wall
    assert not _occluded_both(starts, ends, tris)[0]


@pytest.mark.parametrize(
    "e,r,c,b,n_bins,dist_max",
    [(3, 200, 2, 4, 51, 20.0), (16, 300, 4, 4, 501, 300.0), (2, 100, 1, 1, 128, 1.0)],
)
def test_deposit_histogram_matches_pallas(rng, e, r, c, b, n_bins, dist_max):
    """(16, 300, 4, 4, 501) is the flagship's histogram shape (501 bins padded
    to 512) with arrivals past the window; the last case fills no padding."""
    args = deposit_inputs(rng, e, r, c, b, dist_max)
    kw = dict(n_sources=e, n_bins=n_bins, bin_dt=0.002, c_sound=343.0)
    want = np.asarray(deposit_histogram_pallas(*map(jnp.asarray, args), interpret=True, **kw))
    got = ck.deposit_histogram(*map(torch.from_numpy, args), **kw).numpy()
    assert got.shape == want.shape == (e, c, b, n_bins) and got.dtype == np.float32
    np.testing.assert_array_equal(got != 0, want != 0)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_deposit_histogram_bins_by_reciprocal_multiply():
    """A deposit whose arrival sits on a bin boundary lands where
    int(arrival * (1 / bin_dt)) puts it, as in the Pallas kernel."""
    bin_dt, c_sound = 0.002, 343.0
    lis = np.array([[0.0, 0.0, 0.0]], np.float32)
    d = np.float32(3.0)
    hit = np.array([[d, 0.0, 0.0]], np.float32)
    normal = np.array([[-1.0, 0.0, 0.0]], np.float32)
    # Path lengths that put the arrival within a few ULPs of bin edges
    dists = np.array([np.float32(k * bin_dt * c_sound) - d for k in (7, 8, 9)], np.float32)
    for dist in dists:
        args = (hit, normal, np.ones((1, 1), np.float32), np.array([dist]), np.zeros((1, 1), bool), lis)
        kw = dict(n_sources=1, n_bins=16, bin_dt=bin_dt, c_sound=c_sound)
        want = np.asarray(deposit_histogram_pallas(*map(jnp.asarray, args), interpret=True, **kw))
        got = ck.deposit_histogram(*map(torch.from_numpy, args), **kw).numpy()
        np.testing.assert_array_equal(np.flatnonzero(got), np.flatnonzero(want))


def test_launch_counts_untouched_on_cpu(rng):
    """On CPU tensors the wrappers run the plain versions and launch nothing."""
    ck.reset_launch_counts()
    tris = torch.from_numpy(random_tris(4, 20))
    o = torch.from_numpy(rng.uniform(-3, 3, (4, 3)).astype(np.float32))
    ck.ray_first_hit(o, torch.from_numpy(unit_dirs(rng, 4)), tris)
    ck.segments_occluded(o, o + 1.0, tris)
    assert all(v == 0 for v in ck.launch_counts.values())

