"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card. The file imports
neither JAX nor the JAX package (tests/test_torch_kernels.py holds the plain
versions against the Pallas kernels), so it also runs where only PyTorch is
installed, without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: face indices, occlusion booleans and first-hit t identical (the
kernels are built with --fmad=false, and eager PyTorch never contracts a
multiply-add); deposit histograms with the same bins and sums within 1e-5 of
the peak (shared-memory atomics add in another order).
"""

import numpy as np
import pytest
import torch

from audiblelight_tpu_torch.ops import cuda_kernels as ck


def random_tris(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    tris = np.stack([a, a + rng.normal(0, 1, (n, 3)), a + rng.normal(0, 1, (n, 3))], 1)
    return tris.astype(np.float32)


def unit_dirs(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def deposit_inputs(rng, e, r, c, b, dist_max):
    tr = e * r
    hit = rng.uniform(0, 5, (tr, 3)).astype(np.float32)
    normal = rng.standard_normal((tr, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    e_refl = (rng.random((tr, b)) * 1e-3).astype(np.float32)
    dist = (rng.random(tr) * dist_max).astype(np.float32)
    occ = rng.random((c, tr)) < 0.3
    lis = rng.uniform(1, 4, (c, 3)).astype(np.float32)
    return hit, normal, e_refl, dist, occ, lis


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_faces", [300, 4071])
def test_first_hit_matches_plain(card, n_faces):
    """Both variants: classic Moller-Trumbore (F <= 512) and the big one."""
    rng = np.random.default_rng(n_faces)
    tris = torch.from_numpy(random_tris(n_faces, n_faces)).to(card)
    o = torch.from_numpy(rng.uniform(-5, 5, (5000, 3)).astype(np.float32)).to(card)
    d = torch.from_numpy(unit_dirs(rng, 5000)).to(card)
    t_k, i_k = ck.ray_first_hit(o, d, tris)
    t_p, i_p = ck.ray_first_hit_plain(o, d, tris)
    assert torch.equal(i_k, i_p)
    assert torch.equal(t_k, t_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n_seg,n_faces,reach", [(20000, 4071, 5.0), (64, 27648, 0.3)])
def test_occlusion_matches_plain(card, n_seg, n_faces, reach):
    """Many segments (one face slice each) and few, short segments against
    many faces (the faces split into slices)."""
    rng = np.random.default_rng(n_seg)
    tris = torch.from_numpy(random_tris(7, n_faces)).to(card)
    s = torch.from_numpy(rng.uniform(-5, 5, (n_seg, 3)).astype(np.float32)).to(card)
    e = s + torch.from_numpy(rng.uniform(-reach, reach, (n_seg, 3)).astype(np.float32)).to(card)
    got = ck.segments_occluded(s, e, tris)
    assert torch.equal(got, ck.segments_occluded_plain(s, e, tris))
    assert 0 < int(got.sum()) < n_seg


@pytest.mark.cuda
def test_deposit_histogram_matches_plain(card):
    args = [torch.from_numpy(x).to(card) for x in deposit_inputs(np.random.default_rng(3), 16, 5000, 4, 4, 300.0)]
    kw = dict(n_sources=16, n_bins=501, bin_dt=0.002, c_sound=343.0)
    got = ck.deposit_histogram(*args, **kw)
    want = ck.deposit_histogram_plain(*args, **kw)
    assert torch.equal(got != 0, want != 0)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_each_wrapper_counts_its_launch(card):
    """A wrapper on CUDA tensors launches its kernel once and counts it; the
    plain versions launch nothing."""
    rng = np.random.default_rng(4)
    tris = torch.from_numpy(random_tris(4, 600)).to(card)
    o = torch.from_numpy(rng.uniform(-3, 3, (64, 3)).astype(np.float32)).to(card)
    args = [torch.from_numpy(x).to(card) for x in deposit_inputs(rng, 2, 64, 2, 4, 20.0)]
    kw = dict(n_sources=2, n_bins=51, bin_dt=0.002, c_sound=343.0)
    ck.reset_launch_counts()
    ck.ray_first_hit_plain(o, o, tris)
    ck.segments_occluded_plain(o, o + 1.0, tris)
    ck.deposit_histogram_plain(*args, **kw)
    assert all(v == 0 for v in ck.launch_counts.values())
    ck.ray_first_hit(o, torch.from_numpy(unit_dirs(rng, 64)).to(card), tris)
    ck.segments_occluded(o, o + 1.0, tris)
    ck.deposit_histogram(*args, **kw)
    assert ck.launch_counts == {"first_hit_big": 1, "first_hit_small": 0, "any_hit": 1, "deposit_histogram": 1}
