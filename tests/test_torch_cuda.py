"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card. The file imports
neither JAX nor the JAX package (tests/test_torch_kernels.py holds the plain
versions against the Pallas kernels), so it also runs where only PyTorch is
installed, without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: face indices, occlusion booleans and first-hit t identical (the
kernels are built with --fmad=false, and eager PyTorch never contracts a
multiply-add); the star any-hit (K6) identical to its plain version and to
the dense any-hit (K2); deposit histograms (K3 and the FOA K4) and the
grouped histogram (K5) with the same bins and sums within 1e-5 of the peak
(atomics add in another order); the tiled first hit (K7) identical to its
plain version, and to the dense classic Moller-Trumbore first hit wherever
the two t differ by more than 1 ulp (a rounding tie at the early exit's
bound may go either way); the bilinear first hit (K8) identical to its
plain version; the cone-sorted (K9) and pair-walk (K10) first hits
identical to their plain versions and to the dense big first hit (K1) over
the Morton-sorted faces.
"""

import numpy as np
import pytest
import torch

from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
from audiblelight_tpu_torch.micarrays import ambeovr_capsules
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.ops import mxu_first_hit as mxu
from audiblelight_tpu_torch.ops import pair_first_hit as pfh
from audiblelight_tpu_torch.ops import sorted_first_hit as sfh
from audiblelight_tpu_torch.ops import star_occlusion as so
from audiblelight_tpu_torch.ops import tiled_first_hit as tfh


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
def test_deposit_histogram_foa_matches_plain(card):
    """K4 at the flagship FOA shape: 16 sources x 5,000 rays, one listener."""
    args = [torch.from_numpy(x).to(card) for x in deposit_inputs(np.random.default_rng(5), 16, 5000, 1, 4, 300.0)]
    kw = dict(n_sources=16, n_bins=501, bin_dt=0.002, c_sound=343.0)
    got = ck.deposit_histogram_foa(*args, **kw)
    want = ck.deposit_histogram_foa_plain(*args, **kw)
    assert got.shape == (16, 4, 4, 501)
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
    foa = [torch.from_numpy(x).to(card) for x in deposit_inputs(rng, 2, 64, 1, 4, 20.0)]
    kw = dict(n_sources=2, n_bins=51, bin_dt=0.002, c_sound=343.0)
    bins = torch.from_numpy(rng.integers(-1, 51, (2, 64)).astype(np.int32)).to(card)
    dep = torch.from_numpy(rng.random((2, 64, 8)).astype(np.float32)).to(card)
    star = so.build_star_accel(tris.cpu().numpy(), [0.0, 0.0, 0.0], device=card)
    tiles = tfh.build_mesh_tiles(tris.cpu().numpy(), device=card)
    tables = mxu.build_mxu_face_tables(tris)
    stiles, _ = sfh.build_sorted_tiles(tris.cpu().numpy(), device=card)
    d = torch.from_numpy(unit_dirs(rng, 64)).to(card)
    ck.reset_launch_counts()
    ck.ray_first_hit_plain(o, o, tris)
    ck.segments_occluded_plain(o, o + 1.0, tris)
    ck.deposit_histogram_plain(*args, **kw)
    ck.deposit_histogram_foa_plain(*foa, **kw)
    ck.bin_histogram_plain(bins, dep, 51)
    so.star_segments_occluded_plain(star, o, torch.zeros(3, device=card))
    tfh.tiled_walk(tiles, o, d)
    mxu.mxu_first_hit_plain(tables, o, d)
    sfh.sorted_walk(stiles, o, d)
    pfh.pair_walk(stiles, o, d, k_slots=8)
    assert all(v == 0 for v in ck.launch_counts.values())
    ck.ray_first_hit(o, torch.from_numpy(unit_dirs(rng, 64)).to(card), tris)
    ck.segments_occluded(o, o + 1.0, tris)
    ck.deposit_histogram(*args, **kw)
    ck.deposit_histogram_foa(*foa, **kw)
    ck.bin_histogram(bins, dep, 51)
    so.star_segments_occluded(star, o, torch.zeros(3, device=card))
    tfh.tiled_first_hit(tiles, o, d)
    mxu.mxu_first_hit(tables, o, d)
    sfh.sorted_first_hit(stiles, o, d)
    # k_slots = n_tiles: one round tests every reachable tile, one launch
    pfh.pair_first_hit(stiles, o, d, k_slots=stiles.n_tiles)
    assert ck.launch_counts == {"first_hit_big": 1, "first_hit_small": 0, "any_hit": 1, "deposit_histogram": 1,
                                "deposit_histogram_foa": 1, "bin_histogram": 1, "star_any_hit": 1,
                                "first_hit_tiled": 1, "first_hit_mxu": 1, "first_hit_sorted": 1, "first_hit_pair": 1}


@pytest.fixture(scope="module")
def scanned_room():
    """27,648 faces: the flagship room one subdivision level down."""
    return scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=4, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_seg,kind,toward", [(3000, "surface", "centroid"), (20000, "interior", "capsule"),
                                               (100, "surface", "capsule")])
def test_star_matches_plain_and_dense(card, scanned_room, n_seg, kind, toward):
    """K6 on surface and interior starts, toward the rig's centroid (r_pad
    0.02) and toward a capsule (r_pad the capsules' reach + 0.02), one block
    and many."""
    tris = scanned_room.triangles.astype(np.float32)
    caps = ambeovr_capsules([3.5, 2.5, 1.5]).astype(np.float32)
    centre = caps.mean(axis=0)
    r_pad = 0.02 if toward == "centroid" else float(np.linalg.norm(caps - centre, axis=1).max()) + 0.02
    end = centre if toward == "centroid" else caps[1]
    rng = np.random.default_rng(n_seg)
    if kind == "interior":
        starts = rng.uniform([0.05, 0.05, 0.05], [6.95, 4.95, 2.95], (n_seg, 3)).astype(np.float32)
    else:
        fi = rng.integers(0, len(tris), n_seg)
        w = rng.dirichlet([1.0, 1.0, 1.0], n_seg).astype(np.float32)
        starts = np.einsum("nk,nkd->nd", w, tris[fi]).astype(np.float32)
        starts += np.float32(1e-4) * np.sign(end - starts).astype(np.float32)
    star = so.build_star_accel(tris, centre, r_pad, device=card)
    s_t = torch.from_numpy(starts).to(card)
    e_t = torch.from_numpy(end).to(card)
    got = so.star_segments_occluded(star, s_t, e_t)
    assert torch.equal(got, so.star_segments_occluded_plain(star, s_t, e_t))
    dense = ck.segments_occluded(s_t, e_t.expand(n_seg, 3).contiguous(), torch.from_numpy(tris).to(card))
    assert torch.equal(got, dense)
    assert 0 < int(got.sum()) < n_seg


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 8], ids=["hoa3", "binaural"])
def test_bin_histogram_matches_plain(card, k):
    """K5 at the flagship bounce shapes: 16 sources x 5,000 rays, HOA3 (16
    channels x 4 bands) and binaural (2 x 4), 501 bins, some bins negative."""
    rng = np.random.default_rng(k)
    bins = rng.integers(-20, 501, (16, 5000)).astype(np.int32)
    dep = (rng.standard_normal((16, 5000, k)) * 1e-4).astype(np.float32)
    b_t, d_t = torch.from_numpy(bins).to(card), torch.from_numpy(dep).to(card)
    got = ck.bin_histogram(b_t, d_t, 501)
    want = ck.bin_histogram_plain(b_t, d_t, 501)
    assert got.shape == (16, 501, k)
    assert torch.equal(got != 0, want != 0)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _surface_rays(tris, card, n, seed):
    """Bounce rays: interior rays' first hits on `tris`, moved 1e-4 off the
    surface on the incoming side, along their specular reflections."""
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform([0.3, 0.3, 0.3], [6.7, 4.7, 2.7], (n, 3)).astype(np.float32)).to(card)
    d = torch.from_numpy(unit_dirs(rng, n)).to(card)
    tt = torch.from_numpy(tris).to(card)
    t, face = ck.ray_first_hit(o, d, tt)
    v = tt[face.clamp_min(0).long()]
    nrm = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    nrm = torch.where(((nrm * d).sum(1) > 0)[:, None], -nrm, nrm)
    refl = d - 2.0 * (d * nrm).sum(1, keepdim=True) * nrm
    hit = o + torch.where(torch.isfinite(t), t, 0.0)[:, None] * d
    return (hit + 1e-4 * nrm).contiguous(), refl.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,kind", [(20000, "interior"), (40000, "surface"), (300, "surface")])
def test_tiled_first_hit_matches_plain_and_dense(card, scanned_room, n_rays, kind):
    """K7 from interior and surface origins, one ragged block and many."""
    tris = scanned_room.triangles.astype(np.float32)
    rng = np.random.default_rng(n_rays)
    if kind == "interior":
        o = torch.from_numpy(rng.uniform([0.05, 0.05, 0.05], [6.95, 4.95, 2.95], (n_rays, 3)).astype(np.float32))
        o, d = o.to(card), torch.from_numpy(unit_dirs(rng, n_rays)).to(card)
    else:
        o, d = _surface_rays(tris, card, n_rays, n_rays)
    tiles = tfh.build_mesh_tiles(tris, device=card)
    t_k, i_k = tfh.tiled_first_hit(tiles, o, d)
    t_p, i_p, _ = tfh.tiled_walk(tiles, o, d)
    assert torch.equal(i_k, i_p) and torch.equal(t_k, t_p)
    tt = torch.from_numpy(tris).to(card)
    t_d, i_d = ck.ray_first_hit(o, d, tt, ck.dense_mt_table(tt))
    differ = (i_k != i_d) | (t_k != t_d)
    ulp = (t_k[differ].view(torch.int32).long() - t_d[differ].view(torch.int32).long()).abs()
    assert bool((ulp <= 1).all()), int(differ.sum())
    assert float(torch.isfinite(t_k).float().mean()) > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [80000, 257])
def test_mxu_first_hit_matches_plain(card, scanned_room, n_rays):
    """K8 on the room's 4,096-face LOD, surface rays with their launch
    faces masked, one ragged block and many."""
    lod = scanned_room.simplified(target_faces=4096)
    tris = lod.triangles.astype(np.float32)
    o, d = _surface_rays(tris, card, n_rays, 5)
    prev = torch.from_numpy(np.random.default_rng(5).integers(0, len(tris), n_rays).astype(np.int32)).to(card)
    tables = mxu.build_mxu_face_tables(torch.from_numpy(tris).to(card))
    for p in (None, prev):
        t_k, i_k = mxu.mxu_first_hit(tables, o, d, p)
        t_p, i_p = mxu.mxu_first_hit_plain(tables, o, d, p)
        assert torch.equal(i_k, i_p) and torch.equal(t_k, t_p)
    assert float((i_k >= 0).float().mean()) > 0.99


def _dense_big_sorted(tris, order, tiles, o, d, card):
    """The dense big first hit (K1) over the sentinel-padded sorted faces."""
    st = torch.from_numpy(sfh.padded_sorted_tris(tris, order, tiles.n_tiles)).to(card)
    centre, tab = ck.big_face_table(st)
    assert torch.equal(centre, tiles.center) and torch.equal(tab, tiles.face_tab)
    return ck.ray_first_hit(o, d, st, ("big", centre, tab))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,kind,dead", [(20000, "interior", 0.0), (40000, "surface", 0.45),
                                              (300, "surface", 0.0)])
def test_sorted_first_hit_matches_plain_and_dense(card, scanned_room, n_rays, kind, dead):
    """K9 on interior and surface rays, with and without dead lanes, one
    ragged block and many."""
    tris = scanned_room.triangles.astype(np.float32)
    rng = np.random.default_rng(n_rays)
    if kind == "interior":
        o = torch.from_numpy(rng.uniform([0.05, 0.05, 0.05], [6.95, 4.95, 2.95], (n_rays, 3)).astype(np.float32))
        o, d = o.to(card), torch.from_numpy(unit_dirs(rng, n_rays)).to(card)
    else:
        o, d = _surface_rays(tris, card, n_rays, n_rays)
    alive = torch.from_numpy(rng.uniform(size=n_rays) >= dead).to(card)
    tiles, order = sfh.build_sorted_tiles(tris, device=card)
    t_k, i_k = sfh.sorted_first_hit(tiles, o, d, alive)
    t_p, i_p, visited = sfh.sorted_walk(tiles, o, d, alive)
    assert torch.equal(i_k, i_p) and torch.equal(t_k, t_p)
    t_d, i_d = _dense_big_sorted(tris, order, tiles, o, d, card)
    assert torch.equal(i_k[alive], i_d[alive]) and torch.equal(t_k[alive], t_d[alive])
    assert bool(torch.isinf(t_k[~alive]).all()) and bool((i_k[~alive] == -1).all())
    assert 0 < int(visited.sum()) <= visited.numel() * tiles.n_tiles


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,k_slots,dead", [(20000, 8, 0.0), (40000, 8, 0.45), (300, 1, 0.0)])
def test_pair_first_hit_matches_plain_and_dense(card, scanned_room, n_rays, k_slots, dead):
    """K10 on surface rays, with and without dead lanes, k_slots = 1 forcing
    rounds."""
    tris = scanned_room.triangles.astype(np.float32)
    rng = np.random.default_rng(n_rays + 1)
    o, d = _surface_rays(tris, card, n_rays, n_rays + 1)
    alive = torch.from_numpy(rng.uniform(size=n_rays) >= dead).to(card)
    tiles, order = sfh.build_sorted_tiles(tris, device=card)
    t_k, i_k, stats_k = pfh.pair_walk(tiles, o, d, alive, k_slots=k_slots, kernel=ck.first_hit_pair)
    t_p, i_p, stats_p = pfh.pair_walk(tiles, o, d, alive, k_slots=k_slots)
    assert torch.equal(i_k, i_p) and torch.equal(t_k, t_p) and stats_k["rounds"] == stats_p["rounds"]
    t_d, i_d = _dense_big_sorted(tris, order, tiles, o, d, card)
    assert torch.equal(i_k[alive], i_d[alive]) and torch.equal(t_k[alive], t_d[alive])
    assert bool(torch.isinf(t_k[~alive]).all()) and bool((i_k[~alive] == -1).all())
    if k_slots == 1:
        assert stats_k["rounds"] > 1
