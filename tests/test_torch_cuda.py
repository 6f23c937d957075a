"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card. The file imports
neither JAX nor the JAX package (tests/test_torch_kernels.py holds the plain
versions against the Pallas kernels), so it also runs where only PyTorch is
installed, without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: face indices, occlusion booleans and first-hit t identical (the
kernels are built with --fmad=false, and eager PyTorch never contracts a
multiply-add); the any-hit (K2) and the star any-hit (K6) identical to
their plain tree walk, per-segment visit counts included, and to the dense
plain any-hit; deposit histograms (K3 and the FOA K4) and the
grouped histogram (K5) with the same bins and sums within 1e-5 of the peak
(their fold adds in another order than `index_add_`), K3 and K4 also
bit-identical from launch to launch; the tiled first hit (K7) and the
bilinear first hit (K8) identical to their plain walks, per-ray visit counts
included, and to their dense plain versions (the dense classic
Moller-Trumbore first hit; the dense window selection with its plane
re-evaluation); K1 small (its tree staged in shared memory) and the
cone-sorted first hit (K9) identical to their plain walks, per-ray visit
counts included, and to their dense plain versions (the dense classic
scan; the dense big first hit (K1) over the Morton-sorted faces); the
pair-walk first hit (K10) identical to its plain walk, every ray's rounds,
live pairs, box tests and leaves included, and to that dense big first hit.
"""

import numpy as np
import pytest
import torch

from audiblelight_tpu_torch.geometry.mesh import box_mesh, scanned_like_room
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
    """One bounce's deposit inputs for e sources x r rays, c capsules and b
    bands. A float `dist_max` spreads the path lengths over [0, dist_max) and
    the hits over a 5 m box; a tuple crowds the arrivals as a real bounce's
    do: path lengths drawn from it, hits 1.0-1.1 m from a rig whose capsules
    lie within 2 cm of its centre, so each source's arrivals fall in a few
    bins."""
    tr = e * r
    if isinstance(dist_max, tuple):
        centre = rng.uniform(1, 4, 3)
        u = unit_dirs(rng, tr)
        hit = (centre + u * rng.uniform(1.0, 1.1, (tr, 1))).astype(np.float32)
        normal = unit_dirs(rng, tr)
        e_refl = (rng.random((tr, b)) * 1e-3).astype(np.float32)
        dist = rng.choice(np.array(dist_max, np.float32), tr)
        occ = rng.random((c, tr)) < 0.3
        lis = (centre + rng.uniform(-0.02, 0.02, (c, 3))).astype(np.float32)
        return hit, normal, e_refl, dist, occ, lis
    hit = rng.uniform(0, 5, (tr, 3)).astype(np.float32)
    normal = rng.standard_normal((tr, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    e_refl = (rng.random((tr, b)) * 1e-3).astype(np.float32)
    dist = (rng.random(tr) * dist_max).astype(np.float32)
    occ = rng.random((c, tr)) < 0.3
    lis = rng.uniform(1, 4, (c, 3)).astype(np.float32)
    return hit, normal, e_refl, dist, occ, lis


ROOM_LO, ROOM_HI = np.array([0.05, 0.05, 0.05]), np.array([6.95, 4.95, 2.95])


def accel_meshes() -> dict:
    """The face-tree tests' meshes: a 6,912-face scanned room and its ~1,000-face LOD."""
    room = scanned_like_room(subdivision_levels=3)
    return {"room": room.triangles.astype(np.float32),
            "lod": room.simplified(target_faces=1024).triangles.astype(np.float32)}


def small_meshes() -> dict:
    """K1 small's test meshes (<= 512 faces): the 432-face
    `scanned_like_room(subdivision_levels=1)` of the smoke run's small room, a
    12-face box of the same extents, the room with 1e9 sentinels, exactly
    collinear zero-area faces and flat faces mixed in, and the box with
    sentinels."""
    room = scanned_like_room((7.0, 5.0, 3.0), subdivision_levels=1, seed=0).triangles.astype(np.float32)
    box = box_mesh(extents=[7.0, 5.0, 3.0], center=[3.5, 2.5, 1.5]).triangles.astype(np.float32)
    mixed = np.concatenate([room, np.full((24, 3, 3), 1.0e9, np.float32), _flat_faces(room, 4, n=20),
                            _nearly_flat_faces(room, 5)])
    mixed = mixed[np.random.default_rng(9).permutation(len(mixed))]
    return {"room": room, "box": box, "mixed": mixed, "box_sentinels": _with_sentinels(box, 2)}


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _normals(tris):
    return _unit(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]).astype(np.float64))


def _dense(tris, o, d):
    t, i = ck.ray_first_hit_plain(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tris))
    return t.numpy(), i.numpy()


def ray_set(kind, tris, seed, n=600):
    """(origins, dirs) float32 of one kind of ray against `tris`."""
    rng = np.random.default_rng(seed)
    if kind == "interior":
        return rng.uniform(ROOM_LO, ROOM_HI, (n, 3)).astype(np.float32), _unit(rng.standard_normal((n, 3)))
    if kind in ("surface", "on_surface"):
        o, d = ray_set("interior", tris, seed, n)
        t, f = _dense(tris, o, d)
        ok = f >= 0
        o, d, t, f = o[ok], d[ok], t[ok], f[ok]
        nrm = _normals(tris)[f]
        nrm = np.where((nrm * d).sum(1, keepdims=True) > 0, -nrm, nrm)
        hit = o + t[:, None] * d
        if kind == "surface":
            hit = hit + 1e-4 * nrm
        half = len(o) // 2
        refl = d - 2.0 * (d * nrm).sum(1, keepdims=True) * nrm
        diffuse = _unit(rng.standard_normal((len(o), 3)))
        diffuse = np.where((diffuse * nrm).sum(1, keepdims=True) < 0, -diffuse, diffuse)
        return hit.astype(np.float32), np.concatenate([refl[:half], diffuse[half:]]).astype(np.float32)
    if kind in ("grazing", "near_plane"):
        # Through a point over a random face (half of them near an edge):
        # "grazing" runs 1e-4-1e-2 m off the face's plane, 1e-6 rad from it,
        # or aims at the point on the face at 3e-3-3e-2 rad; "near_plane"
        # aims at the point on the face at 0-1e-6 rad, so the ray stays
        # within microns of the plane for metres
        f = rng.integers(0, len(tris), n)
        tri = tris[f].astype(np.float64)
        nrm = _normals(tris)[f].astype(np.float64)
        bary = rng.dirichlet([1.0, 1.0, 1.0], n)
        bary[: n // 2] = np.clip(bary[: n // 2], 1e-4, None) * np.array([1.0, 1.0, 1e-3])
        bary /= bary.sum(1, keepdims=True)
        p = (bary[:, :, None] * tri).sum(1)
        tang = rng.standard_normal((n, 3))
        tang = _unit(tang - (tang * nrm).sum(1, keepdims=True) * nrm).astype(np.float64)
        if kind == "near_plane":
            ang, lift = rng.choice([0.0, 1e-7, 1e-6, -1e-6], n), np.zeros(n)
        else:
            parallel = np.arange(n) % 2 == 0
            ang = np.where(parallel, 1e-6, rng.choice([3e-3, 1e-2, 3e-2], n))
            lift = np.where(parallel, rng.choice([1e-4, 1e-3, 1e-2], n), 0.0)
        d = _unit(np.cos(ang)[:, None] * tang - np.sin(ang)[:, None] * nrm)
        s = rng.uniform(0.05, 3.0, n)
        return (p + lift[:, None] * nrm - s[:, None] * d).astype(np.float32), d
    if kind == "axis":
        axes = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                         [1, 1, 0], [0, -1, 1], [1, 0, -1]], np.float64)
        d = _unit(axes[rng.integers(0, len(axes), n)])
        o = rng.uniform(ROOM_LO, ROOM_HI, (n, 3))
        o[: n // 3] = tris.reshape(-1, 3)[rng.integers(0, tris.shape[0] * 3, n // 3)]
        return o.astype(np.float32), d
    if kind == "vertex_edge":
        v = tris.reshape(-1, 3)
        f = rng.integers(0, len(tris), n)
        e = rng.integers(0, 3, n)
        mid = 0.5 * (tris[f, e] + tris[f, (e + 1) % 3])
        o = np.where(np.arange(n)[:, None] % 2 == 0, v[rng.integers(0, len(v), n)], mid)
        return o.astype(np.float32), _unit(rng.standard_normal((n, 3)))
    if kind == "nonfinite":
        o, d = ray_set("interior", tris, seed, n)
        rows = rng.integers(0, n, n // 2)
        cols = rng.integers(0, 6, n // 2)
        vals = rng.choice([np.nan, np.inf, -np.inf], n // 2)
        od = np.concatenate([o, d], axis=1)
        od[rows, cols] = vals
        return np.ascontiguousarray(od[:, :3]), np.ascontiguousarray(od[:, 3:])
    raise ValueError(kind)


def _with_sentinels(tris, seed):
    """`tris` with 1e9 sentinel faces interleaved (as padded_sorted_tris pads)."""
    rng = np.random.default_rng(seed)
    out = np.concatenate([tris, np.full((len(tris) // 4, 3, 3), 1.0e9, np.float32)])
    return out[rng.permutation(len(out))]


def _flat_faces(tris, seed, n=40):
    """Zero-area faces with exactly collinear edges (e2 = 2 e1 or -3 e1,
    formed in f32) over random room faces, some of them tiny."""
    rng = np.random.default_rng(seed)
    f = tris[rng.integers(0, len(tris), n)].copy()
    scale = np.where(np.arange(n) % 2 == 0, 1.0, 1e-3).astype(np.float32)[:, None]
    e1 = (f[:, 1] - f[:, 0]) * scale
    f[:, 1] = f[:, 0] + e1
    f[:, 2] = f[:, 0] + np.where(np.arange(n) % 3 == 0, np.float32(-3.0), np.float32(2.0))[:, None] * e1
    return f.astype(np.float32)


def _nearly_flat_faces(tris, seed, n=12):
    """Faces of nonzero area whose edges meet at ~1e-3 rad: flat under
    FLAT_SIN, so always tested."""
    rng = np.random.default_rng(seed)
    f = tris[rng.integers(0, len(tris), n)].astype(np.float64)
    e1 = f[:, 1] - f[:, 0]
    side = np.cross(e1, rng.standard_normal((n, 3)))
    side *= (1e-3 * np.linalg.norm(e1, axis=1) / np.linalg.norm(side, axis=1))[:, None]
    f[:, 2] = f[:, 0] + 0.5 * e1 + side
    return f.astype(np.float32)


def segment_set(kind, tris, seed, n=500):
    """(starts, ends) float32 of one kind of segment in the room of `tris`."""
    rng = np.random.default_rng(seed)
    if kind == "interior":
        return (rng.uniform(ROOM_LO, ROOM_HI, (n, 3)).astype(np.float32),
                rng.uniform(ROOM_LO, ROOM_HI, (n, 3)).astype(np.float32))
    if kind == "surface":
        # A point on a face, moved 1e-4 m toward the end's side (the rain)
        ends = rng.uniform(ROOM_LO, ROOM_HI, (n, 3))
        f = rng.integers(0, len(tris), n)
        p = np.einsum("nk,nkd->nd", rng.dirichlet([1.0, 1.0, 1.0], n), tris[f].astype(np.float64))
        nrm = _normals(tris)[f].astype(np.float64)
        nrm = np.where(((ends - p) * nrm).sum(1, keepdims=True) >= 0, nrm, -nrm)
        return (p + 1e-4 * nrm).astype(np.float32), ends.astype(np.float32)
    if kind == "zero_length":
        s = rng.uniform(ROOM_LO, ROOM_HI, (n, 3)).astype(np.float32)
        return s, s.copy()
    if kind == "nonfinite":
        s, e = segment_set("interior", tris, seed, n)
        se = np.concatenate([s, e], axis=1)
        rows = rng.integers(0, n, n // 2)
        se[rows, rng.integers(0, 6, n // 2)] = rng.choice([np.nan, np.inf, -np.inf], n // 2)
        return np.ascontiguousarray(se[:, :3]), np.ascontiguousarray(se[:, 3:])
    if kind == "vertex_edge":
        # The segment's middle is a vertex or an edge midpoint
        f = rng.integers(0, len(tris), n)
        e = rng.integers(0, 3, n)
        mid = np.where(np.arange(n)[:, None] % 2 == 0, tris[f, e],
                       0.5 * (tris[f, e] + tris[f, (e + 1) % 3])).astype(np.float64)
        d = _unit(rng.standard_normal((n, 3))).astype(np.float64)
        half = rng.uniform(0.05, 2.0, n)[:, None]
        return (mid - half * d).astype(np.float32), (mid + half * d).astype(np.float32)
    # grazing (1e-6 rad over a face, 3e-3-3e-2 rad into it) and axis-aligned rays, cut to segments
    o, d = ray_set(kind, tris, seed, n)
    length = rng.uniform(0.1, 6.0, n).astype(np.float32)[:, None]
    return o, (o + length * d).astype(np.float32)


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
    """Many long segments and few, short segments against many faces of a
    random soup: the kernel's walk equals its plain walk (booleans and
    visits) and the dense any-hit, with and without a tree passed in."""
    rng = np.random.default_rng(n_seg)
    tris = torch.from_numpy(random_tris(7, n_faces)).to(card)
    s = torch.from_numpy(rng.uniform(-5, 5, (n_seg, 3)).astype(np.float32)).to(card)
    e = s + torch.from_numpy(rng.uniform(-reach, reach, (n_seg, 3)).astype(np.float32)).to(card)
    tree = ck.any_hit_tree(tris)
    got = ck.segments_occluded(s, e, tris, tree)
    assert torch.equal(got, ck.segments_occluded_plain(s, e, tris))
    assert torch.equal(got, ck.segments_occluded(s, e, tris))
    o, d, length = ck.segment_inputs(s, e)
    visits = torch.empty((n_seg, 2), dtype=torch.int32, device=card)
    assert torch.equal(ck.any_hit(o, d, length, tree, visits), got)
    blocked, want = ck.any_hit_walk_plain(o, d, length, tree)
    assert torch.equal(blocked, got) and torch.equal(visits, want)
    assert 0 < int(got.sum()) < n_seg


# K3 and K4 at the flagship bounce (16 sources x 5,000 rays) and its
# decimation phases (2,500 and 1,250), the FOA and exact scenes' 8 sources,
# one band (scalar columns) and 5,001 bins (fewer warps a CTA); bins 0.8 m
# of path apart, so some arrivals land in the padding and past it
DEPOSIT_CASES = [(16, 5000, 4, 501), (16, 2500, 4, 501), (16, 1250, 4, 501), (8, 5000, 4, 501),
                 (16, 5000, 1, 501), (16, 1250, 4, 5001)]
CROWDED = (10.0, 30.0, 100.0)  # path lengths of a crowded bounce (`deposit_inputs`)


def _check_deposit(kernel, plain, args, kw, shape):
    """The kernel against its plain version: the same bins, sums within
    1e-5 of each histogram's peak (fp32 sums in another order), and a second
    launch bit-identical (the fold sums in a fixed order)."""
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    assert got.shape == shape
    assert torch.equal(got != 0, want != 0)
    peak = want.abs().amax(dim=-1, keepdim=True)
    assert ((got - want).abs() <= 1e-5 * peak).all()
    assert torch.equal(got, kernel(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("arrivals", ["spread", "crowded"])
@pytest.mark.parametrize("e,r,b,n_bins", DEPOSIT_CASES)
def test_deposit_histogram_matches_plain(card, e, r, b, n_bins, arrivals):
    """K3 with 4 capsules."""
    dist = CROWDED if arrivals == "crowded" else 0.8 * n_bins
    args = [torch.from_numpy(x).to(card) for x in deposit_inputs(np.random.default_rng(3 + r), e, r, 4, b, dist)]
    kw = dict(n_sources=e, n_bins=n_bins, bin_dt=0.002, c_sound=343.0)
    if n_bins > 501:  # fewer warps a CTA than at the flagship's 501 bins
        warps = [ck.deposit_histogram_shape(e * 4, 1, b, n, True)[0] for n in (n_bins, 501)]
        assert warps[0] < warps[1]
    _check_deposit(ck.deposit_histogram, ck.deposit_histogram_plain, args, kw, (e, 4, b, n_bins))


@pytest.mark.cuda
@pytest.mark.parametrize("arrivals", ["spread", "crowded"])
@pytest.mark.parametrize("e,r,b,n_bins", DEPOSIT_CASES)
def test_deposit_histogram_foa_matches_plain(card, e, r, b, n_bins, arrivals):
    """K4 at one listener point."""
    dist = CROWDED if arrivals == "crowded" else 0.8 * n_bins
    args = [torch.from_numpy(x).to(card) for x in deposit_inputs(np.random.default_rng(5 + r), e, r, 1, b, dist)]
    kw = dict(n_sources=e, n_bins=n_bins, bin_dt=0.002, c_sound=343.0)
    _check_deposit(ck.deposit_histogram_foa, ck.deposit_histogram_foa_plain, args, kw, (e, 4, b, n_bins))


@pytest.mark.cuda
@pytest.mark.parametrize("foa", [False, True], ids=["K3", "K4"])
def test_deposit_scene_axis_matches_per_scene_launches(card, foa):
    """K3 and K4 with a scene axis (listener points (3, C, 3), 3 x 8
    sources) equal three one-scene launches bit for bit, and their plain
    version as the one-scene launch does."""
    rng = np.random.default_rng(6)
    c = 1 if foa else 4
    scenes = [[torch.from_numpy(x).to(card) for x in deposit_inputs(rng, 8, 2500, c, 4, CROWDED)] for _ in range(3)]
    fn, plain = ((ck.deposit_histogram_foa, ck.deposit_histogram_foa_plain) if foa
                 else (ck.deposit_histogram, ck.deposit_histogram_plain))
    kw = dict(n_bins=501, bin_dt=0.002, c_sound=343.0)
    want = torch.cat([fn(*x, n_sources=8, **kw) for x in scenes])
    args = [torch.cat([x[i] for x in scenes]).contiguous() for i in range(4)]
    args += [torch.cat([x[4] for x in scenes], dim=1).contiguous(), torch.stack([x[5] for x in scenes])]
    assert torch.equal(fn(*args, n_sources=24, **kw), want)
    _check_deposit(fn, plain, args, dict(kw, n_sources=24), (24, 4 if foa else c, 4, 501))
    assert torch.equal(fn(*scenes[0][:5], scenes[0][5][None], n_sources=8, **kw), want[:8])


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
    tiled_tree = tfh.build_tiled_tree(tris)
    tables = mxu.build_mxu_face_tables(tris)
    stiles, sorder = sfh.build_sorted_tiles(tris.cpu().numpy(), device=card)
    stree = sfh.build_sorted_tree(stiles, tris.cpu().numpy(), sorder)
    small = ck.first_hit_table(tris[:300])
    d = torch.from_numpy(unit_dirs(rng, 64)).to(card)
    ck.reset_launch_counts()
    ck.ray_first_hit_plain(o, o, tris)
    ck.first_hit_walk_plain(o, d, small)
    ck.segments_occluded_plain(o, o + 1.0, tris)
    ck.any_hit_walk_plain(*ck.segment_inputs(o, o + 1.0), ck.any_hit_tree(tris))
    ck.deposit_histogram_plain(*args, **kw)
    ck.deposit_histogram_foa_plain(*foa, **kw)
    ck.bin_histogram_plain(bins, dep, 51)
    so.star_segments_occluded_plain(star, o, torch.zeros(3, device=card))
    tfh.tiled_walk(tiled_tree, o, d)
    mxu.mxu_first_hit_plain(tables, o, d)
    sfh.sorted_walk(stiles, stree, o, d)
    pfh.pair_rounds(stiles, o, d, k_slots=8)
    ck.pair_walk_plain(o, d, None, stiles.center, stiles.tile_lo, stiles.tile_hi, stiles.pair_tree, 8)
    assert all(v == 0 for v in ck.launch_counts.values())
    ck.ray_first_hit(o, torch.from_numpy(unit_dirs(rng, 64)).to(card), tris)
    ck.ray_first_hit(o, d, tris[:300], small)
    ck.segments_occluded(o, o + 1.0, tris)
    ck.deposit_histogram(*args, **kw)
    ck.deposit_histogram_foa(*foa, **kw)
    ck.bin_histogram(bins, dep, 51)
    so.star_segments_occluded(star, o, torch.zeros(3, device=card))
    tfh.tiled_first_hit(tiled_tree, o, d)
    mxu.mxu_first_hit(tables, o, d)
    sfh.sorted_first_hit(stiles, stree, o, d)
    # k_slots = n_tiles: one round tests every reachable tile; every round in one launch
    pfh.pair_first_hit(stiles, o, d, k_slots=stiles.n_tiles)
    assert ck.launch_counts == {"first_hit_big": 1, "first_hit_small": 1, "any_hit": 1, "deposit_histogram": 1,
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
    dense = ck.segments_occluded_plain(s_t, e_t.expand(n_seg, 3).contiguous(), torch.from_numpy(tris).to(card))
    assert torch.equal(got, dense)
    inputs = so._star_inputs(s_t, e_t)
    visits = torch.empty((n_seg, 2), dtype=torch.int32, device=card)
    assert torch.equal(ck.star_any_hit(*inputs, star.tree, visits), got)
    assert torch.equal(visits, ck.any_hit_walk_plain(*inputs, star.tree)[1])
    assert 0 < int(got.sum()) < n_seg


@pytest.mark.cuda
@pytest.mark.parametrize("r", [5000, 2500, 1250])
@pytest.mark.parametrize("k", [64, 8], ids=["hoa3", "binaural"])
def test_bin_histogram_matches_plain(card, k, r):
    """K5 at the flagship bounce shapes: 16 sources x 5,000, 2,500 and 1,250
    rays (the decimation phases), HOA3 (16 channels x 4 bands) and binaural
    (2 x 4), 501 bins, some bins negative or past the end; then the same
    rays with their bins in a few arrival bins, as real arrivals crowd."""
    rng = np.random.default_rng(k + r)
    dep = (rng.standard_normal((16, r, k)) * 1e-4).astype(np.float32)
    spread = rng.integers(-20, 520, (16, r)).astype(np.int32)
    crowded = rng.choice([3, 4, 5, 90, 500], (16, r)).astype(np.int32)
    for bins in (spread, crowded):
        b_t, d_t = torch.from_numpy(bins).to(card), torch.from_numpy(dep).to(card)
        got = ck.bin_histogram(b_t, d_t, 501)
        want = ck.bin_histogram_plain(b_t, d_t, 501)
        assert got.shape == (16, 501, k)
        assert torch.equal(got != 0, want != 0)
        assert ((got - want).abs() <= 1e-5 * want.abs() + 1e-6 * want.abs().max()).all()


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
    """K7 from interior and surface origins, one ragged block and many: the
    kernel equals its plain walk (visit counts included) and the dense
    classic Moller-Trumbore first hit, bit for bit."""
    tris = scanned_room.triangles.astype(np.float32)
    rng = np.random.default_rng(n_rays)
    if kind == "interior":
        o = torch.from_numpy(rng.uniform([0.05, 0.05, 0.05], [6.95, 4.95, 2.95], (n_rays, 3)).astype(np.float32))
        o, d = o.to(card), torch.from_numpy(unit_dirs(rng, n_rays)).to(card)
    else:
        o, d = _surface_rays(tris, card, n_rays, n_rays)
    tree = tfh.build_tiled_tree(tris, device=card)
    t_k, i_k = tfh.tiled_first_hit(tree, o, d)
    visits = torch.empty((n_rays, 2), dtype=torch.int32, device=card)
    t_v, i_v = ck.first_hit_tiled(o, d, tree, visits)
    t_p, i_p, vis_p = tfh.tiled_walk(tree, o, d)
    assert torch.equal(i_k, i_p) and torch.equal(t_k, t_p) and torch.equal(i_v, i_p) and torch.equal(t_v, t_p)
    assert torch.equal(visits, vis_p)
    tt = torch.from_numpy(tris).to(card)
    t_d, i_d = ck.ray_first_hit_plain(o, d, tt, ck.dense_mt_table(tt))
    assert torch.equal(i_k, i_d) and torch.equal(t_k.view(torch.int32), t_d.view(torch.int32))
    assert float(torch.isfinite(t_k).float().mean()) > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [80000, 257])
def test_mxu_first_hit_matches_plain(card, scanned_room, n_rays):
    """K8 on the room's 4,096-face LOD, surface rays with and without their
    launch faces masked, one ragged block and many: the kernel equals its
    plain walk (visit counts included) and the dense selection with its
    plane re-evaluation, bit for bit."""
    lod = scanned_room.simplified(target_faces=4096)
    tris = lod.triangles.astype(np.float32)
    o, d = _surface_rays(tris, card, n_rays, 5)
    prev = torch.from_numpy(np.random.default_rng(5).integers(0, len(tris), n_rays).astype(np.int32)).to(card)
    tables = mxu.build_mxu_face_tables(torch.from_numpy(tris).to(card))
    for p in (None, prev):
        t_k, i_k = mxu.mxu_first_hit(tables, o, d, p)
        visits = torch.empty((n_rays, 2), dtype=torch.int32, device=card)
        ck.first_hit_mxu(o, d, p, tables.center, tables.bvh, visits)
        t_w, i_w, vis_w = mxu.mxu_walk(tables, o, d, p)
        t_p, i_p = mxu.mxu_first_hit_plain(tables, o, d, p)
        assert torch.equal(i_k, i_p) and torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
        assert torch.equal(i_w, i_p) and torch.equal(t_w.view(torch.int32), t_p.view(torch.int32))
        assert torch.equal(visits, vis_w)
    assert float((i_k >= 0).float().mean()) > 0.99


def _dense_big_sorted(tris, order, tiles, o, d, card):
    """The dense big first hit (K1) over the sentinel-padded sorted faces."""
    st = torch.from_numpy(sfh.padded_sorted_tris(tris, order, tiles.n_tiles)).to(card)
    table = ck.big_first_hit_table(st)
    assert torch.equal(table[1], tiles.center) and torch.equal(table[2], tiles.face_tab)
    return ck.ray_first_hit(o, d, st, table)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,kind,dead", [(20000, "interior", 0.0), (40000, "surface", 0.45),
                                              (300, "surface", 0.0)])
def test_sorted_first_hit_matches_plain_and_dense(card, scanned_room, n_rays, kind, dead):
    """K9 on interior and surface rays, with and without dead rays, one
    ragged block and many: one launch, equal to its plain walk (visit counts
    included) and to K1 big over the sentinel-padded sorted faces."""
    tris = scanned_room.triangles.astype(np.float32)
    rng = np.random.default_rng(n_rays)
    if kind == "interior":
        o = torch.from_numpy(rng.uniform([0.05, 0.05, 0.05], [6.95, 4.95, 2.95], (n_rays, 3)).astype(np.float32))
        o, d = o.to(card), torch.from_numpy(unit_dirs(rng, n_rays)).to(card)
    else:
        o, d = _surface_rays(tris, card, n_rays, n_rays)
    alive = torch.from_numpy(rng.uniform(size=n_rays) >= dead).to(card)
    tiles, order = sfh.build_sorted_tiles(tris, device=card)
    tree = sfh.build_sorted_tree(tiles, tris, order)
    ck.reset_launch_counts()
    t_k, i_k = sfh.sorted_first_hit(tiles, tree, o, d, alive)
    assert ck.launch_counts["first_hit_sorted"] == 1
    visits = torch.empty((n_rays, 2), dtype=torch.int32, device=card)
    t_v, i_v = ck.first_hit_sorted(o, d, alive, tiles.center, tree, visits)
    t_p, i_p, vis_p = sfh.sorted_walk(tiles, tree, o, d, alive)
    assert torch.equal(i_k, i_p) and torch.equal(t_k, t_p) and torch.equal(i_v, i_p) and torch.equal(t_v, t_p)
    assert torch.equal(visits, vis_p) and not bool(visits[~alive].any())
    t_d, i_d = _dense_big_sorted(tris, order, tiles, o, d, card)
    assert torch.equal(i_k[alive], i_d[alive]) and torch.equal(t_k[alive], t_d[alive])
    assert bool(torch.isinf(t_k[~alive]).all()) and bool((i_k[~alive] == -1).all())


SMALL_CASES = [(m, k) for m in ("room", "box") for k in ("interior", "surface", "grazing", "axis", "vertex_edge",
                                                        "nonfinite")]
SMALL_CASES += [("mixed", "interior"), ("mixed", "surface"), ("box_sentinels", "surface")]


@pytest.fixture(scope="module")
def small_rooms():
    return small_meshes()


@pytest.mark.cuda
@pytest.mark.parametrize("which,kind", SMALL_CASES)
def test_small_first_hit_matches_plain(card, small_rooms, which, kind):
    """K1 small on the rays of tests/test_torch_small_first_hit.py: its t,
    faces and per-ray visit counts equal the plain walk's, and its t and
    faces the dense classic scan's; a treeless table raises on the card."""
    tris = small_rooms[which]
    base = small_rooms["room" if which == "mixed" else which.split("_")[0]]
    o, d = ray_set(kind, base, seed=sum(map(ord, which + kind)), n=3000)
    o, d, tt = (torch.from_numpy(x).to(card) for x in (o, d, tris))
    table = ck.first_hit_table(tt)
    t_w, i_w, vis_w = ck.first_hit_walk_plain(o, d, table)
    t_d, i_d = ck.ray_first_hit_plain(o, d, tt, table)
    assert torch.equal(i_w, i_d) and torch.equal(t_w.view(torch.int32), t_d.view(torch.int32))
    t_k, i_k, vis_k = ck.first_hit_walk(o, d, table)
    assert torch.equal(i_k, i_w) and torch.equal(t_k.view(torch.int32), t_w.view(torch.int32))
    assert torch.equal(vis_k, vis_w)
    t_r, i_r = ck.ray_first_hit(o, d, tt, table)
    assert torch.equal(i_r, i_w) and torch.equal(t_r.view(torch.int32), t_w.view(torch.int32))
    with pytest.raises(ValueError):
        ck.ray_first_hit(o, d, tt, ck.dense_mt_table(tt))


@pytest.fixture(scope="module")
def chunked_room():
    """442,368 faces, 1,728 Morton tiles: more than one staging chunk of K10
    (1,024 tiles)."""
    return scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=6, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,k_slots,dead,mesh", [(20000, 8, 0.0, "room"), (40000, 8, 0.45, "room"),
                                                      (300, 1, 0.0, "room"), (3000, "n_tiles", 0.0, "room"),
                                                      (20000, 8, 0.2, "chunked")])
def test_pair_first_hit_matches_plain_and_dense(card, scanned_room, chunked_room, n_rays, k_slots, dead, mesh):
    """K10 on surface rays, with and without dead rays, k_slots = 1 forcing
    rounds, k_slots = n_tiles taking every reachable tile in one round, and
    a mesh of more tiles than one staging chunk: one launch, equal to its
    plain walk (t, faces and every ray's rounds, live pairs, box tests and
    leaves) and to K1 big over the sentinel-padded sorted faces."""
    tris = (scanned_room if mesh == "room" else chunked_room).triangles.astype(np.float32)
    rng = np.random.default_rng(n_rays + 1)
    o, d = _surface_rays(tris, card, n_rays, n_rays + 1)
    alive = torch.from_numpy(rng.uniform(size=n_rays) >= dead).to(card)
    tiles, order = sfh.build_sorted_tiles(tris, device=card)
    assert (tiles.n_tiles > 1024) == (mesh == "chunked")
    k = tiles.n_tiles if k_slots == "n_tiles" else k_slots
    ck.reset_launch_counts()
    t_k, i_k = pfh.pair_first_hit(tiles, o, d, alive, k_slots=k)
    assert ck.launch_counts["first_hit_pair"] == 1
    counts = torch.empty((n_rays, 4), dtype=torch.int32, device=card)
    t_c, i_c = ck.first_hit_pair(o, d, alive, tiles.center, tiles.tile_lo, tiles.tile_hi, tiles.pair_tree, k, counts)
    t_p, i_p, c_p = ck.pair_walk_plain(o, d, alive, tiles.center, tiles.tile_lo, tiles.tile_hi, tiles.pair_tree, k)
    assert torch.equal(i_k, i_p) and torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(i_c, i_p) and torch.equal(t_c.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(counts, c_p)
    assert bool((counts[~alive] == torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=card)).all())
    t_d, i_d = _dense_big_sorted(tris, order, tiles, o, d, card)
    assert torch.equal(i_k[alive], i_d[alive]) and torch.equal(t_k[alive], t_d[alive])
    assert bool(torch.isinf(t_k[~alive]).all()) and bool((i_k[~alive] == -1).all())
    if k_slots == 1:
        assert int(counts[:, 0].max()) > 1
    if k_slots == "n_tiles":
        assert int(counts[:, 0].max()) == 1


ACCEL_CASES = [("room", k) for k in ("interior", "surface", "on_surface", "grazing", "axis", "vertex_edge",
                                     "nonfinite", "near_plane")]
ACCEL_CASES += [("lod", k) for k in ("interior", "surface", "grazing", "axis")] + [("room_sentinels", "surface")]


@pytest.fixture(scope="module")
def accel_rooms():
    return accel_meshes()


@pytest.mark.cuda
@pytest.mark.parametrize("which,kind", ACCEL_CASES)
def test_first_hit_tree_matches_plain(card, accel_rooms, which, kind):
    """K1 big's tree walk against its plain walk (t, face and the per-ray
    visit counts identical) and against the dense walk (t and face
    identical; on the near-plane rays, whose dense hits can be rounding
    noise off their face, wherever the two walks' plain versions agree),
    on the rays of tests/test_torch_first_hit_accel.py."""
    base = accel_rooms["room" if which == "room_sentinels" else which]
    tris = _with_sentinels(base, 5) if which == "room_sentinels" else base
    o, d = ray_set(kind, base, seed=sum(map(ord, which + kind)))
    o, d, tt = (torch.from_numpy(x).to(card) for x in (o, d, tris))
    table = ck.first_hit_table(tt)
    t_k, i_k = ck.ray_first_hit(o, d, tt, table)
    t_w, i_w, vis_k = ck.first_hit_walk(o, d, table)
    t_p, i_p, vis_p = ck.first_hit_walk_plain(o, d, table)
    t_d, i_d = ck.ray_first_hit_plain(o, d, tt, table)
    for t, i in ((t_w, i_w), (t_p, i_p)):
        assert torch.equal(i, i_k) and torch.equal(t.view(torch.int32), t_k.view(torch.int32))
    assert torch.equal(vis_k, vis_p)
    same = (i_p == i_d) & (t_p.view(torch.int32) == t_d.view(torch.int32))
    assert bool(same.all()) or kind == "near_plane"
    assert float(same.float().mean()) > 0.95


ANY_HIT_CASES = [("room", k) for k in ("interior", "surface", "grazing", "axis", "vertex_edge", "zero_length",
                                       "nonfinite")]
ANY_HIT_CASES += [("lod", k) for k in ("interior", "surface", "grazing")]
ANY_HIT_CASES += [("mixed", k) for k in ("interior", "surface", "nonfinite")]


@pytest.mark.cuda
@pytest.mark.parametrize("which,kind", ANY_HIT_CASES)
def test_any_hit_tree_matches_plain(card, accel_rooms, which, kind):
    """K2 and K6 walk the same tree: each kernel's booleans and per-segment
    visit counts equal the plain walk's, and the booleans the dense plain
    any-hit's, on the segments of tests/test_torch_any_hit_accel.py (the
    room with 1e9 sentinels and collinear zero-area faces mixed in, whose
    rows every segment tests first, for "mixed")."""
    room = accel_rooms["room"]
    tris = (np.concatenate([_with_sentinels(room, 3), _flat_faces(room, 4)]) if which == "mixed"
            else accel_rooms[which])
    starts, ends = segment_set(kind, room if which == "mixed" else tris, seed=sum(map(ord, which + kind)))
    s, e, tt = (torch.from_numpy(x).to(card) for x in (starts, ends, tris))
    tree = ck.any_hit_tree(tt)
    o, d, length = ck.segment_inputs(s, e)
    blocked, want = ck.any_hit_walk_plain(o, d, length, tree)
    assert torch.equal(blocked, ck.segments_occluded_plain(s, e, tt))
    for kernel in (ck.any_hit, ck.star_any_hit):
        visits = torch.empty((len(starts), 2), dtype=torch.int32, device=card)
        assert torch.equal(kernel(o, d, length, tree, visits), blocked)
        assert torch.equal(visits, want)


@pytest.mark.cuda
@pytest.mark.parametrize("which,kind", [c for c in ACCEL_CASES if c[1] != "near_plane"])
def test_tiled_and_mxu_trees_match_plain(card, accel_rooms, which, kind):
    """K7 and K8 walk their own trees: each kernel's t, faces and per-ray
    visit counts equal its plain walk's, and its t and faces its dense plain
    version's, on the rays of tests/test_torch_first_hit_accel.py (K8 with a
    random half of the rays' faces masked)."""
    base = accel_rooms["room" if which == "room_sentinels" else which]
    tris = _with_sentinels(base, 5) if which == "room_sentinels" else base
    rng = np.random.default_rng(sum(map(ord, which + kind)))
    o, d = ray_set(kind, base, seed=sum(map(ord, which + kind)))
    prev = np.where(rng.uniform(size=len(o)) < 0.5, rng.integers(0, len(tris), len(o)), -1).astype(np.int32)
    o, d, prev, tt = (torch.from_numpy(x).to(card) for x in (o, d, prev, tris))
    tree = tfh.build_tiled_tree(tt)
    visits = torch.empty((len(o), 2), dtype=torch.int32, device=card)
    t_k, i_k = ck.first_hit_tiled(o, d, tree, visits)
    t_p, i_p, vis_p = tfh.tiled_walk(tree, o, d)
    t_d, i_d = ck.ray_first_hit_plain(o, d, tt, ck.dense_mt_table(tt))
    for t, i in ((t_p, i_p), (t_d, i_d)):
        assert torch.equal(i, i_k) and torch.equal(t.view(torch.int32), t_k.view(torch.int32))
    assert torch.equal(visits, vis_p)
    if tris.shape[0] > mxu.MXU_F_MAX:
        return
    tables = mxu.build_mxu_face_tables(tt)
    t_k, i_k = ck.first_hit_mxu(o, d, prev, tables.center, tables.bvh, visits)
    t_p, i_p, vis_p = mxu.mxu_walk(tables, o, d, prev)
    t_d, i_d = mxu.mxu_first_hit_plain(tables, o, d, prev)
    for t, i in ((t_p, i_p), (t_d, i_d)):
        assert torch.equal(i, i_k) and torch.equal(t.view(torch.int32), t_k.view(torch.int32))
    assert torch.equal(visits, vis_p)


@pytest.mark.cuda
def test_synced_stage_includes_the_kernels_time(card):
    """A stage with sync=True ends after the work it launched: its time is
    at least the device time of its kernels (CUDA events), where the same
    launches in an unsynced stage return after the enqueue."""
    from audiblelight_tpu_torch.profiling import Profiler

    x = torch.randn(4096, 4096, device=card)
    x @ x
    torch.cuda.synchronize()
    prof = Profiler(sync=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with prof.stage("matmul"):
        start.record()
        for _ in range(20):
            y = x @ x
        end.record()
    device_s = start.elapsed_time(end) / 1e3  # valid only once the stage has synchronised
    assert prof.stages["matmul"].total_seconds >= device_s > 0
    unsynced = Profiler(sync=False)
    with unsynced.stage("matmul"):
        for _ in range(20):
            y = x @ x
    torch.cuda.synchronize()
    assert unsynced.stages["matmul"].total_seconds < prof.stages["matmul"].total_seconds
    assert prof.block(y) is y


@pytest.mark.cuda
def test_device_memory_stats_on_the_card(card):
    from audiblelight_tpu_torch.profiling import device_memory_stats

    x = torch.empty(64 << 20, dtype=torch.uint8, device=card)
    stats = device_memory_stats()
    got = stats[str(torch.device("cuda", 0))]
    assert got["bytes_in_use"] >= x.numel() and got["peak_bytes_in_use"] >= got["bytes_in_use"]
    assert got["bytes_limit"] >= got["peak_bytes_in_use"]


@pytest.mark.cuda
@pytest.mark.parametrize("rig", ["ambeovr", "eigenmike32"])
def test_acoustic_image_card_matches_cpu(card, rig):
    """The acoustic image's device half on the card against the same
    functions on the CPU, on the same host visibilities (sh_order 10, 9
    bands, 30 frames): the normalised visibilities within 1e-5 of each
    matrix's largest entry, and each frame's APGD solve from the same warm
    start (the CPU chain's previous frame) within 1e-4 of the image's peak.
    Chained over 30 frames, float32 solves of the Eigenmike32 drift apart by
    up to 1e-2 of peak (the reference's own float32 chain is 1.4e-2 of peak
    from a float64 solve there, ROADMAP section 3), so the whole chain
    through `get_visibility_matrix` is held at 1e-4 on the AmbeoVR only."""
    from audiblelight_tpu_torch import imaging
    from audiblelight_tpu_torch.micarrays import AmbeoVR, Eigenmike32
    from audiblelight_tpu_torch.utils import polar_to_cartesian

    coords = (AmbeoVR() if rig == "ambeovr" else Eigenmike32()).coordinates_polar
    rng = np.random.default_rng(3)
    sr = 24000
    xyz = polar_to_cartesian(coords).T
    a3 = imaging.steering_operator(xyz, imaging.get_field(3))
    audio = np.real(np.outer(np.sin(2 * np.pi * 3000.0 * np.arange(3 * sr) / sr), a3[:, 10].conj()))
    audio = audio + 0.05 * rng.standard_normal(audio.shape)
    sig = imaging.band_visibilities(audio, imaging.band_frequencies(9, 1500, 4500, "linear"), sr, 50.0, 10e-3, 30)
    a = imaging.steering_operator(xyz, imaging.get_field(10))
    cpu = torch.device("cpu")
    s_c = imaging.normalised_visibilities(imaging._complex64(sig, cpu))
    s_g = imaging.normalised_visibilities(imaging._complex64(sig, card)).cpu()
    assert ((s_g - s_c).abs() <= 1e-5 * s_c.abs().amax(dim=(-2, -1), keepdim=True)).all()
    a_c = imaging._complex64(a, cpu)
    l_ = torch.tensor(2.0 * imaging.eigh_max(a, "cpu"), dtype=torch.float32)
    chain = imaging.apgd_frames(s_c, a_c, l_)  # (bands, frames, N)
    warm = torch.cat([torch.zeros_like(chain[:, :1]), chain[:, :-1]], dim=1)
    got = imaging.apgd_solve(s_c.to(card), a_c.to(card), l_.to(card), warm.to(card)).cpu()
    peak = float(chain.abs().max())
    assert got.shape == chain.shape == (9, 30, 484) and peak > 0
    assert float((got - chain).abs().max()) <= 1e-4 * peak
    if rig == "ambeovr":
        whole = imaging.get_visibility_matrix(audio, coords, device=card, sr=sr, frame_cap=30)
        want = imaging.get_visibility_matrix(audio, coords, device="cpu", sr=sr, frame_cap=30)
        assert whole.shape == want.shape == (484, 9, 30)
        assert np.abs(whole - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("n_caps", [4, 32])
def test_apgd_graph_equals_eager(card, n_caps):
    """The APGD chain replayed from one captured frame (a CUDA graph) equals
    the eager chain on the card bit for bit."""
    from audiblelight_tpu_torch import imaging

    rng = np.random.default_rng(n_caps)
    x = rng.standard_normal((9, 12, n_caps, 8)) + 1j * rng.standard_normal((9, 12, n_caps, 8))
    sig = torch.as_tensor((x @ x.conj().transpose(0, 1, 3, 2)).astype(np.complex64), device=card)
    a = torch.as_tensor(np.exp(1j * rng.uniform(0, 6.3, (n_caps, 484))).astype(np.complex64), device=card)
    l_ = torch.tensor(2.0 * imaging.eigh_max(a, card), dtype=torch.float32, device=card)
    s_norm = imaging.normalised_visibilities(sig)
    got = imaging.apgd_frames(s_norm, a, l_)
    want = imaging.apgd_frames_eager(s_norm, a, l_)
    assert got.shape == (9, 12, 484) and float(want.max()) > 0
    assert torch.equal(got, want)
