"""The port's cone-sorted first hit (K9) against the JAX package.

Cases and sizes are those of tests/test_sorted_first_hit.py: a box room's
interior (one block and 37 rays over), surface-origin wavefronts of the
`scanned_like_room(subdivision_levels=3)` room (6,912 faces, 27 tiles),
dead lanes with a ragged last block, escaping rays, and all rays dead.

- `build_sorted_tiles`: both builds are numpy, so every field and `order`
  are bit-equal, also on a mesh with zero-area and sentinel (1e9) faces;
  both return None without a valid face.
- The glue: the sort keys equal the reference's except where the two atan2
  differ in the last bit (counted); the block bounds, tile order and counts
  equal the reference's on the same ray order.
- The kernel body: the plain walk against `_sfh_call(interpret=True)` on
  identical inputs, and the whole op against the reference's in interpret
  mode. Faces identical; t within rtol 1e-4 and atol 3e-5 m: XLA:CPU
  contracts multiply-adds in the interpret-mode body and the port never
  does, and the contracted rounding of k - o.n (terms of the room's size,
  ~1e-7 m) divided by a grazing d.n moves t by an absolute amount, at most
  2.3e-5 m on these rays (a surface ray of the k_slots=1 case), which is
  up to 2.2e-3 of t where a ray hits a face a few mm away or less. The
  rays beyond rtol 1e-4 and the largest gap are printed.
- The op against the port's dense big first hit (plain) over the sorted
  faces, bit for bit: both build the same table, and the walk's bounds are
  conservative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.mesh import box_mesh, scanned_like_room
from audiblelight_tpu.ops import sorted_first_hit as jsorted
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.ops import sorted_first_hit as tsorted

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def room():
    return scanned_like_room(extents=(5.0, 4.0, 2.7), seed=3, subdivision_levels=3)


def _wavefront(rng, mesh, n):
    """Surface-origin rays: points 1e-4 off random faces, random directions
    (tests/test_sorted_first_hit.py's recipe)."""
    tris = mesh.triangles.astype(np.float32)
    fi = rng.integers(0, len(tris), n)
    w = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    pts = np.einsum("nk,nkd->nd", w, tris[fi])
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (pts + 1e-4 * nrm[fi]).astype(np.float32), d


def _case(kind, room):
    """(tris, origins, dirs, alive or None) of one of the reference's cases."""
    if kind == "box interior":
        rng = np.random.default_rng(0)
        mesh = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25])
        o = rng.uniform(0.3, 1.8, (tsorted.SFH_LANES + 37, 3)).astype(np.float32)
        d = rng.standard_normal((len(o), 3)).astype(np.float32)
        return mesh.triangles.astype(np.float32), o, d / np.linalg.norm(d, axis=1, keepdims=True), None
    tris = room.triangles.astype(np.float32)
    if kind == "scanned wavefront":
        return (tris, *_wavefront(np.random.default_rng(1), room, 700), None)
    if kind == "dead lanes":
        rng = np.random.default_rng(2)
        o, d = _wavefront(rng, room, 300)
        return tris, o, d, rng.uniform(size=300) < 0.6
    if kind == "all dead":
        o, d = _wavefront(np.random.default_rng(5), room, 64)
        return tris, o, d, np.zeros(64, bool)
    raise ValueError(kind)


CASES = ["box interior", "scanned wavefront", "dead lanes", "all dead"]


def _port(o, d, alive):
    return torch.from_numpy(o), torch.from_numpy(d), None if alive is None else torch.from_numpy(alive)


def _assert_close(t_p, t_j):
    """Misses agree; finite t within rtol 1e-4, atol 3e-5 m (module docstring)."""
    np.testing.assert_array_equal(np.isfinite(t_p), np.isfinite(t_j))
    fin = np.isfinite(t_j)
    gap = np.abs(t_p[fin] - t_j[fin])
    rel = gap / np.abs(t_j[fin])
    print(f"t: {int((rel > 1e-4).sum())} of {int(fin.sum())} rays beyond 1e-4 relative, at most {rel.max(initial=0):.2e}; "
          f"largest gap {gap.max(initial=0):.3e} m")
    np.testing.assert_allclose(t_p[fin], t_j[fin], rtol=1e-4, atol=3e-5)


def _degenerate_mesh(room):
    """The room with zero-area faces and sentinel faces at 1e9 mixed in."""
    tris = room.triangles.astype(np.float32).copy()
    rng = np.random.default_rng(7)
    flat = tris[rng.integers(0, len(tris), 40)].copy()
    flat[:, 2] = flat[:, 1]  # zero area
    sentinel = np.full((30, 3, 3), 1.0e9, np.float32)
    out = np.concatenate([tris, flat, sentinel])
    return out[rng.permutation(len(out))]


@pytest.mark.parametrize("mesh", ["scanned", "degenerate faces"])
def test_build_sorted_tiles_matches_reference(room, mesh):
    tris = room.triangles.astype(np.float32) if mesh == "scanned" else _degenerate_mesh(room)
    want, want_order = jsorted.build_sorted_tiles(tris)
    got, order = tsorted.build_sorted_tiles(tris, device="cpu")
    np.testing.assert_array_equal(order, want_order)
    assert (got.n_tiles, got.n_faces) == (want.n_tiles, want.n_faces) == (27, 6912)
    for name in ("face_tab", "tile_lo", "tile_hi", "center", "room_lo", "room_span"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    # The reference's build carried over as numpy is the same state
    carried = tsorted.sorted_tiles_from_numpy(
        {k: np.asarray(v) for k, v in want._asdict().items()}, "cpu")
    assert (carried.n_tiles, carried.n_faces) == (got.n_tiles, got.n_faces)
    for name in ("face_tab", "tile_lo", "tile_hi", "center", "room_lo", "room_span"):
        assert torch.equal(getattr(carried, name), getattr(got, name)), name
    # The dense big first hit's own table over the sentinel-padded sorted
    # faces is the tiles' table: the bit-for-bit checks below rest on it
    centre, tab = ck.big_face_table(torch.from_numpy(tsorted.padded_sorted_tris(tris, order, got.n_tiles)))
    assert torch.equal(centre, got.center) and torch.equal(tab, got.face_tab)


def test_build_sorted_tiles_none_without_faces():
    empty = np.full((4, 3, 3), 1.0e9, np.float32)
    want, want_order = jsorted.build_sorted_tiles(empty)
    got, order = tsorted.build_sorted_tiles(empty, device="cpu")
    assert want is None and got is None and len(order) == len(want_order) == 0


def test_sort_keys_match_reference(room):
    """Equal keys, except where the two atan2 differ in the last bit and the
    azimuth sits on a bin edge; those rays are counted."""
    tris = room.triangles.astype(np.float32)
    rng = np.random.default_rng(3)
    o, d = _wavefront(rng, room, 4000)
    alive = rng.uniform(size=4000) < 0.8
    tiles, _ = tsorted.build_sorted_tiles(tris, device="cpu")
    jt, _ = jsorted.build_sorted_tiles(tris)
    o_c = torch.from_numpy(o) - tiles.center
    got = tsorted._sort_keys(o_c, torch.from_numpy(d), torch.from_numpy(alive), tiles).numpy()
    want = np.asarray(jsorted._sort_keys(jnp.asarray(o_c.numpy()), jnp.asarray(d), jnp.asarray(alive), jt))
    az_t = torch.atan2(torch.from_numpy(d[:, 1]), torch.from_numpy(d[:, 0])).numpy()
    az_j = np.asarray(jnp.arctan2(jnp.asarray(d[:, 1]), jnp.asarray(d[:, 0])))
    differ = got != want
    print(f"{int(differ.sum())} of 4000 keys differ; atan2 differs on {int((az_t != az_j).sum())} rays")
    assert not (differ & (az_t == az_j)).any()
    assert differ.sum() <= 2
    assert (want[~alive] == 512).all() and (got[~alive] == 512).all()


@pytest.mark.parametrize("kind", ["scanned wavefront", "dead lanes"])
def test_block_bounds_match_reference(room, kind):
    """The bounds, the tile order and the counts of reachable tiles on the
    port's ray order, against the reference's functions on the same rays."""
    tris, o, d, alive = _case(kind, room)
    tiles, _ = tsorted.build_sorted_tiles(tris, device="cpu")
    jt, _ = jsorted.build_sorted_tiles(tris)
    a_t = torch.ones(len(o), dtype=torch.bool) if alive is None else torch.from_numpy(alive)
    _, o_s, d_s, live, perm, dlo, nv = tsorted.sorted_inputs(tiles, torch.from_numpy(o), torch.from_numpy(d), a_t)
    lanes = tsorted.SFH_LANES
    ob, db = jnp.asarray(o_s.numpy()).reshape(-1, lanes, 3), jnp.asarray(d_s.numpy()).reshape(-1, lanes, 3)
    lb = jnp.asarray(live.numpy()).reshape(-1, lanes).astype(bool)
    big = jnp.float32(1e30)
    omin = jnp.min(jnp.where(lb[..., None], ob, big), axis=1)
    omax = jnp.max(jnp.where(lb[..., None], ob, -big), axis=1)
    dmin = jnp.min(jnp.where(lb[..., None], db, big), axis=1)
    dmax = jnp.max(jnp.where(lb[..., None], db, -big), axis=1)
    want = jsorted._block_tile_bounds(omin, omax, dmin, dmax, jt.tile_lo, jt.tile_hi)
    want = jnp.where(jnp.any(lb, axis=1)[:, None], want, jnp.inf)
    want_perm = jnp.argsort(want, axis=1)
    want_sorted = np.asarray(jnp.take_along_axis(want, want_perm, axis=1))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    np.testing.assert_array_equal(nv.numpy(), np.isfinite(want_sorted).sum(axis=1))
    np.testing.assert_array_equal(dlo.numpy(), np.where(np.isfinite(want_sorted), want_sorted, 3.0e38))
    assert (nv.numpy() > 0).all()


@pytest.mark.parametrize("kind", ["scanned wavefront", "dead lanes"])
def test_kernel_body_matches_interpret(room, kind):
    """`sorted_walk_plain` against the Pallas body in interpret mode on the
    same sorted rays, tile orders and bounds."""
    tris, o, d, alive = _case(kind, room)
    tiles, _ = tsorted.build_sorted_tiles(tris, device="cpu")
    a_t = torch.ones(len(o), dtype=torch.bool) if alive is None else torch.from_numpy(alive)
    _, o_s, d_s, live, perm, dlo, nv = tsorted.sorted_inputs(tiles, torch.from_numpy(o), torch.from_numpy(d), a_t)
    t_p, i_p, _ = ck.sorted_walk_plain(o_s, d_s, live, perm, dlo, nv, tiles.face_tab)
    nb = perm.shape[0]
    pad = -nb % 8  # the Pallas grid reads its tables in groups of 8 blocks
    perm_j = np.pad(perm.numpy(), ((0, pad), (0, 0)))
    dlo_j = np.pad(dlo.numpy(), ((0, pad), (0, 0)))
    nv_j = np.pad(nv.numpy(), (0, pad))[:, None]
    t_j, i_j = jsorted._sfh_call(jnp.asarray(tiles.face_tab.numpy()), tiles.n_tiles, jnp.asarray(o_s.numpy()),
                                 jnp.asarray(d_s.numpy()), jnp.asarray(live.numpy()), jnp.asarray(perm_j),
                                 jnp.asarray(dlo_j), jnp.asarray(nv_j), interpret=True)
    t_j, i_j = np.asarray(t_j).reshape(-1), np.asarray(i_j).reshape(-1)
    np.testing.assert_array_equal(i_p.numpy(), i_j)
    hit = i_j >= 0
    _assert_close(t_p.numpy()[hit], t_j[hit])
    np.testing.assert_array_equal(t_p.numpy()[~hit], t_j[~hit])  # 3e38 on a miss, 0 on a dead lane


@pytest.mark.parametrize("kind", CASES)
def test_sorted_first_hit_matches_reference(room, kind):
    tris, o, d, alive = _case(kind, room)
    tiles, order = tsorted.build_sorted_tiles(tris, device="cpu")
    jt, _ = jsorted.build_sorted_tiles(tris)
    t_p, i_p = tsorted.sorted_first_hit(tiles, *_port(o, d, alive))
    t_j, i_j = jsorted.sorted_first_hit(jt, jnp.asarray(o), jnp.asarray(d),
                                        alive=None if alive is None else jnp.asarray(alive), interpret=True)
    t_p, i_p, t_j, i_j = t_p.numpy(), i_p.numpy(), np.asarray(t_j), np.asarray(i_j)
    np.testing.assert_array_equal(i_p, i_j)
    _assert_close(t_p, t_j)
    if alive is not None:
        assert np.isinf(t_p[~alive]).all() and (i_p[~alive] == -1).all()
    if kind != "all dead":
        live = np.ones(len(o), bool) if alive is None else alive
        assert np.isfinite(t_p[live]).mean() > 0.9


@pytest.mark.parametrize("kind", CASES)
def test_sorted_first_hit_equals_dense_big(room, kind):
    """Bit for bit the dense big first hit over the sorted faces; an
    all-dead wavefront visits no tile."""
    tris, o, d, alive = _case(kind, room)
    tiles, order = tsorted.build_sorted_tiles(tris, device="cpu")
    t_p, i_p, visited = tsorted.sorted_walk(tiles, *_port(o, d, alive))
    st = torch.from_numpy(tsorted.padded_sorted_tris(tris, order, tiles.n_tiles))
    # The big variant at any face count (the box's one tile would take the small one)
    t_d, i_d = ck.ray_first_hit_plain(torch.from_numpy(o), torch.from_numpy(d), st, ck.big_first_hit_table(st))
    if alive is not None:
        dead = torch.from_numpy(~alive)
        t_d, i_d = torch.where(dead, torch.inf, t_d), torch.where(dead, -1, i_d)
    assert torch.equal(i_p, i_d) and torch.equal(t_p, t_d)
    print(f"{kind}: {int(visited.sum())} of {visited.numel() * tiles.n_tiles} (block, tile) pairs visited")
    if kind == "all dead":
        assert int(visited.sum()) == 0


def test_escaping_rays():
    """Outside the box pointing away: (inf, -1); inside pointing up: the
    ceiling at t = 1."""
    mesh = box_mesh(extents=[2.0, 2.0, 2.0], center=[1.0, 1.0, 1.0])
    tiles, _ = tsorted.build_sorted_tiles(mesh.triangles.astype(np.float32), device="cpu")
    o = torch.tensor([[5.0, 5.0, 5.0], [1.0, 1.0, 1.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t, idx = tsorted.sorted_first_hit(tiles, o, d)
    assert np.isinf(float(t[0])) and int(idx[0]) == -1
    assert int(idx[1]) >= 0 and abs(float(t[1]) - 1.0) <= 1e-5
