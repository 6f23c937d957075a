"""The port's pair-walk first hit (K10) against the JAX package.

Cases and sizes are those of tests/test_pair_first_hit.py on the tiles of
`build_sorted_tiles` (tests/test_torch_sorted_first_hit.py holds the build
bit-equal): a box room's interior with k_slots=2, a surface-origin wavefront
of the `scanned_like_room(subdivision_levels=3)` room (27 tiles) with
k_slots=4, k_slots=1 forcing many rounds, dead lanes, escaping rays, and all
rays dead.

- The slab entries of every (ray, tile) pair equal the reference's bit for
  bit.
- The kernel body: the plain round (`pair_tile_plain`) against
  `_pair_call(interpret=True)` on the same tile-aligned lanes, and the
  port's round against the reference's `_one_round` in interpret mode on the
  same candidates; the whole op against the reference's in interpret mode.
  Faces identical; t within rtol 1e-4 and atol 3e-5 m, for the reason
  tests/test_torch_sorted_first_hit.py gives (XLA:CPU's contracted
  multiply-adds in k - o.n, divided by a grazing d.n).
- The op against the port's dense big first hit (plain) over the sorted
  faces, bit for bit, with the rounds counted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.mesh import box_mesh, scanned_like_room
from audiblelight_tpu.ops import pair_first_hit as jpair
from audiblelight_tpu.ops import sorted_first_hit as jsorted
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.ops import pair_first_hit as tpair
from audiblelight_tpu_torch.ops import sorted_first_hit as tsorted
from tests.test_torch_sorted_first_hit import _assert_close, _case, _port, _wavefront

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def room():
    return scanned_like_room(extents=(5.0, 4.0, 2.7), seed=3, subdivision_levels=3)


# (case, k_slots) of the reference's tests
CASES = [("box interior", 2), ("scanned wavefront", 4), ("k_slots=1", 1), ("dead lanes", 8), ("all dead", 8)]


def _pair_case(kind, room):
    if kind == "k_slots=1":
        return (room.triangles.astype(np.float32), *_wavefront(np.random.default_rng(2), room, 256), None)
    return _case(kind, room)


def test_tile_entries_match_reference(room):
    tris, o, d, _ = _case("scanned wavefront", room)
    tiles, _ = tsorted.build_sorted_tiles(tris, device="cpu")
    jt, _ = jsorted.build_sorted_tiles(tris)
    o_c = torch.from_numpy(o) - tiles.center
    got = tpair._tile_entries(tiles, o_c, torch.from_numpy(d)).numpy()
    want = np.asarray(jpair._tile_entries(jt, jnp.asarray(o_c.numpy()), jnp.asarray(d)))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).any() and not np.isfinite(got).all()


def _first_round(room, kind, k):
    """The tiles, centred rays and first-round candidates of one case."""
    tris, o, d, alive = _pair_case(kind, room)
    tiles, _ = tsorted.build_sorted_tiles(tris, device="cpu")
    o_c, d_t = torch.from_numpy(o) - tiles.center, torch.from_numpy(d)
    enter = tpair._tile_entries(tiles, o_c, d_t)
    if alive is not None:
        enter = torch.where(torch.from_numpy(alive)[:, None], enter, torch.inf)
    cand_enter, cand = torch.sort(enter, dim=1, stable=True)
    cand_enter, cand = cand_enter[:, :k], cand[:, :k]
    return tris, tiles, o_c, d_t, cand, torch.isfinite(cand_enter)


@pytest.mark.parametrize("kind,k", [("scanned wavefront", 4), ("dead lanes", 8)])
def test_kernel_body_matches_interpret(room, kind, k):
    """One round's lanes through `pair_tile_plain` and the Pallas body."""
    _, tiles, o_c, d_t, cand, live = _first_round(room, kind, k)
    o_s, d_s, blk_tile, _, _ = tpair.round_inputs(tiles.n_tiles, o_c, d_t, cand, live)
    t_p, i_p = ck.pair_tile_plain(o_s, d_s, blk_tile, tiles.face_tab)
    nb = blk_tile.shape[0]
    pad = -nb % 8  # the Pallas grid reads its tile ids in groups of 8 blocks
    lanes = ck.PFH_LANES
    o_j = np.pad(o_s.numpy(), ((0, pad * lanes), (0, 0)))
    d_j = np.pad(d_s.numpy(), ((0, pad * lanes), (0, 0)))
    tid = np.pad(blk_tile.numpy(), (0, pad), constant_values=-1)[:, None]
    t_j, i_j = jpair._pair_call(jnp.asarray(tiles.face_tab.numpy()), jnp.asarray(o_j), jnp.asarray(d_j),
                                jnp.asarray(tid), interpret=True)
    t_j, i_j = np.asarray(t_j).reshape(-1)[: nb * lanes], np.asarray(i_j).reshape(-1)[: nb * lanes]
    np.testing.assert_array_equal(i_p.numpy(), i_j)
    hit = i_j >= 0
    assert hit.any() and (blk_tile.numpy() < 0).any()
    _assert_close(t_p.numpy()[hit], t_j[hit])
    np.testing.assert_array_equal(t_p.numpy()[~hit], t_j[~hit])  # 3e38


@pytest.mark.parametrize("kind,k", [("scanned wavefront", 4)])
def test_round_matches_reference(room, kind, k):
    """The port's round against the reference's `_one_round` on the same
    candidates: each ray's best (t, face) over its K tiles."""
    tris, tiles, o_c, d_t, cand, live = _first_round(room, kind, k)
    jt, _ = jsorted.build_sorted_tiles(tris)
    t_p, i_p = tpair._one_round(ck.pair_tile_plain, tiles, o_c, d_t, cand, live)
    t_j, i_j = jpair._one_round(jt, jnp.asarray(o_c.numpy()), jnp.asarray(d_t.numpy()),
                                jnp.asarray(cand.numpy().astype(np.int32)), jnp.asarray(live.numpy()), True)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    _assert_close(t_p.numpy(), np.asarray(t_j))


@pytest.mark.parametrize("kind,k", CASES)
def test_pair_first_hit_matches_reference(room, kind, k):
    tris, o, d, alive = _pair_case(kind, room)
    tiles, _ = tsorted.build_sorted_tiles(tris, device="cpu")
    jt, _ = jsorted.build_sorted_tiles(tris)
    t_p, i_p = tpair.pair_first_hit(tiles, *_port(o, d, alive), k_slots=k)
    t_j, i_j = jpair.pair_first_hit(jt, jnp.asarray(o), jnp.asarray(d),
                                    alive=None if alive is None else jnp.asarray(alive), k_slots=k, interpret=True)
    t_p, i_p, t_j, i_j = t_p.numpy(), i_p.numpy(), np.asarray(t_j), np.asarray(i_j)
    np.testing.assert_array_equal(i_p, i_j)
    _assert_close(t_p, t_j)
    if alive is not None:
        assert np.isinf(t_p[~alive]).all() and (i_p[~alive] == -1).all()


@pytest.mark.parametrize("kind,k", CASES)
def test_pair_first_hit_equals_dense_big(room, kind, k):
    """Bit for bit the dense big first hit over the sorted faces; k_slots=1
    takes several rounds, an all-dead wavefront tests no pair."""
    tris, o, d, alive = _pair_case(kind, room)
    tiles, order = tsorted.build_sorted_tiles(tris, device="cpu")
    t_p, i_p, stats = tpair.pair_walk(tiles, *_port(o, d, alive), k_slots=k)
    st = torch.from_numpy(tsorted.padded_sorted_tris(tris, order, tiles.n_tiles))
    # The big variant at any face count (the box's one tile would take the small one)
    t_d, i_d = ck.ray_first_hit_plain(torch.from_numpy(o), torch.from_numpy(d), st, ("big", *ck.big_face_table(st)))
    if alive is not None:
        dead = torch.from_numpy(~alive)
        t_d, i_d = torch.where(dead, torch.inf, t_d), torch.where(dead, -1, i_d)
    assert torch.equal(i_p, i_d) and torch.equal(t_p, t_d)
    print(f"{kind}: {stats['rounds']} rounds, {int(stats['pairs'])} (ray, tile) pairs tested, "
          f"{int(stats['needed'])} entered before the hit, {int(stats['unresolved_first'])} rays after round 1")
    assert int(stats["pairs"]) >= int(stats["needed"])
    if kind == "k_slots=1":
        assert stats["rounds"] > 1
    if kind == "all dead":
        assert stats["rounds"] == 1 and int(stats["pairs"]) == 0


def test_escaping_rays():
    mesh = box_mesh(extents=[2.0, 2.0, 2.0], center=[1.0, 1.0, 1.0])
    tiles, _ = tsorted.build_sorted_tiles(mesh.triangles.astype(np.float32), device="cpu")
    o = torch.tensor([[5.0, 5.0, 5.0], [1.0, 1.0, 1.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t, idx = tpair.pair_first_hit(tiles, o, d)
    assert np.isinf(float(t[0])) and int(idx[0]) == -1
    assert int(idx[1]) >= 0 and abs(float(t[1]) - 1.0) <= 1e-5
