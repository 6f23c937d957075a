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

The port runs the rounds as one walk per ray (`pair_walk`, the kernel's
plain version on the CPU), testing each live tile by a walk of its own
subtree of `build_pair_tree`; the round-structured version stays
(`pair_rounds`). Held here:

- `build_pair_tree`'s layout: tile t's rows are leaves 64 t ... 64 t + 63
  under node n_leaves / 64 + t, the rows the tiles' table, each row
  reporting its sorted index, the padding and sentinel rows -1, every box
  holding its faces' centred vertices with the pad; `build_face_bvh`'s
  default path unchanged (K1 big's tree hashed as it was built before the
  flag that keeps the order);
- the pad certificate of the tile subtrees for the bilinear arithmetic on
  interior, surface, grazing, axis-aligned and vertex/edge rays: every
  ancestor of the leaf holding the dense hit (its tile's subtree root
  among them) is entered no later than the dense t;
- the walk against the round-structured version and the reference: t,
  faces, rounds, live pairs and rays unresolved after the first round
  identical to `pair_rounds`, faces identical to the reference's
  interpret-mode op (t within the tolerance above).
"""

import hashlib

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
from test_torch_cuda import _with_sentinels, ray_set
from test_torch_first_hit_accel import tree_certificate
from tests.test_torch_sorted_first_hit import _assert_close, _case, _degenerate_mesh, _dense_sorted, _port, _wavefront

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
    t_d, i_d = ck.ray_first_hit_plain(torch.from_numpy(o), torch.from_numpy(d), st, ck.big_first_hit_table(st))
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


@pytest.mark.parametrize("mesh", ["scanned", "degenerate faces", "box"])
def test_build_pair_tree(room, mesh):
    """The tiles' rows in their own order: tile t's 256 rows are leaves
    64 t ... 64 t + 63 under node n_leaves / 64 + t."""
    if mesh == "box":
        tris = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25]).triangles.astype(np.float32)
    else:
        tris = room.triangles.astype(np.float32) if mesh == "scanned" else _degenerate_mesh(room)
    tiles, order = tsorted.build_sorted_tiles(tris, device="cpu")
    tree = tiles.pair_tree
    n_rows = tiles.n_tiles * tsorted.TILE_FACES
    pow2 = 1 << int(np.ceil(np.log2(tiles.n_tiles)))
    assert tree.leaf_faces == ck.BVH_LEAF_FACES and tree.n_leaves == ck.TILE_LEAVES * pow2
    # The rows are the table's, in place; each reports its sorted index, the
    # zero padding rows and everything past the tiles -1
    rows = tree.rows.numpy()
    np.testing.assert_array_equal(rows[:n_rows].view(np.int32), tiles.face_tab.numpy().view(np.int32))
    assert not rows[n_rows:].any()
    face = tree.face.numpy()
    np.testing.assert_array_equal(face[: tiles.n_faces], np.arange(tiles.n_faces))
    assert (face[tiles.n_faces :] == -1).all()
    assert torch.equal(tree.face[:n_rows] >= 0, ck.big_keep(tiles.face_tab))
    # Boxes: each parent holds its children; each leaf its rows' centred
    # vertices with the pad; leaves without a face empty
    lo, hi = tree.boxes[:, 0:3].double().numpy(), tree.boxes[:, 4:7].double().numpy()
    kids = np.arange(2, 2 * tree.n_leaves)
    assert (lo[kids // 2] <= lo[kids]).all() and (hi[kids // 2] >= hi[kids]).all()
    verts = tris[order].astype(np.float64) - tiles.center.double().numpy()
    leaf = tree.n_leaves + np.arange(tiles.n_faces) // tree.leaf_faces
    assert (lo[leaf][:, None] <= verts - ck.BVH_PAD).all() and (hi[leaf][:, None] >= verts + ck.BVH_PAD).all()
    empty = tree.n_leaves + np.flatnonzero((face.reshape(-1, tree.leaf_faces) < 0).all(axis=1))
    assert (lo[empty] == np.inf).all() and (hi[empty] == -np.inf).all()
    # Tile t's subtree: node pow2 + t holds exactly its 64 leaves, and its
    # box the tile's faces (within the tile's tight box, padded)
    for t in range(tiles.n_tiles):
        node = np.arange(pow2 + t, pow2 + t + 1)
        while node[0] < tree.n_leaves:
            node = np.concatenate([2 * node, 2 * node + 1])
        np.testing.assert_array_equal(np.sort(node), tree.n_leaves + ck.TILE_LEAVES * t + np.arange(ck.TILE_LEAVES))
        tl, th = tiles.tile_lo[t].double().numpy(), tiles.tile_hi[t].double().numpy()
        assert (lo[pow2 + t] >= tl - ck.BVH_PAD - 1e-5).all() and (lo[pow2 + t] <= tl - ck.BVH_PAD).all()
        assert (hi[pow2 + t] <= th + ck.BVH_PAD + 1e-5).all() and (hi[pow2 + t] >= th + ck.BVH_PAD).all()


# K1 big's tree (`build_face_bvh`'s default path) of the room and of the room
# with 1e9 sentinels, rows, faces and boxes hashed as they were built before
# the in-order flag
DEFAULT_TREE_SHA256 = {
    "room": "05152e3fbdda060c9fe88052c19999d36746aad22acbb287937d5144b1c7a41d",
    "room_sentinels": "9b646cdf7de1568d3b1b2bab419fe7700ce77f61b321e7b99e9ea03ff923c22e",
}


@pytest.mark.parametrize("which", sorted(DEFAULT_TREE_SHA256))
def test_face_tree_default_path_unchanged(room, which):
    tris = room.triangles.astype(np.float32)
    tris = _with_sentinels(tris, 3) if which == "room_sentinels" else tris
    _, _, _, bvh = ck.big_first_hit_table(torch.from_numpy(tris))
    h = hashlib.sha256()
    for x in (bvh.rows, bvh.face, bvh.boxes):
        h.update(x.contiguous().numpy().tobytes())
    assert h.hexdigest() == DEFAULT_TREE_SHA256[which]


@pytest.mark.parametrize("kind", ["interior", "surface", "grazing", "axis", "vertex_edge"])
def test_pair_tree_certificate(kind):
    """On a 6,912-face room (7 x 5 x 3 m, the face-tree tests' rays): every
    ancestor of the leaf holding the dense hit over the sorted faces, up to
    the root and so through its tile's subtree root, is entered no later
    than the dense t; the walk equals that dense hit bit for bit."""
    tris = scanned_like_room(subdivision_levels=3).triangles.astype(np.float32)
    o, d = ray_set(kind, tris, seed=len(kind) + 11)
    tiles, order = tsorted.build_sorted_tiles(tris, device="cpu")
    t_d, i_d = _dense_sorted(tris, order, tiles, o, d, None)
    held, slack = tree_certificate(tiles.pair_tree, torch.from_numpy(o) - tiles.center, torch.from_numpy(d),
                                   t_d.numpy(), i_d.numpy())
    t_w, i_w, stats = tpair.pair_walk(tiles, *_port(o, d, None))
    counts = stats["counts"]
    print(f"{kind}: {int((i_d >= 0).sum())} hits of {len(o)} rays, smallest t* - ancestor entry {slack:.3e}; per ray "
          f"{float(counts[:, 1].double().mean()):.2f} tiles, {float(counts[:, 2].double().mean()):.1f} box tests, "
          f"{float(counts[:, 3].double().mean()):.2f} leaves; {stats['rounds']} rounds")
    assert held.all() and int((i_d >= 0).sum()) > 0.3 * len(o)
    assert torch.equal(i_w, i_d) and torch.equal(t_w.view(torch.int32), t_d.view(torch.int32))


@pytest.mark.parametrize("kind,k", CASES)
def test_pair_walk_matches_rounds_and_reference(room, kind, k):
    """The walk against the round-structured version (t, faces and every
    count identical) and the reference's interpret-mode op (faces
    identical, t within rtol 1e-4 / atol 3e-5 m)."""
    tris, o, d, alive = _pair_case(kind, room)
    tiles, _ = tsorted.build_sorted_tiles(tris, device="cpu")
    jt, _ = jsorted.build_sorted_tiles(tris)
    t_w, i_w, st_w = tpair.pair_walk(tiles, *_port(o, d, alive), k_slots=k)
    t_r, i_r, st_r = tpair.pair_rounds(tiles, *_port(o, d, alive), k_slots=k)
    assert torch.equal(i_w, i_r) and torch.equal(t_w, t_r)
    for key in ("rounds", "pairs", "unresolved_first", "needed"):
        assert int(st_w[key]) == int(st_r[key]), key
    t_j, i_j = jpair.pair_first_hit(jt, jnp.asarray(o), jnp.asarray(d),
                                    alive=None if alive is None else jnp.asarray(alive), k_slots=k, interpret=True)
    np.testing.assert_array_equal(i_w.numpy(), np.asarray(i_j))
    _assert_close(t_w.numpy(), np.asarray(t_j))
    counts = st_w["counts"]
    dead = np.zeros(len(o), bool) if alive is None else ~alive
    assert (counts[torch.from_numpy(dead)] == torch.tensor([1, 0, 0, 0], dtype=torch.int32)).all()
    print(f"{kind}: {st_w['rounds']} rounds, {int(st_w['pairs'])} pairs, {int(counts[:, 2].sum())} box tests, "
          f"{int(counts[:, 3].sum())} leaves")
    if kind == "k_slots=1":
        assert st_w["rounds"] > 1
    if kind == "all dead":
        assert st_w["rounds"] == 1 and int(st_w["pairs"]) == 0
