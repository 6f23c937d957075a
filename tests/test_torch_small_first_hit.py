"""K1 small (csrc/first_hit.cu, meshes of <= 512 faces) on the CPU.

The kernel walks the mesh's any-hit tree (`cuda_kernels.any_hit_tree`: the
classic Moller-Trumbore rows [a, e1, e2] in world coordinates, faces with a
zero edge left out, flat or non-finite faces in an always-tested list that
every ray folds first) and must return the dense classic scan's bits: the
same t to 0 ulp and the same face, the smallest index on a tie. These tests
hold, without the card:

- the split: `first_hit_table` gives the small variant the mesh's any-hit
  tree; every face the dense scan could report (both edges nonzero) lies in
  exactly one leaf or in the always-tested rows, the 1e9 sentinels in
  neither, the exactly collinear zero-area faces and the flat faces (edges
  at under ~0.57 degrees) in the always-tested rows; every row is the dense
  table's row, bit for bit;
- a cull certificate for each ray whose dense hit lies in the tree: every
  ancestor of its leaf is entered no later than the dense t (the kernel's
  slab predicate, term for term), so no node on the path to the true hit
  can be skipped; a hit in the always-tested rows is folded before the walk;
- the kernel's walk in its plain version (`first_hit_walk_plain`) equal to
  the dense scan bit for bit (t and face), on interior, surface, grazing,
  axis-aligned, vertex/edge and non-finite rays in the 432-face
  `scanned_like_room(subdivision_levels=1)` (the smoke run's small room), a
  12-face box, that room with sentinels, collinear and flat faces mixed in,
  and random soups with and without duplicated faces (every hit a tie);
- the plain walk against the Pallas kernel in interpret mode: faces
  identical, t within rtol 1e-4 (XLA:CPU contracts the interpret-mode body's
  multiply-adds into FMAs; the port does not), as tests/test_torch_kernels.py
  holds the dense scan.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.ops.pallas_kernels import ray_first_hit_pallas
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from test_torch_cuda import _dense, random_tris, ray_set, small_meshes, unit_dirs
from test_torch_first_hit_accel import off_face

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    return small_meshes()


@pytest.mark.parametrize("which", ["room", "box", "mixed", "box_sentinels"])
def test_small_table_carries_the_any_hit_split(meshes, which):
    tris = meshes[which]
    assert len(tris) <= ck.SMALL_F_MAX
    tris_t = torch.from_numpy(tris)
    variant, center, tab, tree = ck.first_hit_table(tris_t)
    assert variant == "small" and center is None and isinstance(tree, ck.AnyHitTree)
    assert torch.equal(tab.view(torch.int32), ck.mt_face_table(tris_t).view(torch.int32))
    e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    reportable = np.flatnonzero((e1 != 0).any(1) & (e2 != 0).any(1))
    face, always = tree.bvh.face.numpy(), tree.always_face.numpy()
    walked = face[face >= 0]
    # Exactly one place for each face the dense scan could report, none for the others
    np.testing.assert_array_equal(np.sort(np.concatenate([walked, always])), reportable)
    sentinel = np.flatnonzero((np.abs(tris) >= 1e8).any(axis=(1, 2)))
    assert not np.isin(sentinel, np.concatenate([walked, always])).any()
    n = np.cross(e1.astype(np.float64), e2.astype(np.float64))
    flat = (n * n).sum(1) < ck.FLAT_SIN**2 * (e1.astype(np.float64) ** 2).sum(1) * (e2.astype(np.float64) ** 2).sum(1)
    np.testing.assert_array_equal(always, np.intersect1d(reportable, np.flatnonzero(flat)))
    if which == "mixed":
        assert len(always) == 32  # the 20 collinear faces and the 12 flat ones
    # Rows bit for bit the dense table's, zero-padded
    rows = tree.bvh.rows.numpy()
    want = np.pad(tab.numpy(), ((0, 0), (0, ck.MT_ROW - 9)))
    live = face >= 0
    np.testing.assert_array_equal(rows[live].view(np.int32), want[face[live]].view(np.int32))
    assert not rows[~live].any()
    np.testing.assert_array_equal(tree.always.numpy().view(np.int32), want[always].view(np.int32))


def _certificate(tree, n_faces, o, d, t_star, f_star):
    """(held (R,) bool, smallest slack) over the rays whose dense hit face lies
    in the tree: every ancestor of its leaf entered no later than t*."""
    bvh = tree.bvh
    pos = np.full(n_faces, -1)
    live = bvh.face.numpy() >= 0
    pos[bvh.face.numpy()[live]] = np.flatnonzero(live)
    in_tree = (f_star >= 0) & (pos[np.maximum(f_star, 0)] >= 0)
    in_always = np.isin(f_star, tree.always_face.numpy())
    assert ((f_star < 0) | in_tree | in_always).all()
    held = np.ones(len(o), bool)
    if not in_tree.any():
        return held, np.inf
    o_t, d_t = torch.from_numpy(o[in_tree]), torch.from_numpy(d[in_tree])
    inv = ck.slab_inverse(d_t)
    node = torch.from_numpy(bvh.n_leaves + pos[f_star[in_tree]] // bvh.leaf_faces)
    t = torch.from_numpy(t_star[in_tree])
    ok, slack = torch.ones(len(t), dtype=torch.bool), np.inf
    while True:
        entry, exit_ = ck.slab_entry_exit(o_t, inv, bvh.boxes[node, 0:3], bvh.boxes[node, 4:7])
        ok &= (entry <= exit_) & (entry <= t)
        slack = min(slack, float((t - entry).min()))
        if int(node.max()) == 1:
            break
        node = torch.clamp_min(node // 2, 1)
    held[in_tree] = ok.numpy()
    return held, slack


KINDS = ("interior", "surface", "grazing", "axis", "vertex_edge", "nonfinite")
CASES = [(m, k) for m in ("room", "box") for k in KINDS] + [("mixed", "interior"), ("mixed", "surface"),
                                                            ("box_sentinels", "surface")]


@pytest.mark.parametrize("which,kind", CASES)
def test_small_walk_certificate_and_equality(meshes, which, kind):
    """Every ancestor of the leaf holding the dense classic hit is entered no
    later than the dense t, and K1 small's walk gives the dense bits."""
    tris = meshes[which]
    base = meshes[which.split("_")[0]] if which != "mixed" else meshes["room"]
    o, d = ray_set(kind, base, seed=zlib.crc32(f"small {which} {kind}".encode()))
    t_star, f_star = _dense(tris, o, d)
    if kind == "nonfinite":
        bad = ~np.isfinite(np.concatenate([o, d], axis=1)).all(axis=1)
        assert bad.any() and np.isinf(t_star[bad]).all() and (f_star[bad] == -1).all()
    else:  # rays from a box's corners and edges point out of it most of the time
        assert (f_star >= 0).mean() > ({"axis": 0.3, "vertex_edge": 0.2}.get(kind, 0.9) if which == "box" else 0.9)
    table = ck.first_hit_table(torch.from_numpy(tris))
    held, slack = _certificate(table[3], len(tris), o, d, t_star, f_star)
    print(f"{which} {kind}: {len(o)} rays, {(f_star >= 0).sum()} hits, smallest t* - ancestor entry {slack:.3e}, "
          f"largest dense hit off its face {off_face(tris, o, d, t_star, f_star).max():.3e} m")
    assert held.all()
    t_w, f_w, visits = ck.first_hit_walk_plain(torch.from_numpy(o), torch.from_numpy(d), table)
    np.testing.assert_array_equal(f_w.numpy(), f_star)
    np.testing.assert_array_equal(t_w.numpy().view(np.int32), t_star.view(np.int32))
    if table[3].bvh.n_leaves >= 64:
        assert float(visits[:, 1].double().mean()) < 0.25 * table[3].bvh.n_leaves


@pytest.mark.parametrize("case", ["soup", "duplicates"])
def test_small_walk_on_soups(case):
    """Random soups: 300 faces, and 200 faces twice over, where every hit
    ties and the smallest index must win."""
    tris = random_tris(300, 300) if case == "soup" else np.concatenate([random_tris(10, 200)] * 2)
    rng = np.random.default_rng(len(case))
    o = rng.uniform(-5, 5, (400, 3)).astype(np.float32)
    d = unit_dirs(rng, 400)
    t_star, f_star = _dense(tris, o, d)
    t_w, f_w, _ = ck.first_hit_walk_plain(torch.from_numpy(o), torch.from_numpy(d),
                                         ck.first_hit_table(torch.from_numpy(tris)))
    np.testing.assert_array_equal(f_w.numpy(), f_star)
    np.testing.assert_array_equal(t_w.numpy().view(np.int32), t_star.view(np.int32))
    assert (f_star >= 0).mean() > 0.2
    if case == "duplicates":
        assert (f_star[f_star >= 0] < 200).all()


@pytest.mark.parametrize("which,kind", [("room", "interior"), ("room", "surface"), ("box", "interior"),
                                        ("mixed", "interior")])
def test_small_walk_matches_pallas(meshes, which, kind):
    tris = meshes[which]
    o, d = ray_set(kind, meshes["room"] if which == "mixed" else tris, seed=13, n=256)
    t_p, i_p = map(np.asarray, ray_first_hit_pallas(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris),
                                                    interpret=True))
    t_w, i_w, _ = ck.first_hit_walk_plain(torch.from_numpy(o), torch.from_numpy(d),
                                         ck.first_hit_table(torch.from_numpy(tris)))
    t_w, i_w = t_w.numpy(), i_w.numpy()
    np.testing.assert_array_equal(i_w, i_p)
    np.testing.assert_array_equal(np.isinf(t_w), np.isinf(t_p))
    np.testing.assert_allclose(t_w, t_p, rtol=1e-4, atol=2e-5)
    print(f"{which} {kind}: largest relative gap in t {np.nanmax(np.abs(t_w - t_p) / np.abs(t_p)):.2e}")


def test_treeless_small_table_refuses_the_walk():
    """`dense_mt_table` (K7's oracle) carries no tree: its dense plain scan
    runs anywhere, the tree walk refuses it."""
    tris = torch.from_numpy(random_tris(5, 100))
    rng = np.random.default_rng(1)
    o, d = torch.from_numpy(rng.uniform(-3, 3, (32, 3)).astype(np.float32)), torch.from_numpy(unit_dirs(rng, 32))
    table = ck.dense_mt_table(tris)
    assert table[3] is None
    t, i = ck.ray_first_hit_plain(o, d, tris, table)
    t_w, i_w, _ = ck.first_hit_walk_plain(o, d, ck.first_hit_table(tris))
    assert torch.equal(t, t_w) and torch.equal(i, i_w)
    with pytest.raises(ValueError):
        ck.first_hit_walk(o, d, table)
