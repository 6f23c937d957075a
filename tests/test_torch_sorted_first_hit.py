"""The port's cone-sorted first hit (K9) against the JAX package and the
dense big first hit.

Cases and sizes are those of tests/test_sorted_first_hit.py: a box room's
interior (one block of the reference's 512 rays and 37 over),
surface-origin wavefronts of the `scanned_like_room(subdivision_levels=3)`
room (6,912 faces, 27 tiles), dead lanes, escaping rays, and all rays dead.

- `build_sorted_tiles`: both builds are numpy, so every field and `order`
  are bit-equal, also on a mesh with zero-area and sentinel (1e9) faces;
  both return None without a valid face.
- `build_sorted_tree`: K1 big's tree over the sentinel-padded sorted faces:
  each valid row in exactly one leaf, reporting its sorted index, the
  padding rows in none; the rows the tiles' table rows, bit for bit; each
  leaf's box holding its faces' centred vertices with the pad.
- The port's walk of that tree (`sorted_walk`, the kernel's plain version)
  against the dense big first hit over the sorted faces, bit for bit, on the
  cases above and on interior, surface, grazing, axis-aligned, vertex/edge
  and non-finite rays with a third of them dead; a cull certificate on the
  live rays: every ancestor of the leaf holding the dense hit is entered no
  later than the dense t. Dead rays report (inf, -1) and visit nothing.
- The whole op against the reference's in interpret mode: faces identical;
  t within rtol 1e-4 and atol 3e-5 m: XLA:CPU contracts multiply-adds in
  the interpret-mode body and the port never does, and the contracted
  rounding of k - o.n (terms of the room's size, ~1e-7 m) divided by a
  grazing d.n moves t by an absolute amount, at most 2.3e-5 m on these rays
  (a surface ray of the pair walk's k_slots=1 case), which is up to 2.2e-3
  of t where a ray hits a face a few mm away or less. The rays beyond rtol
  1e-4 and the largest gap are printed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.mesh import box_mesh, scanned_like_room
from audiblelight_tpu.ops import sorted_first_hit as jsorted
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.ops import sorted_first_hit as tsorted
from test_torch_cuda import ray_set
from test_torch_first_hit_accel import tree_certificate

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
        o = rng.uniform(0.3, 1.8, (512 + 37, 3)).astype(np.float32)
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


def _tree(tris, device="cpu"):
    tiles, order = tsorted.build_sorted_tiles(tris, device=device)
    return tiles, order, tsorted.build_sorted_tree(tiles, tris, order)


@pytest.mark.parametrize("mesh", ["scanned", "degenerate faces", "box"])
def test_build_sorted_tree(room, mesh):
    if mesh == "box":
        tris = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25]).triangles.astype(np.float32)
    else:
        tris = room.triangles.astype(np.float32) if mesh == "scanned" else _degenerate_mesh(room)
    tiles, order, tree = _tree(tris)
    face = tree.face.numpy()
    # Every valid sorted row once, reporting its sorted index; the padding in none
    np.testing.assert_array_equal(np.sort(face[face >= 0]), np.arange(tiles.n_faces))
    assert tree.n_leaves == 1 << int(np.ceil(np.log2(-(-tiles.n_faces // tree.leaf_faces))))
    live = face >= 0
    np.testing.assert_array_equal(tree.rows.numpy()[live].view(np.int32),
                                  tiles.face_tab.numpy()[face[live]].view(np.int32))
    assert not tree.rows.numpy()[~live].any()
    # Boxes: each parent holds its children; each leaf its faces' centred vertices with the pad
    lo, hi = tree.boxes[:, 0:3].double().numpy(), tree.boxes[:, 4:7].double().numpy()
    kids = np.arange(2, 2 * tree.n_leaves)
    assert (lo[kids // 2] <= lo[kids]).all() and (hi[kids // 2] >= hi[kids]).all()
    verts = (tris[order].astype(np.float64) - tiles.center.double().numpy())[face[live]]
    leaf = tree.n_leaves + np.flatnonzero(live) // tree.leaf_faces
    assert (lo[leaf][:, None] <= verts - ck.BVH_PAD).all() and (hi[leaf][:, None] >= verts + ck.BVH_PAD).all()


def _dense_sorted(tris, order, tiles, o, d, alive):
    """The dense big first hit (plain) over the sentinel-padded sorted faces,
    dead rays (inf, -1)."""
    st = torch.from_numpy(tsorted.padded_sorted_tris(tris, order, tiles.n_tiles))
    # The big variant at any face count (a one-tile mesh would take the small one)
    t_d, i_d = ck.ray_first_hit_plain(torch.from_numpy(o), torch.from_numpy(d), st, ck.big_first_hit_table(st))
    if alive is not None:
        dead = torch.from_numpy(~alive)
        t_d, i_d = torch.where(dead, torch.inf, t_d), torch.where(dead, -1, i_d)
    return t_d, i_d


@pytest.mark.parametrize("kind", ["interior", "surface", "grazing", "axis", "vertex_edge", "nonfinite"])
def test_sorted_walk_certificate_and_equality(kind):
    """On a 6,912-face room (7 x 5 x 3 m, the face-tree tests' rays), a third
    of the rays dead: the walk equals the dense big first hit over the sorted
    faces bit for bit, dead rays visit nothing, and every ancestor of the leaf
    holding a live ray's dense hit is entered no later than the dense t."""
    tris = scanned_like_room(subdivision_levels=3).triangles.astype(np.float32)
    o, d = ray_set(kind, tris, seed=len(kind))
    alive = np.random.default_rng(len(kind)).uniform(size=len(o)) >= 1 / 3
    tiles, order, tree = _tree(tris)
    t_w, i_w, visits = tsorted.sorted_walk(tiles, tree, *_port(o, d, alive))
    t_d, i_d = _dense_sorted(tris, order, tiles, o, d, alive)
    assert torch.equal(i_w, i_d) and torch.equal(t_w.view(torch.int32), t_d.view(torch.int32))
    assert not visits[torch.from_numpy(~alive)].any() and bool(visits[torch.from_numpy(alive), 0].all() or
                                                                  kind == "nonfinite")
    held, slack = tree_certificate(tree, torch.from_numpy(o) - tiles.center, torch.from_numpy(d), t_d.numpy(),
                                   i_d.numpy())
    live_hits = int((i_d >= 0).sum())
    print(f"{kind}: {live_hits} live hits of {len(o)} rays, smallest t* - ancestor entry {slack:.3e}, "
          f"{float(visits[torch.from_numpy(alive), 1].double().mean()):.2f} leaves per live ray of {tree.n_leaves}")
    assert held.all() and live_hits > 0.3 * len(o)


@pytest.mark.parametrize("kind", CASES)
def test_sorted_first_hit_matches_reference(room, kind):
    tris, o, d, alive = _case(kind, room)
    tiles, _, tree = _tree(tris)
    jt, _ = jsorted.build_sorted_tiles(tris)
    t_p, i_p = tsorted.sorted_first_hit(tiles, tree, *_port(o, d, alive))
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
    """Bit for bit the dense big first hit over the sorted faces, every
    ancestor of a live ray's dense hit entered no later than its t, the
    walk's visits per live ray a few leaves; an all-dead wavefront visits
    nothing."""
    tris, o, d, alive = _case(kind, room)
    tiles, order, tree = _tree(tris)
    t_p, i_p = tsorted.sorted_first_hit(tiles, tree, *_port(o, d, alive))
    t_w, i_w, visits = tsorted.sorted_walk(tiles, tree, *_port(o, d, alive))
    t_d, i_d = _dense_sorted(tris, order, tiles, o, d, alive)
    assert torch.equal(i_p, i_d) and torch.equal(t_p, t_d) and torch.equal(i_w, i_d) and torch.equal(t_w, t_d)
    held, _ = tree_certificate(tree, torch.from_numpy(o) - tiles.center, torch.from_numpy(d), t_d.numpy(), i_d.numpy())
    assert held.all()
    print(f"{kind}: {float(visits[:, 0].double().mean()):.1f} box tests and {float(visits[:, 1].double().mean()):.2f} "
          f"leaves per ray of {tree.n_leaves}")
    if kind == "all dead":
        assert not visits.any()
    else:
        assert float(visits[:, 1].double().mean()) < 0.25 * tree.n_leaves or tree.n_leaves < 16


def test_escaping_rays():
    """Outside the box pointing away: (inf, -1); inside pointing up: the
    ceiling at t = 1."""
    mesh = box_mesh(extents=[2.0, 2.0, 2.0], center=[1.0, 1.0, 1.0])
    tiles, _, tree = _tree(mesh.triangles.astype(np.float32))
    o = torch.tensor([[5.0, 5.0, 5.0], [1.0, 1.0, 1.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t, idx = tsorted.sorted_first_hit(tiles, tree, o, d)
    assert np.isinf(float(t[0])) and int(idx[0]) == -1
    assert int(idx[1]) >= 0 and abs(float(t[1]) - 1.0) <= 1e-5
