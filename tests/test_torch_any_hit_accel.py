"""The any-hit face tree of K2 and K6 (csrc/any_hit_walk.cuh) on the CPU.

Both kernels walk a tree of padded boxes over Morton-sorted leaves of the
dense any-hit table's rows and must give the dense any-hit's booleans. These
tests hold, without the card:

- the walk's plain version (`any_hit_walk_plain`, the kernels' steps in their
  order) equal to the dense plain any-hit and to the JAX package's
  `geometry.queries.segments_occluded`, boolean for boolean, on segments
  from the interior, from the surface (the tracer's 1e-4 m offset), grazing
  a face at 1e-6-3e-2 rad, axis-aligned, through vertices and edge
  midpoints, of zero length and with NaN or inf components, in a subdivided
  `scanned_like_room`, its LOD and the room with 1e9 sentinels and flat
  faces mixed in. Against the JAX package one exception is allowed and
  shown: a segment that crosses a face within 1e-6 (barycentric) of its
  edge or vertex, where XLA:CPU's contracted multiply-adds and the port's
  unfused f32 round the crossing into another face or the crack between
  (7 of the 500 vertex and edge segments; none elsewhere);
- a cull certificate: every face that the dense test reports as blocking a
  segment lies in a leaf whose box and every ancestor's box the segment
  [0, length] enters (the kernels' predicate, term for term:
  `cuda_kernels.slab_entry_exit`), or among the always-tested rows; so the
  walk can skip no blocker;
- the faces left out of both can never pass the dense test (a zero edge
  makes a = 0 or NaN), while a zero-area face whose edges are exactly
  collinear can (by rounding), and so is always tested;
- a tree over a subset of the faces (the star's, K6) holds exactly that
  subset, its rows the dense table's bit for bit (tests/test_torch_star.py
  holds the star against the reference's K6);
- the rain-table, direct-path, diffraction-leg and trace calls through a
  device state's cached trees equal the tree-less dense calls, and each
  tree is built once per mesh.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.queries import segments_occluded as jax_segments_occluded
from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
from audiblelight_tpu_torch.micarrays import ambeovr_capsules
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.ops import star_occlusion as so
from audiblelight_tpu_torch.rir import raytracer as trt
from audiblelight_tpu_torch.worldstate.mesh_backend import MeshDeviceState
from test_torch_cuda import _flat_faces, _unit, _with_sentinels, accel_meshes, segment_set

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    m = accel_meshes()
    room = m["room"]
    m["mixed"] = np.concatenate([_with_sentinels(room, 3), _flat_faces(room, 4)])
    return m


KINDS = ("interior", "surface", "grazing", "axis", "vertex_edge", "zero_length", "nonfinite")
CASES = [("room", k) for k in KINDS] + [("lod", k) for k in ("interior", "surface", "grazing")]
CASES += [("mixed", k) for k in ("interior", "surface", "nonfinite")]


def _case(meshes, which, kind):
    tris = meshes[which]
    base = meshes["room"] if which == "mixed" else tris
    starts, ends = segment_set(kind, base, seed=zlib.crc32(f"{which} {kind}".encode()))
    tt = torch.from_numpy(tris)
    o, d, length = ck.segment_inputs(torch.from_numpy(starts), torch.from_numpy(ends))
    return tris, starts, ends, ck.any_hit_tree(tt), o, d, length


def edge_crossings(starts, ends, tris, tol=1e-6):
    """(R,) bool: the segment crosses some face's plane inside its window at
    a point whose smallest barycentric coordinate lies within `tol` of 0
    (the face's edge or vertex), in float64."""
    s, e = starts.astype(np.float64), ends.astype(np.float64)
    g = e - s
    out = np.zeros(len(s), dtype=bool)
    for f0 in range(0, len(tris), 1024):
        t3 = tris[f0 : f0 + 1024].astype(np.float64)
        a, e1, e2 = t3[:, 0], t3[:, 1] - t3[:, 0], t3[:, 2] - t3[:, 0]
        n = np.cross(e1, e2)
        with np.errstate(all="ignore"):
            t = np.einsum("fk,rfk->rf", n, a[None] - s[:, None]) / (g @ n.T)
            p = s[:, None] + t[..., None] * g[:, None] - a[None]
            d00, d01, d11 = (e1 * e1).sum(1), (e1 * e2).sum(1), (e2 * e2).sum(1)
            d20, d21 = np.einsum("rfk,fk->rf", p, e1), np.einsum("rfk,fk->rf", p, e2)
            den = d00 * d11 - d01 * d01
            v = (d11 * d20 - d01 * d21) / den
            w = (d00 * d21 - d01 * d20) / den
            m = np.minimum(np.minimum(1.0 - v - w, v), w)
            out |= ((t > 0) & (t < 1) & (np.abs(m) <= tol)).any(axis=1)
    return out


def dense_blockers(o, d, length, tris):
    """(segment, face) index pairs that pass the dense any-hit test."""
    tab = ck.mt_face_table(torch.from_numpy(tris))
    pairs = []
    for f0 in range(0, tab.shape[0], 2048):
        hit = ck._mt_blocks(o, d, length - 1e-4, tab[f0 : f0 + 2048].T[:, None, :])
        seg, face = torch.nonzero(hit, as_tuple=True)
        pairs.append(torch.stack([seg, face + f0], dim=1))
    return torch.cat(pairs)


def certificate(tree, o, d, length, pairs, n_faces):
    """(held per pair, smallest slack): a pair holds where its face is always
    tested, or its leaf and every ancestor are entered by the segment
    [0, length]; the slack is the least length - entry over the pairs."""
    bvh = tree.bvh
    pos = torch.full((n_faces,), -1, dtype=torch.int64)
    real = bvh.face >= 0
    pos[bvh.face[real].long()] = torch.nonzero(real).squeeze(1)
    always = torch.zeros_like(pos, dtype=torch.bool)
    always[tree.always_face.long()] = True
    seg, face = pairs[:, 0], pairs[:, 1]
    held = always[face].clone()
    walk = ~held
    assert bool((pos[face[walk]] >= 0).all()), "a blocking face is neither in the tree nor always tested"
    s, node = seg[walk], bvh.n_leaves + pos[face[walk]] // bvh.leaf_faces
    inv = ck.slab_inverse(d[s])
    ok, slack = torch.ones(len(s), dtype=torch.bool), np.inf
    while len(s):
        entry, exit_ = ck.slab_entry_exit(o[s], inv, bvh.boxes[node, 0:3], bvh.boxes[node, 4:7])
        ok &= (entry <= exit_) & (entry <= length[s])
        slack = min(slack, float((length[s] - entry).min()))
        if int(node.max()) == 1:
            break
        node = node // 2
    held[walk] = ok
    return held, slack


@pytest.mark.parametrize("which,kind", CASES)
def test_walk_matches_dense_and_reference(meshes, which, kind):
    """The walk equals the dense any-hit of both packages; every dense
    blocker is certified; a blocked segment stops at its first blocking
    leaf and no segment walks most of the tree."""
    tris, starts, ends, tree, o, d, length = _case(meshes, which, kind)
    blocked, visits = ck.any_hit_walk_plain(o, d, length, tree)
    dense = ck._any_hit_plain(o, d, length, ck.mt_face_table(torch.from_numpy(tris)))
    want = np.asarray(jax_segments_occluded(jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(tris)))
    pairs = dense_blockers(o, d, length, tris)
    held, slack = certificate(tree, o, d, length, pairs, len(tris))
    print(f"{which} {kind}: {tree}, {len(o)} segments, blocked {float(blocked.float().mean()):.3f}, "
          f"{len(pairs)} blocking pairs, smallest length - ancestor entry {slack:.3e}, per segment "
          f"{float(visits[:, 0].double().mean()):.1f} box tests, {float(visits[:, 1].double().mean()):.2f} leaves")
    assert bool(held.all())
    np.testing.assert_array_equal(blocked.numpy(), dense.numpy())
    off = blocked.numpy() != want
    if off.any():
        edge = edge_crossings(starts, ends, tris)
        print(f"  {off.sum()} segments differ from the JAX package, all crossing a face within 1e-6 of its edge: "
              f"{bool(edge[off].all())}")
        assert edge[off].all() and off.mean() <= 0.02
    assert kind == "vertex_edge" or not off.any()
    if kind == "zero_length":
        assert not blocked.any() and not visits.any()
    elif kind == "nonfinite":
        bad = ~np.isfinite(np.concatenate([starts, ends], axis=1)).all(axis=1)
        assert bad.any() and not blocked.numpy()[bad].any() and not visits.numpy()[bad].any()
    elif kind == "vertex_edge":  # through a wall's vertex or edge: nearly every segment crosses it
        assert float(blocked.float().mean()) > 0.5
    else:
        assert 0.02 < float(blocked.float().mean()) < 0.98
    assert bool((visits[blocked, 1] >= 1).all() | (tree.always.shape[0] > 0))
    assert float(visits[:, 1].double().mean()) < 0.25 * tree.bvh.n_leaves


def test_left_out_faces_never_pass(meshes):
    """The tree and its always-tested rows together hold every face that
    could pass the dense test: a face with a zero edge (the 1e9 sentinels,
    e1 = 0, e2 = 0) is left out and passes for no segment, NaN and inf ones
    included; the exactly collinear zero-area faces are not left out (their
    rounding gives |a| > 1e-9) and some of them do pass, so they are always
    tested."""
    room = meshes["room"]
    flat = _flat_faces(room, 4)
    zero_edge = np.concatenate([np.full((8, 3, 3), 1.0e9, np.float32), room[:8].copy(), room[8:16].copy()])
    zero_edge[8:16, 1] = zero_edge[8:16, 0]
    zero_edge[16:24, 2] = zero_edge[16:24, 0]
    tris = np.concatenate([room, zero_edge, flat])
    n_room, n_zero = len(room), len(zero_edge)
    tree = ck.any_hit_tree(torch.from_numpy(tris))
    in_tree = set(tree.bvh.face[tree.bvh.face >= 0].tolist())
    always = set(tree.always_face.tolist())
    left_out = set(range(len(tris))) - in_tree - always
    assert left_out == set(range(n_room, n_room + n_zero))
    assert set(range(n_room + n_zero, len(tris))) <= always and not in_tree & always
    segs = [segment_set(k, room, seed=i) for i, k in enumerate(("interior", "surface", "grazing", "nonfinite"))]
    # And segments through the lines of the flat faces and the zero-edge
    # faces (not the sentinels), 40 each, in random directions
    rng = np.random.default_rng(9)
    odd = np.concatenate([zero_edge[8:], flat]).astype(np.float64)
    lam = rng.uniform(0.0, 1.0, (len(odd), 40))[..., None]
    p = odd[:, None, 0] + lam * (odd[:, None, 1] - odd[:, None, 0])
    dirs = _unit(rng.standard_normal((len(odd), 40, 3))).astype(np.float64)
    half = rng.uniform(0.05, 1.0, (len(odd), 40, 1))
    segs.append(tuple((p + sign * half * dirs).reshape(-1, 3).astype(np.float32) for sign in (-1.0, 1.0)))
    starts, ends = (np.concatenate(x) for x in zip(*segs))
    o, d, length = ck.segment_inputs(torch.from_numpy(starts), torch.from_numpy(ends))
    pairs = dense_blockers(o, d, length, tris)
    face = pairs[:, 1].numpy()
    assert not np.isin(face, list(left_out)).any()
    flat_hits = int((face >= n_room + n_zero).sum())
    print(f"{len(o)} segments: dense passes on the collinear zero-area faces {flat_hits}, on the left-out faces 0")
    assert flat_hits > 0
    blocked, _ = ck.any_hit_walk_plain(o, d, length, tree)
    np.testing.assert_array_equal(blocked.numpy(), ck._any_hit_plain(o, d, length, ck.mt_face_table(
        torch.from_numpy(tris))).numpy())


def test_face_selection_and_rows(meshes):
    """`faces` restricts the tree to a subset (the star's faces); rows are
    the dense table's rows bit for bit, padded with zeros to ANY_HIT_ROW."""
    tris = torch.from_numpy(meshes["mixed"])
    keep = torch.from_numpy(so.star_faces(meshes["mixed"]))
    tree = ck.any_hit_tree(tris, keep)
    faces = torch.cat([tree.bvh.face[tree.bvh.face >= 0], tree.always_face]).long()
    assert torch.equal(torch.sort(faces).values, torch.nonzero(keep).squeeze(1))
    tab = ck.mt_face_table(tris)
    real = tree.bvh.face >= 0
    assert torch.equal(tree.bvh.rows[real][:, :9].view(torch.int32), tab[tree.bvh.face[real].long()].view(torch.int32))
    assert not tree.bvh.rows[:, 9:].any() and not tree.bvh.rows[~real].any()
    assert torch.equal(tree.always[:, :9], tab[tree.always_face.long()])


@pytest.fixture(scope="module")
def state():
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=3, seed=0)
    cfg = dict(indirect_ray_count=64, indirect_ray_depth=4, max_ir_length=0.1, mesh_simplification=False,
               diffraction=True, max_diffraction_order=2)
    return MeshDeviceState.from_mesh(mesh, cfg, device="cpu")


def test_cached_trees_equal_tree_less_calls(state, monkeypatch):
    """The rain table, the direct paths and the diffraction legs through the
    state's cached trees equal the tree-less (dense) calls; a trace through
    the state builds each tree once and equals the tree-less trace."""
    builds = []
    real_build = ck.any_hit_tree

    def counting(tris, faces=None):
        builds.append(tris.shape[0])
        return real_build(tris, faces)

    monkeypatch.setattr("audiblelight_tpu_torch.worldstate.mesh_backend.any_hit_tree", counting)
    caps = torch.as_tensor(ambeovr_capsules([3.5, 2.5, 1.5]), dtype=torch.float32)
    src = torch.tensor([[1.5, 1.2, 1.4], [5.6, 3.9, 1.1], [0.6, 4.4, 2.0], [6.5, 0.5, 0.4]])
    ac, full = state.acoustic_tris, state.tris
    graph = state.diffraction_graph_tris if state.diffraction_graph_tris is not None else full
    got = trt.face_rain_occlusion(ac, state.acoustic_normals, caps, state.any_hit_tree(ac))
    assert torch.equal(got, trt.face_rain_occlusion(ac, state.acoustic_normals, caps))
    assert 0 < int(got.sum()) < got.numel()
    n = 2400
    got = trt.direct_paths_ir(full, src, caps, n, tree=state.any_hit_tree(full))
    assert torch.equal(got, trt.direct_paths_ir(full, src, caps, n))
    bands = torch.tensor([250.0, 1000.0, 4000.0, 8000.0])
    kw = dict(order=2, tris_graph=state.diffraction_graph_tris)
    got = trt.diffracted_path_ir(full, src, caps, bands, n, tree=state.any_hit_tree(full),
                                 tree_graph=state.any_hit_tree(graph), **kw)
    assert torch.equal(got, trt.diffracted_path_ir(full, src, caps, bands, n, **kw))
    rain = state.rain_inputs(caps.numpy(), caps.numpy())
    irs = state.trace_rirs(torch.Generator().manual_seed(3), src, caps, "omni", rain)
    assert len(builds) == len({id(ac), id(full), id(graph)}) and float(irs.abs().max()) > 0
    cfg = state.cfg
    want = trt.trace_rirs_multi(
        torch.Generator().manual_seed(3), ac, state.absorption, state.scattering, src, caps,
        n_samples=irs.shape[-1], sr=int(cfg["sample_rate"]), n_rays=int(cfg["indirect_ray_count"]),
        max_depth=int(cfg["indirect_ray_depth"]), bin_dt=float(cfg["hist_bin_dt"]), c=float(cfg["speed_of_sound"]),
        tri_normals=state.acoustic_normals, tris_direct=full, diffraction=True, diffraction_order=2,
        tris_diffraction_graph=state.diffraction_graph_tris, decimate=bool(cfg["ray_decimation"]),
        fh_table=state.first_hit_table(ac), **rain)
    assert torch.equal(irs, want)
