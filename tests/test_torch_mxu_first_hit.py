"""The port's bilinear first hit (K8) against the JAX package.

- `build_mxu_face_tables`: the kernel's packed rows against the non-zero
  rows of the reference's four (16, F_pad) operands, the normals and the
  plane offsets, within 1e-6 of each row's largest magnitude (the reference
  sums k = A'.n through XLA, the port left to right), the centre identical.
- `mxu_first_hit` (its plain version here) against the reference's
  interpret-mode Pallas kernel on the box and scanned-LOD cases of
  tests/test_mxu_first_hit.py. The reference's products run through XLA:CPU
  dots, whose summation order the port does not copy, so a face can flip
  where the f32 rounding decides. The test finds those rays in float64: a
  window test (or |det| > 1e-6, t > 1e-4) of a face at or before the best t
  within 1e-5 of its edge (edge rays, excluded; at most 0.5 % of the rays), or
  the two smallest accepted t within 1e-5 relative (tie rays: with the 2 %
  window slop, coplanar neighbours both accept near their shared edge, so
  these are common). Every other ray has the reference's face; a tie ray
  has one of the tied faces; t within rtol 1e-5 on both, and 1e-6 m: the
  exact plane re-evaluation k - o'.n cancels terms of |o'| |n|, which
  XLA:CPU sums with contracted multiply-adds, so a hit a centimetre away
  differs by a few 1e-7 m.
- The launch-face mask and escaping rays.
- The kernel's walk of the LOD's face tree (its plain version, `mxu_walk`:
  the same centring, window test and plane re-evaluation) against the dense
  selection over every face with its re-evaluation (`mxu_first_hit_plain`),
  t and faces bit for bit, on the ray families of
  tests/test_torch_first_hit_accel.py, bounce rays with their launch face
  masked (1e-4 m off the surface and on it), and rays aimed at the 2 %
  slop band just outside a face's edges; with the cull certificate for the
  window's arithmetic: every ancestor of the leaf holding the dense winner,
  its box that of the slop-widened triangles, is entered no later than the
  winner's selection t.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.mesh import box_mesh, scanned_like_room
from audiblelight_tpu.ops import mxu_first_hit as jmxu
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.ops import mxu_first_hit as tmxu
from test_torch_cuda import _normals, _unit, _with_sentinels, accel_meshes, ray_set
from test_torch_first_hit_accel import tree_certificate

torch.set_num_threads(1)

TOL = 1e-5


def _rays(n, extents, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.25, 0.75, (n, 3)) * np.asarray(extents)
    d = rng.standard_normal((n, 3))
    return np.float32(o), np.float32(d / np.linalg.norm(d, axis=-1, keepdims=True))


def _cases():
    box = box_mesh(extents=[6.0, 4.0, 3.0], center=[3.0, 2.0, 1.5])
    lod = scanned_like_room(extents=(5.0, 4.0, 2.8), seed=3).simplified(target_faces=2000)
    return {
        "box": (np.asarray(box.triangles, np.float32), _rays(700, [6.0, 4.0, 3.0])),
        "scanned lod": (np.asarray(lod.triangles, np.float32), _rays(600, (5.0, 4.0, 2.8), seed=5)),
    }


def _f64_windows(tris, o, d, prev=None):
    """Float64 (accepted, t, could flip) of every (ray, face) pair, in the
    reference's centred form: a pair could flip when each of its tests
    passes or misses by less than TOL and one lies within TOL of its edge."""
    tr, o, d = tris.astype(np.float64), o.astype(np.float64), d.astype(np.float64)
    verts = tr.reshape(-1, 3)
    c = 0.5 * (verts.min(0) + verts.max(0))
    a, e1, e2 = tr[:, 0] - c, tr[:, 1] - tr[:, 0], tr[:, 2] - tr[:, 0]
    n = np.cross(e1, e2)
    oc = o - c
    od = np.cross(oc, d)
    det = -(d @ n.T)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (od @ e2.T + d @ np.cross(a, e2).T) / det
        v = (-(od @ e1.T) - d @ np.cross(a, e1).T) / det
        t = (oc @ n.T - (a * n).sum(-1)) / det
        tests = np.stack([u + 0.02, 1.02 - u, v + 0.02, 1.02 - u - v, t - 1e-4, np.abs(det) - 1e-6])
        ok = (tests > 0).all(0)
        flip = (tests > -TOL).all(0) & (np.abs(tests) < TOL).any(0)
    if prev is not None:
        ok &= np.arange(len(tr))[None] != prev[:, None]
    return ok, t, flip


def _ambiguous(tris, o, d):
    """(edge rays, tie rays, the tied faces of each ray (R, F) bool)."""
    ok, t, flip = _f64_windows(tris, o, d)
    tt = np.where(ok, t, np.inf)
    srt = np.sort(tt, axis=1)
    best = srt[:, :1]
    edge_ray = (flip & (t <= best * (1 + TOL))).any(1)
    tied = ok & (tt <= best * (1 + TOL))
    tie_ray = np.isfinite(srt[:, 1]) & (srt[:, 1] - srt[:, 0] <= TOL * np.abs(srt[:, 0]))
    return edge_ray, tie_ray & ~edge_ray, tied


@pytest.mark.parametrize("name", ["box", "scanned lod"])
def test_tables_match_reference(name):
    tris, _ = _cases()[name]
    want = jmxu.build_mxu_face_tables(jnp.asarray(tris))
    got = tmxu.build_mxu_face_tables(torch.from_numpy(tris))
    assert got.n_faces == want.n_faces == len(tris)
    # The kernel's rows against the reference's operands: the non-zero rows
    # match, every other entry of the operands (and the padding) is zero
    packed, f = got.packed.numpy(), len(tris)
    assert packed.shape == (f, 19)
    layout = {"face_u": (0, 0, 6), "face_v": (0, 6, 12), "face_a": (3, 12, 15), "face_t": (6, 15, 19)}
    for field, (row0, c0, c1) in layout.items():
        w = np.asarray(getattr(want, field))
        rows = slice(row0, row0 + c1 - c0)
        assert w.shape == (16, got.normal.shape[0])
        scale = np.abs(w[rows]).max(axis=1, keepdims=True)
        assert (np.abs(packed[:, c0:c1].T - w[rows, :f]) <= 1e-6 * scale).all(), field
        rest = np.ones(16, bool)
        rest[rows] = False
        assert not w[rest].any() and not w[:, f:].any(), field
    for field in ("normal", "plane_k"):
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.shape == w.shape
        assert (np.abs(g - w) <= 1e-6 * np.abs(w).max(axis=0)).all(), field
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(want.center))


@pytest.mark.parametrize("name", ["box", "scanned lod"])
def test_mxu_first_hit_matches_reference(name):
    tris, (o, d) = _cases()[name]
    t_j, i_j = map(np.asarray, jmxu.mxu_first_hit(jmxu.build_mxu_face_tables(jnp.asarray(tris)),
                                                  jnp.asarray(o), jnp.asarray(d), interpret=True))
    t_p, i_p = tmxu.mxu_first_hit(tmxu.build_mxu_face_tables(torch.from_numpy(tris)), torch.from_numpy(o),
                                  torch.from_numpy(d))
    t_p, i_p = t_p.numpy(), i_p.numpy()
    edge, tie, tied = _ambiguous(tris, o, d)
    rest = ~edge & ~tie
    print(f"{name}: {edge.mean():.4f} edge rays, {tie.mean():.4f} tie rays, faces differ on "
          f"{(i_p != i_j).mean():.4f} of the rays, on {(i_p != i_j)[rest].sum()} of the others")
    assert edge.mean() <= 0.005
    assert (i_j >= 0).mean() > 0.99
    np.testing.assert_array_equal(i_p[rest], i_j[rest])
    assert tied[np.flatnonzero(tie), i_p[tie]].all()
    keep = ~edge & (i_j >= 0)
    np.testing.assert_allclose(t_p[keep], t_j[keep], rtol=TOL, atol=1e-6)


def test_prev_face_excluded():
    """A ray launched from face 0's centroid along its interior normal hits
    the opposite wall, not face 0, when face 0 is masked; unmasked rays from
    the same points equal the reference's."""
    tris = np.asarray(box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25]).triangles, np.float32)
    a, b, c = tris[0]
    centroid = (a + b + c) / 3.0
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n)
    if np.dot(np.array([2.0, 1.5, 1.25]) - centroid, n) < 0:
        n = -n
    o, d = np.float32(centroid[None]), np.float32(n[None])
    prev = np.array([0], np.int32)
    t_j, i_j = map(np.asarray, jmxu.mxu_first_hit(jmxu.build_mxu_face_tables(jnp.asarray(tris)), jnp.asarray(o),
                                                  jnp.asarray(d), jnp.asarray(prev), interpret=True))
    tables = tmxu.build_mxu_face_tables(torch.from_numpy(tris))
    t_p, i_p = tmxu.mxu_first_hit(tables, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(prev))
    assert int(i_p[0]) != 0 and np.isfinite(float(t_p[0]))
    assert int(i_p[0]) == int(i_j[0])
    np.testing.assert_allclose(t_p.numpy(), t_j, rtol=TOL)
    ok, t64, _ = _f64_windows(tris, o, d, prev)
    assert ok[0, int(i_p[0])] and abs(float(t_p[0]) / t64[0, int(i_p[0])] - 1) < TOL


def test_escaping_rays_miss():
    tris = np.asarray(box_mesh(extents=[2.0, 2.0, 2.0], center=[1.0, 1.0, 1.0]).triangles, np.float32)
    tables = tmxu.build_mxu_face_tables(torch.from_numpy(tris))
    o = torch.tensor([[5.0, 5.0, 5.0], [1.0, 1.0, 1.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t, idx = tmxu.mxu_first_hit(tables, o, d)
    assert np.isinf(float(t[0])) and int(idx[0]) == -1
    assert abs(float(t[1]) - 1.0) < 1e-6 and int(idx[1]) >= 0


def test_face_budget_enforced():
    tris = torch.rand((tmxu.MXU_F_MAX + 1, 3, 3))
    with pytest.raises(ValueError):
        tmxu.build_mxu_face_tables(tris)


@pytest.fixture(scope="module")
def meshes():
    return accel_meshes()


def _slop_rays(tris, rng, n):
    """Rays aimed from 0.05-3 m at points of a face's plane in its window's
    slop band: barycentric (u, v) with u, v >= -0.02 and u + v <= 1.02 but
    outside the triangle."""
    f = rng.integers(0, len(tris), 20 * n)  # ~5.5 % of the draws land in the band
    uv = rng.uniform(-0.02, 1.04, (20 * n, 2))
    u, v = uv[:, 0], uv[:, 1]
    band = (u >= -0.02) & (v >= -0.02) & (u + v <= 1.02) & ((u < 0) | (v < 0) | (u + v > 1))
    f, u, v = f[band][:n], u[band][:n, None], v[band][:n, None]
    tri = tris[f].astype(np.float64)
    p = tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2] - tri[:, 0])
    d = _unit(rng.standard_normal((len(f), 3)))
    s = rng.uniform(0.05, 3.0, (len(f), 1))
    return (p - s * d).astype(np.float32), d


def _mxu_rays(kind, tris, tables, seed, n=600):
    """(origins, dirs, launch faces) of one ray family against the LOD
    `tris`: bounce rays ("surface": 1e-4 m off the hit face, "on_surface":
    on it) leave the dense winner of interior rays, half specular and half
    diffuse, with that face masked; "slop" rays aim into the slop band; the
    rest are tests/test_torch_first_hit_accel.py's, half of them with a
    random face masked."""
    rng = np.random.default_rng(seed)
    if kind in ("surface", "on_surface"):
        o, d = ray_set("interior", tris, seed, n)
        t, f = (x.numpy() for x in tmxu.mxu_first_hit_plain(tables, torch.from_numpy(o), torch.from_numpy(d)))
        ok = f >= 0
        o, d, t, f = o[ok], d[ok], t[ok], f[ok]
        nrm = _normals(tris[f])
        nrm = np.where((nrm * d).sum(1, keepdims=True) > 0, -nrm, nrm)
        hit = o + t[:, None] * d + (1e-4 * nrm if kind == "surface" else 0.0)
        refl = d - 2.0 * (d * nrm).sum(1, keepdims=True) * nrm
        diffuse = _unit(rng.standard_normal((len(o), 3)))
        diffuse = np.where((diffuse * nrm).sum(1, keepdims=True) < 0, -diffuse, diffuse)
        half = len(o) // 2
        return hit.astype(np.float32), np.concatenate([refl[:half], diffuse[half:]]).astype(np.float32), f
    o, d = _slop_rays(tris, rng, n) if kind == "slop" else ray_set(kind, tris, seed, n)
    prev = np.where(rng.uniform(size=len(o)) < 0.5, rng.integers(0, len(tris), len(o)), -1)
    return o, d, prev.astype(np.int32)


MXU_CASES = [("room", k) for k in ("interior", "surface", "on_surface", "grazing", "axis", "vertex_edge",
                                   "nonfinite", "slop")]
MXU_CASES += [("lod", k) for k in ("interior", "surface", "grazing", "axis", "slop")] + [("lod_sentinels", "surface")]


@pytest.mark.parametrize("which,kind", MXU_CASES)
def test_window_walk_certificate_and_equality(meshes, which, kind):
    """Every ancestor of the leaf holding the dense selection's winner is
    entered no later than its selection t, and K8's walk gives the dense
    selection's bits after the plane re-evaluation."""
    base = meshes["lod" if which == "lod_sentinels" else which]
    tris = _with_sentinels(base, 7) if which == "lod_sentinels" else base
    tables = tmxu.build_mxu_face_tables(torch.from_numpy(tris))
    o, d, prev = _mxu_rays(kind, tris, tables, seed=zlib.crc32(f"mxu {which} {kind}".encode()))
    o_t, d_t, p_t = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(prev)
    o_c, _, rvec, _ = tmxu.mxu_inputs(tables, o_t, d_t, p_t)
    t_sel, f_sel = (x.numpy() for x in ck.first_hit_mxu_plain(rvec, p_t, tables.packed))
    t_sel = np.where(f_sel >= 0, t_sel, np.inf).astype(np.float32)
    t_star, f_star = (x.numpy() for x in tmxu.mxu_first_hit_plain(tables, o_t, d_t, p_t))
    np.testing.assert_array_equal(f_star, f_sel)
    if kind == "nonfinite":
        bad = ~np.isfinite(np.concatenate([o, d], axis=1)).all(axis=1)
        assert bad.any() and (f_star[bad] == -1).all()
    else:
        assert (f_star >= 0).mean() > 0.8
    if kind in ("surface", "on_surface"):
        assert (f_star != prev).all()
    held, slack = tree_certificate(tables.bvh, o_c, d_t, t_sel, f_sel)
    print(f"{which} {kind}: {len(o)} rays, {(f_star >= 0).sum()} hits, {(prev >= 0).sum()} launch faces masked, "
          f"smallest t_sel - ancestor entry {slack:.3e}")
    assert held.all()
    t_w, f_w, visits = tmxu.mxu_walk(tables, o_t, d_t, p_t)
    np.testing.assert_array_equal(f_w.numpy(), f_star)
    np.testing.assert_array_equal(t_w.numpy().view(np.int32), t_star.view(np.int32))
    assert float(visits[:, 1].double().mean()) < 0.25 * tables.bvh.n_leaves
