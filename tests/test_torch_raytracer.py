"""The port's ray tracer against the JAX one.

The deterministic parts (direct paths, knife-edge diffraction, the per-face
rain table) are held to identical occlusion booleans and to a fraction of the
reference's peak: 5e-5 for the direct path, 1e-4 for the diffracted one. The
two packages' f32 transcendentals (cos, sin, log10, pow) differ in the last
bit on a few percent of inputs, and an arrival time rounded one ULP apart
moves a band-limited pulse: one ULP of a 5 m path is 3e-5 samples at 24 kHz,
up to 1e-4 of the pulse's peak; the direct path's windowed sinc jumps by
~1e-5 of its peak where the delay crosses an integer sample. The stochastic
parts draw from a torch.Generator where the reference draws threefry bits, so
they are held statistically: band energies within 5 %, T30 within 10 %.

The reference sends the direct-path and diffraction-trigger segments of a
big mesh through its uniform-grid DDA (geometry/grid.py); the port sends them
through the dense any-hit kernel. `test_any_hit_matches_grid_on_scanned_room`
holds the two against each other on a 27,648-face nonconvex room.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.mesh import TriMesh, box_mesh, scanned_like_room
from audiblelight_tpu.rir import raytracer as jrt
from audiblelight_tpu_torch.micarrays import ambeovr_capsules
from audiblelight_tpu_torch.rir import raytracer as trt

torch.set_num_threads(1)

SR = 24000
BANDS = np.array([125.0, 500.0, 2000.0, 8000.0], np.float32)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _barrier_room(two: bool) -> TriMesh:
    """tests/test_diffraction.py's rooms: one full-width barrier at x=4 (gap
    at the top), or two (x=4 gap on top, x=8 gap below) that no single bend
    clears."""
    room = box_mesh(extents=[12.0 if two else 8.0, 4.0, 3.0], center=[6.0 if two else 4.0, 2.0, 1.5])
    quads = [np.array([[4.0, 0, 0], [4.0, 4, 0], [4.0, 4, 2], [4.0, 0, 2]])]
    if two:
        quads.append(np.array([[8.0, 0, 1], [8.0, 4, 1], [8.0, 4, 3], [8.0, 0, 3]]))
    f4 = np.array([[0, 1, 2], [0, 2, 3], [0, 2, 1], [0, 3, 2]])
    verts = np.concatenate([room.vertices] + quads)
    faces = np.concatenate([room.faces] + [f4 + len(room.vertices) + 4 * i for i in range(len(quads))])
    return TriMesh(verts, faces.astype(np.int32))


CASES = {
    # (mesh, sources, capsule centre, order)
    "barrier": (lambda: _barrier_room(False), [[2.0, 2.0, 1.2], [2.0, 1.0, 0.5], [5.0, 3.0, 1.0]],
                [6.0, 2.0, 1.2], 1),
    "two_barriers": (lambda: _barrier_room(True), [[2.0, 2.0, 1.2], [1.5, 3.0, 2.0], [9.0, 1.0, 1.5]],
                     [10.0, 2.0, 1.2], 4),
}


def _reference_direct_and_diffracted(tris, src, caps, n_samples, order, accel=None, tris_graph=None):
    direct = jrt.direct_paths_ir(jnp.asarray(tris), jnp.asarray(src), jnp.asarray(caps), n_samples,
                                 sr=SR, accel=accel)
    diffr = jax.vmap(lambda s: jrt.diffracted_path_ir(
        jnp.asarray(tris), s, jnp.asarray(caps), jnp.asarray(BANDS), n_samples, sr=SR,
        accel=accel, order=order, tris_graph=tris_graph,
    ))(jnp.asarray(src))
    return np.asarray(direct), np.asarray(diffr)


@pytest.mark.parametrize("name", sorted(CASES))
def test_direct_and_diffracted_match_reference(name):
    make, src, centre, order = CASES[name]
    tris = make().triangles.astype(np.float32)
    src = np.asarray(src, np.float32)
    caps = ambeovr_capsules(centre).astype(np.float32)
    n = SR // 2
    want_d, want_g = _reference_direct_and_diffracted(tris, src, caps, n, order)
    got_d = trt.direct_paths_ir(_t(tris), _t(src), _t(caps), n, sr=SR).numpy()
    got_g = trt.diffracted_path_ir(_t(tris), _t(src), _t(caps), _t(BANDS), n, sr=SR, order=order).numpy()
    _close(got_d, want_d, 5e-5)
    _close(got_g, want_g, 1e-4)
    # The case is non-trivial: some pairs are occluded (no direct path) and diffract
    occluded = np.abs(want_d).max(axis=-1) == 0
    assert occluded.any() and (~occluded).any()
    assert np.abs(want_g).max() > 1e-8


def test_graph_detour_matches_reference():
    _, src, centre, _ = CASES["two_barriers"]
    tris = _barrier_room(True).triangles.astype(np.float32)
    src = np.asarray(src, np.float32)
    centre = ambeovr_capsules(centre).mean(axis=0).astype(np.float32)
    want = jax.vmap(lambda s: jrt._graph_detour(jnp.asarray(tris), s, jnp.asarray(centre), None, 4))(
        jnp.asarray(src))
    got = trt._graph_detour(_t(tris), _t(src), _t(centre), 4)
    found, dist, bend, deltas = (np.asarray(x) for x in want)
    assert found.all()
    np.testing.assert_array_equal(got[0].numpy(), found)
    np.testing.assert_allclose(got[1].numpy(), dist, rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), bend, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), deltas, rtol=1e-4, atol=1e-5)


def test_any_hit_matches_grid_on_scanned_room():
    """The reference's grid DDA on the full mesh, and its dense any-hit on the
    LOD for the candidate legs, against the port's dense any-hit for both."""
    from audiblelight_tpu.geometry.grid import build_grid
    from audiblelight_tpu.geometry.queries import points_inside_mesh

    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=4, seed=0)
    tris = mesh.triangles.astype(np.float32)
    assert len(tris) == 27648 and not mesh.is_convex
    lod = mesh.simplified(target_faces=4096).triangles.astype(np.float32)
    rng = np.random.default_rng(7)
    cand = rng.uniform([0.3, 0.3, 0.3], [6.7, 4.7, 2.0], (64, 3)).astype(np.float32)
    inside = np.asarray(points_inside_mesh(jnp.asarray(cand), jnp.asarray(tris)))
    src = cand[inside][:8]
    caps = ambeovr_capsules([3.5, 2.5, 1.5]).astype(np.float32)
    n = SR // 4
    grid = build_grid(tris)
    want_d, want_g = _reference_direct_and_diffracted(tris, src, caps, n, 1, accel=grid,
                                                      tris_graph=jnp.asarray(lod))
    got_d = trt.direct_paths_ir(_t(tris), _t(src), _t(caps), n, sr=SR).numpy()
    got_g = trt.diffracted_path_ir(_t(tris), _t(src), _t(caps), _t(BANDS), n, sr=SR, order=1,
                                   tris_graph=_t(lod)).numpy()
    occluded = np.abs(want_d).max(axis=-1) == 0
    np.testing.assert_array_equal(np.abs(got_d).max(axis=-1) == 0, occluded)
    assert occluded.any() and (~occluded).any()
    _close(got_d, want_d, 5e-5)
    _close(got_g, want_g, 1e-4)


def test_face_rain_occlusion_matches_reference():
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=2, seed=0)
    tris = mesh.triangles.astype(np.float32)
    normals = mesh.face_normals.astype(np.float32)
    pts = np.array([ambeovr_capsules([3.5, 2.5, 1.5]).mean(axis=0), [1.0, 4.0, 1.6]], np.float32)
    want = np.asarray(jrt.face_rain_occlusion(jnp.asarray(tris), jnp.asarray(normals), jnp.asarray(pts)))
    got = trt.face_rain_occlusion(_t(tris), _t(normals), _t(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


def test_synthesize_ir_band_energy():
    """Fed one band of the same histogram at a time, both synthesisers put the
    same energy into each capsule's IR. A flat histogram makes the envelope
    constant, and the carriers are normalised to unit power, so the energy
    does not depend on the random carrier: it is the histogram's total."""
    n_bins, bin_dt, n = 126, 0.002, SR // 4
    for b in range(len(BANDS)):
        hist = np.zeros((4, len(BANDS), n_bins), np.float32)
        hist[:, b] = 1e-3 * (1.0 + 0.5 * np.arange(4))[:, None]
        want = np.asarray(jrt.synthesize_ir_from_histogram(
            jax.random.PRNGKey(b), jnp.asarray(hist), jnp.asarray(BANDS), n, bin_dt, sr=SR))
        got = trt.synthesize_ir_from_histogram(
            torch.Generator().manual_seed(b), _t(hist), _t(BANDS), n, bin_dt, sr=SR).numpy()
        assert got.shape == want.shape == (4, n)
        e_got = (got.astype(np.float64) ** 2).sum(-1)
        e_want = (want.astype(np.float64) ** 2).sum(-1)
        np.testing.assert_allclose(e_got, e_want, rtol=0.05)
        np.testing.assert_allclose(e_got, hist[:, b].sum(-1) * n / (bin_dt * SR) / n_bins, rtol=0.05)


def _t30(energy: np.ndarray, bin_dt: float) -> float:
    """T30 (s) of a bin-energy decay from its Schroeder integral: the -5 to
    -35 dB slope, extrapolated to 60 dB."""
    sch = np.cumsum(energy[::-1])[::-1]
    db = 10 * np.log10(np.maximum(sch / sch[0], 1e-30))
    sel = (db <= -5) & (db >= -35)
    slope = np.polyfit(np.arange(len(db))[sel] * bin_dt, db[sel], 1)[0]
    return -60.0 / slope


def test_trace_energy_histogram_statistics():
    """Decimated wavefront tracing on a small nonconvex room with per-face
    rain visibility: per (source, capsule, band) energy within 5 % and T30
    within 10 % of the reference's."""
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=1, seed=0)
    tris = mesh.triangles.astype(np.float32)
    normals = mesh.face_normals.astype(np.float32)
    f = len(tris)
    absorption = np.tile(np.array([[0.10, 0.15, 0.20, 0.30]], np.float32), (f, 1))
    scattering = np.full(f, 0.4, np.float32)
    src = np.array([[1.5, 1.2, 1.4], [5.6, 3.9, 1.1]], np.float32)
    caps = ambeovr_capsules([3.5, 2.5, 1.5]).astype(np.float32)
    centre = caps.mean(axis=0, keepdims=True)
    kw = dict(n_rays=2048, max_depth=30, n_bins=150, bin_dt=0.002, decimate=True)
    occ_j = jrt.face_rain_occlusion(jnp.asarray(tris), jnp.asarray(normals), jnp.asarray(centre))
    want = np.asarray(jrt.trace_energy_histogram_multi(
        jax.random.PRNGKey(0), jnp.asarray(tris), jnp.asarray(absorption), jnp.asarray(scattering),
        jnp.asarray(src), jnp.asarray(caps), n_sources=2, tri_normals=jnp.asarray(normals),
        face_occlusion=occ_j, **kw))
    occ_t = trt.face_rain_occlusion(_t(tris), _t(normals), _t(centre))
    got = trt.trace_energy_histogram_multi(
        torch.Generator().manual_seed(0), _t(tris), _t(absorption), _t(scattering), _t(src), _t(caps),
        tri_normals=_t(normals), face_occlusion=occ_t, **kw).numpy()
    assert got.shape == want.shape == (2, 4, 4, 150)
    np.testing.assert_allclose(got.sum(-1), want.sum(-1), rtol=0.05)
    for e in range(2):
        t_got = _t30(got[e].sum(axis=(0, 1)), 0.002)
        t_want = _t30(want[e].sum(axis=(0, 1)), 0.002)
        assert abs(t_got / t_want - 1) < 0.10, (t_got, t_want)
