"""The port's single-source tracer entries (rir/raytracer.py
`trace_energy_histogram`, `direct_path_ir`, `trace_rirs`) against the JAX
package's, in its small box room and a small scanned room.

- `trace_rirs` is `trace_rirs_multi` with one source: equal bit for bit on
  the same generator (omni, FOA, binaural, transmission on).
- `direct_path_ir` is deterministic: within 5e-5 of the reference's peak,
  the bound of tests/test_torch_raytracer.py (f32 transcendentals differ in
  the last bit between the packages).
- The stochastic parts draw from a torch.Generator where the reference
  draws threefry bits, so they are held statistically. The histogram's
  per-band energy (W for FOA) within 5 % and its T30 within 10 %, as in
  tests/test_torch_raytracer.py; the seed-to-seed spread of either package
  is ~1 % there. The IRs' per-band energy (the tracer's four bands, from
  the spectrum, summed over channels; W for FOA) within 5 %, each side the
  mean of eight seeds: one IR's noise carriers move its band energies by
  1-5 % from seed to seed, so the mean's standard error is under 2 % and
  5 % is over 2.5 standard errors of the difference of the means.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.geometry.mesh import box_mesh, scanned_like_room
from audiblelight_tpu.rir import raytracer as jrt
from audiblelight_tpu_torch.micarrays import ambeovr_capsules
from audiblelight_tpu_torch.rir import raytracer as trt

torch.set_num_threads(1)

SR = 24000
N_SAMPLES = 6000  # 0.25 s
SEEDS = 8


def _room(kind: str):
    mesh = (box_mesh(extents=[6.0, 4.0, 3.0], center=[3.0, 2.0, 1.5]) if kind == "box"
            else scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=1, seed=0))
    return mesh.triangles.astype(np.float32), mesh.face_normals.astype(np.float32)


# name: (room, encoding, listener centre, transmission)
CASES = {
    "box-omni": ("box", "omni", [4.0, 2.5, 1.5], False),
    "scanned-foa": ("scanned", "foa", [3.5, 2.5, 1.5], False),
    "box-binaural": ("box", "binaural", [4.0, 2.5, 1.5], False),
    "scanned-transmission": ("scanned", "omni", [3.5, 2.5, 1.5], True),
}
SRC = np.array([1.5, 1.2, 1.4], np.float32)


def _inputs(name: str, absorption=(0.10, 0.15, 0.20, 0.30)) -> tuple:
    """(arrays, keywords) of a case, numpy: the reference's argument order
    and keyword names. The scanned room traces with the per-face rain table
    toward the rig's centre, the box with one dense query per hit point."""
    kind, encoding, centre, transmission = CASES[name]
    tris, normals = _room(kind)
    f = len(tris)
    lis = (ambeovr_capsules(centre) if encoding == "omni" else np.array([centre])).astype(np.float32)
    arrays = (tris, np.tile(np.array([absorption], np.float32), (f, 1)), np.full(f, 0.4, np.float32), SRC, lis)
    kw = dict(encoding=encoding, tri_normals=normals, decimate=True, n_rays=2048, max_depth=30, bin_dt=0.002)
    if transmission:
        kw.update(transmission=True, face_transmission=np.full((f, 4), 0.1, np.float32))
    if kind == "scanned":
        occ = np.asarray(jrt.face_rain_occlusion(jnp.asarray(tris), jnp.asarray(normals),
                                                 jnp.asarray(lis.mean(axis=0, keepdims=True))))
        kw["face_occlusion"] = occ
    return arrays, kw


def _jax(arrays, kw):
    return [jnp.asarray(a) for a in arrays], {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                             for k, v in kw.items()}


def _torch(arrays, kw):
    return [torch.tensor(a) for a in arrays], {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
                                               for k, v in kw.items()}


def _t30(energy: np.ndarray, bin_dt: float) -> float:
    """T30 (s) of a bin-energy decay from its Schroeder integral."""
    sch = np.cumsum(energy[::-1])[::-1]
    db = 10 * np.log10(np.maximum(sch / sch[0], 1e-30))
    sel = (db <= -5) & (db >= -35)
    return -60.0 / np.polyfit(np.arange(len(db))[sel] * bin_dt, db[sel], 1)[0]


def _band_energy(irs: np.ndarray) -> np.ndarray:
    """(4,) energy of (C, n) IRs in the tracer's four bands (edges at the
    geometric midpoints of 125, 500, 2000 and 8000 Hz), summed over C."""
    spec = np.abs(np.fft.rfft(irs.astype(np.float64), axis=-1)) ** 2
    f = np.fft.rfftfreq(irs.shape[-1], 1.0 / SR)
    edges = [0.0, 250.0, 1000.0, 4000.0, SR]
    return np.array([spec[:, (f >= lo) & (f < hi)].sum() for lo, hi in zip(edges[:-1], edges[1:])])


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_rirs_is_the_multi_trace_of_one_source(name):
    arrays, kw = _inputs(name)
    targs, tkw = _torch(arrays, kw)
    got = trt.trace_rirs(torch.Generator().manual_seed(3), *targs, N_SAMPLES, sr=SR, **tkw)
    occ = tkw.pop("face_occlusion", None)
    want = trt.trace_rirs_multi(torch.Generator().manual_seed(3), *targs[:3], targs[3][None], targs[4], N_SAMPLES,
                                sr=SR, face_occlusion=occ, occlusion=True, **tkw)[:, 0]
    assert got.shape == want.shape == ((4, N_SAMPLES) if kw["encoding"] != "binaural" else (2, N_SAMPLES))
    assert torch.equal(got, want)
    if name == "box-omni":  # an int seed is a generator on the tensors' device seeded with it
        assert torch.equal(trt.trace_rirs(3, *targs, N_SAMPLES, sr=SR, **tkw), want)


@pytest.mark.parametrize("room", ["box", "scanned"])
@pytest.mark.parametrize("encoding", ["omni", "foa", "binaural"])
def test_direct_path_ir_matches_reference(room, encoding):
    tris, _ = _room(room)
    n = SR // 8
    centre = [3.5, 2.5, 1.5]
    lis = (ambeovr_capsules(centre) if encoding == "omni" else np.array([centre])).astype(np.float32)
    for src in ([1.5, 1.2, 1.4], [5.6, 3.9, 1.1], [1.0, 4.0, 2.2]):
        src = np.asarray(src, np.float32)
        want = np.asarray(jrt.direct_path_ir(jnp.asarray(tris), jnp.asarray(src), jnp.asarray(lis), n, sr=SR,
                                             encoding=encoding))
        got = trt.direct_path_ir(tris, src, lis, n, sr=SR, encoding=encoding, device="cpu").numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 5e-5 * np.abs(want).max()


def test_entries_map_the_reference_keywords():
    """`accel` takes the mesh's trees (a MeshDeviceState), `mesh_tiles` K7's
    route (its tree or the reference's layout); `face_chunk` and a grid
    have no counterpart and raise; without a card the default device
    raises rather than running on the CPU."""
    from audiblelight_tpu_torch.geometry.mesh import scanned_like_room as t_room
    from audiblelight_tpu_torch.ops.tiled_first_hit import build_mesh_tiles, build_tiled_tree
    from audiblelight_tpu_torch.worldstate.mesh_backend import MeshDeviceState

    mesh = t_room(extents=(7.0, 5.0, 3.0), subdivision_levels=1, seed=0)
    st = MeshDeviceState.from_mesh(mesh, dict(frequency_bands=4), device="cpu")
    lis = torch.tensor([[3.5, 2.5, 1.5]])
    src = torch.tensor([1.5, 1.2, 1.4])
    args = (st.acoustic_tris, st.absorption, st.scattering, src, lis)
    kw = dict(n_rays=256, max_depth=6, n_bins=40, encoding="foa")
    plain = trt.trace_energy_histogram(5, *args, **kw)
    assert plain.shape == (4, 4, 40)
    assert torch.equal(trt.trace_energy_histogram(5, *args, accel=st, **kw), plain)
    tiled = trt.trace_energy_histogram(5, *args, mesh_tiles=build_tiled_tree(st.acoustic_tris, device="cpu"), **kw)
    layout = trt.trace_energy_histogram(5, *args, mesh_tiles=build_mesh_tiles(mesh.triangles, device="cpu"), **kw)
    assert torch.equal(tiled, layout) and tiled.shape == plain.shape
    direct = trt.direct_path_ir(st.tris, src, lis, 2400, sr=SR, encoding="foa")
    assert torch.equal(trt.direct_path_ir(st.tris, src, lis, 2400, sr=SR, encoding="foa", accel=st), direct)
    with pytest.raises(TypeError, match="face_chunk"):
        trt.trace_energy_histogram(5, *args, 256, 6, 40, 0.002, 343.0, "foa", 4096)
    with pytest.raises(TypeError, match="no grid"):
        trt.trace_rirs(5, *args, 2400, accel=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trt.direct_path_ir(mesh.triangles, src.numpy(), lis.numpy(), 2400)


@pytest.mark.parametrize("name", sorted(CASES))
def test_histogram_and_irs_match_reference_statistics(name):
    """One trace_energy_histogram per package (per-band energy within 5 %,
    T30 within 10 %), then, in the box (a scanned-room trace takes ~2 s on
    the CPU), the band energies of eight trace_rirs each."""
    arrays, kw = _inputs(name)
    jargs, jkw = _jax(arrays, kw)
    targs, tkw = _torch(arrays, kw)
    n_bins = int(np.ceil(N_SAMPLES / SR / kw["bin_dt"])) + 1
    want_h = np.asarray(jrt.trace_energy_histogram(jax.random.PRNGKey(0), *jargs, n_bins=n_bins, **jkw))
    got_h = trt.trace_energy_histogram(torch.Generator().manual_seed(0), *targs, n_bins=n_bins, **tkw).numpy()
    assert got_h.shape == want_h.shape
    chans = [0] if kw["encoding"] == "foa" else slice(None)  # FOA: the W channel carries the energy
    np.testing.assert_allclose(got_h[chans].sum(-1), want_h[chans].sum(-1), rtol=0.05)
    t_got, t_want = _t30(got_h[chans].sum(axis=(0, 1)), 0.002), _t30(want_h[chans].sum(axis=(0, 1)), 0.002)
    assert abs(t_got / t_want - 1) < 0.10, (t_got, t_want)
    if CASES[name][0] != "box":
        return
    e_want = np.mean([_band_energy(np.asarray(jrt.trace_rirs(jax.random.PRNGKey(s), *jargs, N_SAMPLES, sr=SR,
                                                             **jkw))[chans]) for s in range(SEEDS)], axis=0)
    e_got = np.mean([_band_energy(trt.trace_rirs(torch.Generator().manual_seed(s), *targs, N_SAMPLES, sr=SR,
                                                 **tkw).numpy()[chans]) for s in range(SEEDS)], axis=0)
    np.testing.assert_allclose(e_got, e_want, rtol=0.05)
