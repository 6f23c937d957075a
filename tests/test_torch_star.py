"""The port's exact rain mode against the JAX package: the star any-hit (K6),
the exact-mode trace, the plan path and the entry points that run it.

- `build_star_accel`: the port takes the reference's route decision on a
  numpy copy of its split, so the tile and wide counts are identical, both
  give None in the same cases, and the star's face tree holds exactly the
  faces the reference's tables hold, row for row.
- K6's plain walk equals the reference's K6 (interpret mode) and the dense
  any-hit of both packages, boolean for boolean, from surface hit points
  and from interior points, toward the centroid and toward a capsule inside
  r_pad, and tests under a third of the dense (segment, face) pairs.
- The exact-mode trace: the reference runs its dense any-hit here (its star
  serves TPUs only), the port its star; the direct path within 5e-5 and the
  diffracted path within 1e-4 of the reference's peak, the tail held
  statistically with the omni tolerances (band energies 5 %, T30 10 %).
- The plan path on the reference's own plan (its traced IR banks carried
  over as numpy): stems within 1e-5 of each stem's peak, quantised stems
  within 1 step, the host mix of the same stems within 1e-6 of its peak, the
  scene within 1 LSB at int16; the host "gaussian" bed identical bit for bit.
- `Scene.generate()` with the default engine config (the exact mode) in a
  nonconvex room writes the reference's JSON and DCASE CSV, rendered through
  the star; the CLI's exact mode runs at a tiny size.
"""

import json
import random
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu import Scene as JaxScene
from audiblelight_tpu import utils as jutils
from audiblelight_tpu.ambience import Ambience as JaxAmbience
from audiblelight_tpu.geometry.mesh import scanned_like_room
from audiblelight_tpu.geometry.queries import segments_occluded as jax_segments_occluded
from audiblelight_tpu.ops import star_occlusion as jstar
from audiblelight_tpu.pipeline import mix_plan_host as jax_mix_plan_host
from audiblelight_tpu.pipeline import stems_from_plan as jax_stems_from_plan
from audiblelight_tpu.render import build_scene_plan as jax_build_scene_plan
from audiblelight_tpu.render import render_event_stems_arrays as jax_render_stems
from audiblelight_tpu.rir import raytracer as jrt
from audiblelight_tpu.synthesize import generate_dcase2024_metadata as jax_dcase
from audiblelight_tpu_torch import pipeline, seld
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.ambience import Ambience
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.geometry.mesh import save_obj
from audiblelight_tpu_torch.io.audio import wav_read
from audiblelight_tpu_torch.micarrays import ambeovr_capsules
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.ops import star_occlusion as tstar
from audiblelight_tpu_torch.render import ScenePlan, render_event_stems_arrays
from audiblelight_tpu_torch.rir import raytracer as trt
from test_torch_raytracer import BANDS, SR, _close, _t, _t30

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CENTRE = np.array([3.5, 2.5, 1.5])
TINY = dict(indirect_ray_count=64, indirect_ray_depth=4, max_ir_length=0.1)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement and the host ambience bed draw from the global `random`,
    numpy and torch streams: leave them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


@pytest.fixture(scope="module")
def big_room():
    """The flagship room at one subdivision level less: 27,648 faces, over
    the 16,384 at which the star layout is built."""
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=4, seed=0)
    assert len(mesh.faces) == 27648 and not mesh.is_convex
    return mesh


def _caps_r_pad(caps, centre):
    return float(np.linalg.norm(caps - centre, axis=1).max()) + 0.02


@pytest.mark.parametrize("where,r_pad", [
    ("centroid", 0.02), ("capsules", None), ("off-centre", 0.02), ("too wide", 1.2),
])
def test_build_star_accel_matches_reference(big_room, where, r_pad):
    tris = big_room.triangles.astype(np.float32)
    centre = np.array([1.2, 3.9, 0.7]) if where == "off-centre" else CENTRE
    if r_pad is None:
        r_pad = _caps_r_pad(ambeovr_capsules(centre), centre)
    want = jstar.build_star_accel(tris, centre, r_pad)
    got = tstar.build_star_accel(tris, centre, r_pad, device="cpu")
    if where == "too wide":
        assert want is None and got is None
        return
    assert (got.n_tiles, got.n_wide, got.r_pad) == (want.n_tiles, want.n_wide, want.r_pad)
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(want.center))
    # The star's tree holds the reference's narrow and wide faces, row for
    # row (its walked rows and its always-tested rows together)
    narrow = np.asarray(want.narrow_tab)
    want_rows = np.concatenate([narrow[np.abs(narrow).sum(axis=1) > 0], np.asarray(want.wide_tab)[: want.n_wide]])
    tree = got.tree
    got_rows = torch.cat([tree.bvh.rows[tree.bvh.face >= 0], tree.always])[:, :9].numpy()
    assert got_rows.shape == want_rows.shape and not tree.bvh.rows[tree.bvh.face >= 0][:, 9:].any()
    order = lambda x: x[np.lexsort(x.T[::-1])]  # noqa: E731
    np.testing.assert_array_equal(order(got_rows), order(want_rows))


def test_build_star_accel_none_without_faces():
    empty = np.full((4, 3, 3), 1.0e9, np.float32)
    assert jstar.build_star_accel(empty, CENTRE) is None and tstar.build_star_accel(empty, CENTRE, device="cpu") is None


def _segment_starts(mesh, kind, end, rng, n=3000):
    """Surface hit points moved 1e-4 toward `end`'s side (the tracer's), or
    points scattered through the room's volume."""
    tris = mesh.triangles.astype(np.float32)
    if kind == "interior":
        return rng.uniform([0.05, 0.05, 0.05], [6.95, 4.95, 2.95], (n, 3)).astype(np.float32)
    fi = rng.integers(0, len(tris), n)
    w = rng.dirichlet([1.0, 1.0, 1.0], n).astype(np.float32)
    pts = np.einsum("nk,nkd->nd", w, tris[fi]).astype(np.float32)
    nrm = mesh.face_normals[fi].astype(np.float32)
    nrm = np.where((np.sum(nrm * (end - pts), axis=1) >= 0)[:, None], nrm, -nrm)
    return (pts + np.float32(1e-4) * nrm).astype(np.float32)


@pytest.mark.parametrize("kind", ["surface", "interior"])
def test_star_windows_hold_every_blocker(big_room, kind):
    """The cull's premise on the port's own windows (`star_windows`, which
    the build sorts into tiles and which count the pairs a query needs): a
    narrow face blocks a segment toward the centre only when the start's
    azimuth lies inside the face's window."""
    tris = big_room.triangles.astype(np.float32)
    rows, narrow, cen, half = tstar.star_windows(tris, CENTRE, 0.02)
    assert rows.shape[0] == len(tris) and 0 < int((~narrow).sum()) < 0.35 * len(tris)
    starts = torch.as_tensor(_segment_starts(big_room, kind, CENTRE, np.random.default_rng(5), n=400))
    ends = torch.as_tensor(CENTRE, dtype=torch.float32).expand(400, 3).contiguous()
    o, d, length = ck.segment_inputs(starts, ends)
    tab = ck.mt_face_table(torch.as_tensor(tris[narrow]))
    az = torch.atan2(starts[:, 1] - np.float32(CENTRE[1]), starts[:, 0] - np.float32(CENTRE[0]))
    cen_t, half_t = torch.as_tensor(cen, dtype=torch.float32), torch.as_tensor(half, dtype=torch.float32)
    n_hits = 0
    for f0 in range(0, tab.shape[0], 4096):
        in_tri, t = ck._mt_pair(o, d, tab[f0 : f0 + 4096].T[:, None, :])
        hit = in_tri & (t > 1e-4) & (t < (length - 1e-4)[:, None])
        gap = cen_t[None, f0 : f0 + 4096] - az[:, None]
        gap = gap - 2.0 * np.pi * torch.floor(gap / (2.0 * np.pi) + 0.5)
        assert not (hit & (gap.abs() > half_t[None, f0 : f0 + 4096])).any()
        n_hits += int(hit.sum())
    assert n_hits > 0


@pytest.mark.parametrize("kind", ["surface", "interior"])
@pytest.mark.parametrize("toward", ["centroid", "capsule"])
def test_star_matches_reference_and_dense(big_room, kind, toward):
    """3,000 segments: K6's plain walk, the wrapper on CPU tensors, the
    reference's K6 in interpret mode (3,072 segments in 12 blocks of 256)
    and the dense any-hit of both packages agree on every boolean; the walk
    tests under a third of the dense (segment, face) pairs, and a blocked
    segment's walk ends at its first blocking leaf."""
    tris = big_room.triangles.astype(np.float32)
    caps = ambeovr_capsules(CENTRE).astype(np.float32)
    centre = caps.mean(axis=0)
    if toward == "centroid":
        end, r_pad = centre.astype(np.float32), 0.02
    else:
        end, r_pad = caps[2], _caps_r_pad(caps, centre)
    rng = np.random.default_rng(11 if kind == "surface" else 12)
    starts = _segment_starts(big_room, kind, end, rng)
    ja = jstar.build_star_accel(tris, centre, r_pad)
    ta = tstar.build_star_accel(tris, centre, r_pad, device="cpu")
    want_star = np.asarray(jstar.star_segments_occluded(ja, jnp.asarray(starts), jnp.asarray(end), interpret=True))
    ends = np.broadcast_to(end, starts.shape).copy()
    want_dense = np.asarray(jax_segments_occluded(jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(tris)))
    got_plain = tstar.star_segments_occluded_plain(ta, torch.from_numpy(starts), torch.from_numpy(end)).numpy()
    got = tstar.star_segments_occluded(ta, torch.from_numpy(starts), torch.from_numpy(end)).numpy()
    got_dense = ck.segments_occluded(torch.from_numpy(starts), torch.from_numpy(ends), torch.from_numpy(tris)).numpy()
    for other in (want_star, want_dense, got, got_dense):
        np.testing.assert_array_equal(got_plain, other)
    assert 0.05 < got_plain.mean() < 0.95
    o, d, length = tstar._star_inputs(torch.from_numpy(starts), torch.from_numpy(end))
    assert o.shape == (3000, 3) and torch.equal(length, ck.segment_inputs(torch.from_numpy(starts),
                                                                        torch.from_numpy(ends))[2])
    blocked, visits = ck.any_hit_walk_plain(o, d, length, ta.tree)
    np.testing.assert_array_equal(blocked.numpy(), got_plain)
    tested = visits[:, 1].double() * ck.BVH_LEAF_FACES + ta.tree.always.shape[0]
    print(f"{kind} toward the {toward}: {ta}, pairs tested {float(tested.sum()):.0f} of {3000 * len(tris)} dense, "
          f"{float(visits[:, 0].double().mean()):.1f} box tests per segment")
    assert float(tested.sum()) < len(tris) * 3000 / 3
    assert bool((visits[blocked, 1] >= 1).all())


def _small_room():
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), subdivision_levels=1, seed=0)
    f = len(mesh.faces)
    return (mesh.triangles.astype(np.float32), mesh.face_normals.astype(np.float32),
            np.tile(np.array([[0.10, 0.15, 0.20, 0.30]], np.float32), (f, 1)), np.full(f, 0.4, np.float32))


def test_exact_trace_histogram_statistics():
    """The exact mode's tail in a small nonconvex room (a star built over it
    by hand; the world state builds one from 16,384 faces): per (source,
    capsule, band) energy within 5 % and T30 within 10 % of the reference's
    dense exact-mode trace."""
    tris, normals, absorption, scattering = _small_room()
    src = np.array([[1.5, 1.2, 1.4], [5.6, 3.9, 1.1]], np.float32)
    caps = ambeovr_capsules(CENTRE).astype(np.float32)
    kw = dict(n_rays=2048, max_depth=30, n_bins=150, bin_dt=0.002, decimate=True)
    want = np.asarray(jrt.trace_energy_histogram_multi(
        jax.random.PRNGKey(0), jnp.asarray(tris), jnp.asarray(absorption), jnp.asarray(scattering),
        jnp.asarray(src), jnp.asarray(caps), n_sources=2, tri_normals=jnp.asarray(normals),
        occlusion=True, shared_visibility=True, **kw))
    star = tstar.build_star_accel(tris, caps.mean(axis=0), 0.02, device="cpu")
    assert star is not None
    got = trt.trace_energy_histogram_multi(
        torch.Generator().manual_seed(0), _t(tris), _t(absorption), _t(scattering), _t(src), _t(caps),
        tri_normals=_t(normals), star=star, **kw).numpy()
    assert got.shape == want.shape == (2, 4, 4, 150)
    np.testing.assert_allclose(got.sum(-1), want.sum(-1), rtol=0.05)
    for e in range(2):
        t_got, t_want = _t30(got[e].sum(axis=(0, 1)), 0.002), _t30(want[e].sum(axis=(0, 1)), 0.002)
        assert abs(t_got / t_want - 1) < 0.10, (t_got, t_want)


def test_exact_trace_rirs_direct_and_diffraction(big_room):
    """trace_rirs_multi in the exact mode (the star per capsule, a 64-ray
    tail): the direct and diffracted parts equal the reference's to 5e-5 and
    1e-4 of its peak, so the whole IR less the reference's direct and
    diffracted parts is a tail of the reference's energy, and no sample
    before the first direct arrival differs."""
    tris = big_room.triangles.astype(np.float32)
    lod = big_room.simplified(target_faces=4096).triangles.astype(np.float32)
    caps = ambeovr_capsules(CENTRE).astype(np.float32)
    src = np.array([[1.5, 1.2, 1.4], [5.6, 3.9, 1.1], [0.6, 4.4, 2.0]], np.float32)
    n = SR // 10
    star = tstar.build_star_accel(tris, caps.mean(axis=0), _caps_r_pad(caps, caps.mean(axis=0)), device="cpu")
    f = len(tris)
    absorption = np.tile(np.array([[0.10, 0.15, 0.20, 0.30]], np.float32), (f, 1))
    scattering = np.full(f, 0.4, np.float32)
    got = trt.trace_rirs_multi(
        torch.Generator().manual_seed(3), _t(tris), _t(absorption), _t(scattering), _t(src), _t(caps), n,
        sr=SR, n_rays=64, max_depth=4, star=star, shared_visibility=False, diffraction=True,
        diffraction_order=2, tris_diffraction_graph=_t(lod)).numpy()
    want_d = np.asarray(jrt.direct_paths_ir(jnp.asarray(tris), jnp.asarray(src), jnp.asarray(caps), n, sr=SR))
    want_g = np.asarray(jax.vmap(lambda s: jrt.diffracted_path_ir(
        jnp.asarray(tris), s, jnp.asarray(caps), jnp.asarray(BANDS), n, sr=SR, order=2,
        tris_graph=jnp.asarray(lod)))(jnp.asarray(src)))
    got_d = trt.direct_paths_ir(_t(tris), _t(src), _t(caps), n, sr=SR).numpy()
    got_g = trt.diffracted_path_ir(_t(tris), _t(src), _t(caps), _t(BANDS), n, sr=SR, order=2,
                                   tris_graph=_t(lod)).numpy()
    _close(got_d, want_d, 5e-5)
    _close(got_g, want_g, 1e-4)
    assert got.shape == (4, 3, n) and np.isfinite(got).all()
    tail = got - np.moveaxis(got_d + got_g, 0, 1)
    first = int(np.linalg.norm(src[:, None] - caps[None], axis=-1).min() / 343.0 * SR) - 96
    assert np.abs(tail[..., :first]).max() == 0.0 and np.abs(tail).max() > 0


def _scene(scene_cls, seed_everything, fg, obj, rlr_kwargs, mic="ambeovr", **device):
    seed_everything(7)
    scene = scene_cls(
        duration=8.0, sample_rate=SR, backend="rlr", fg_path=fg, max_overlap=2,
        backend_kwargs=dict(mesh=str(obj), seed=11, add_to_context=False, rlr_kwargs=rlr_kwargs), **device,
    )
    scene.add_microphone(microphone_type=mic)
    for event_type in ("static", "static", "moving"):
        try:
            scene.add_event(event_type=event_type, max_place_attempts=100)
        except ValueError:
            pass
    scene.add_ambience(noise="gaussian")
    return scene


@pytest.fixture(scope="module")
def assets(tmp_path_factory, big_room):
    root = tmp_path_factory.mktemp("star")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    small = save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "small.obj")
    big = save_obj(big_room, root / "big.obj")
    return root, small, big


@pytest.mark.parametrize("noise", ["gaussian", "pink"])
def test_host_ambience_bed_is_the_reference_bed(noise):
    kw = dict(channels=4, duration=2.0, alias="bed", noise=noise, ref_db=-60, sample_rate=SR)
    np.random.seed(123)
    want = JaxAmbience(**kw).load_ambience(normalize=True)
    np.random.seed(123)
    got = Ambience(**kw).load_ambience(normalize=True)
    assert got.dtype == want.dtype and got.shape == (4, 2 * SR)
    np.testing.assert_array_equal(got, want)


def test_plan_path_matches_reference(assets):
    """The reference's plan (its exact-mode trace, host bed) rendered by
    both packages' plan paths."""
    root, small, _ = assets
    want_scene = _scene(JaxScene, jutils.seed_everything, root / "fg", small, TINY)
    np.random.seed(99)
    plan_w = jax_build_scene_plan(want_scene, max_traj=4)
    fields = {k: v if isinstance(v, int) else np.asarray(v) for k, v in vars(plan_w).items()}
    assert fields["static_irs"].shape[-1] == int(0.1 * SR) and np.abs(fields["static_irs"]).max() > 0
    plan_g = ScenePlan.from_numpy(fields, "cpu")
    stem_args = ("static_audio", "static_irs", "static_mask", "static_snr", "static_len", "static_place_len",
                 "moving_audio", "moving_irs", "moving_w", "moving_mask", "moving_snr", "moving_len",
                 "moving_place_len", "ref_db")
    want_stems = np.asarray(jax_render_stems(*(jnp.asarray(fields[k]) for k in stem_args)))
    got_stems = render_event_stems_arrays(*(getattr(plan_g, k) for k in stem_args)).numpy()
    peak = np.abs(want_stems).max(axis=(1, 2), keepdims=True)
    assert (peak > 0).sum() >= 3 and np.all(np.abs(got_stems - want_stems) <= 1e-5 * np.maximum(peak, 1e-30))

    q_w, s_w = jax_stems_from_plan(plan_w)
    q_g, s_g = pipeline.stems_from_plan(plan_g)
    assert np.abs(q_g.numpy().astype(np.int32) - np.asarray(q_w).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(s_g.numpy(), np.asarray(s_w), rtol=1e-5)
    want_mix = jax_mix_plan_host(plan_w, q_w, s_w)
    same_stems = pipeline.mix_plan_host(plan_g, torch.from_numpy(np.array(q_w)), torch.from_numpy(np.array(s_w)))
    assert np.abs(same_stems - want_mix).max() <= 1e-6 * np.abs(want_mix).max()
    got_mix = pipeline.mix_plan_host(plan_g, q_g, s_g)
    to16 = lambda x: (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.int32)  # noqa: E731
    assert np.abs(to16(got_mix) - to16(want_mix)).max() <= 1

    # The port's own plan of the same placed scene carries the same host bed
    got_scene = _scene(PortScene, tutils.seed_everything, root / "fg", small, TINY, device="cpu")
    np.random.seed(99)
    own = pipeline.build_scene_plan(got_scene, max_traj=4, plan_path=True)
    np.testing.assert_array_equal(own.ambience, plan_w.ambience)
    assert own.static_irs.shape == plan_g.static_irs.shape and own.moving_irs.shape == plan_g.moving_irs.shape
    assert float(own.static_irs.abs().max()) > 0


def _canon(d: dict) -> dict:
    d = json.loads(json.dumps(d))
    d.pop("creation_time")
    return d


def test_generate_default_config_runs_the_star(assets, tmp_path):
    """`Scene.generate()` with the default engine config (no mesh
    simplification, so the exact rain mode) in the 27,648-face room: the
    classic render traces it through the star, and the JSON and DCASE CSV
    are the reference's."""
    root, _, big = assets
    want = _scene(JaxScene, jutils.seed_everything, root / "fg", big, TINY)
    got = _scene(PortScene, tutils.seed_everything, root / "fg", big, TINY, device="cpu")
    assert got.state.cfg["mesh_simplification"] is False and got.state._rain_mode() == "exact"
    got.generate(output_dir=tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "audio_out_mic000.wav", "metadata_out.json", "metadata_out_mic000.csv"]
    data, sr = wav_read(tmp_path / "audio_out_mic000.wav")
    assert sr == SR and data.shape == (4, 8 * SR) and np.abs(data).max() > 100 / 32768
    stars = list(got.state.device_state._star_cache.values())
    assert len(stars) == 1 and isinstance(stars[0], tstar.StarAccel)
    # A trace refreshes the emitters' coordinates relative to the mics, as
    # the reference's trace does
    want.state._update()
    assert _canon(json.loads((tmp_path / "metadata_out.json").read_text())) == _canon(want.to_dict())
    text = jax_dcase(want)["mic000"].to_csv(sep=",", encoding="utf-8", header=None)
    assert (tmp_path / "metadata_out_mic000.csv").read_text() == text


def test_generate_compiled_takes_the_plan_path(assets, tmp_path):
    """`compiled=True` renders a face-mode scene through the plan path: a
    float mix written as the same int16 WAV layout."""
    root, small, _ = assets
    got = _scene(PortScene, tutils.seed_everything, root / "fg", small, dict(TINY, mesh_simplification=True),
                 device="cpu")
    got.generate(output_dir=tmp_path, compiled=True)
    assert got.audio["mic000"].dtype == np.float32 and got.audio["mic000"].shape == (4, 8 * SR)
    data, _ = wav_read(tmp_path / "audio_out_mic000.wav")
    assert np.abs(data).max() > 100 / 32768


def test_cli_exact_mode(assets):
    """The SELD CLI with --no-mesh-simplification on the CPU at a tiny size
    in the 27,648-face room: the reference's file layout, WAVs with sound."""
    root, _, big = assets
    out = root / "cli_exact"
    seconds = seld.main(["--fg-dir", str(root / "fg"), "--output-dir", str(out), "--backend", "rlr",
                         "--mesh", str(big), "--channel-layout", "mic", "--n-scenes", "1", "--train-frac", "1",
                         "--duration", "4", "--rays", "64", "--ray-depth", "3", "--ir-seconds", "0.1",
                         "--max-events-static", "2", "--max-events-moving", "0", "--no-mesh-simplification",
                         "--seed", "3", "--device", "cpu"])
    assert len(seconds) == 1
    stem = "dev-train-alight/fold1_scene1_000"
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) == sorted(
        [f"mic_dev/{stem}_mic000.wav", f"metadata_dev/{stem}.json", f"metadata_dev/{stem}_mic000.csv"])
    data, sr = wav_read(out / f"mic_dev/{stem}_mic000.wav")
    assert sr == 24000 and data.shape == (4, 4 * 24000) and np.abs(data).max() > 100 / 32768
