"""The port's rigs of the Eigenmike and mono families (micarrays.py) against
the JAX package's, on both backends.

The capsule tables, names and layouts of MonoCapsule, Eigenmike32,
Eigenmike64 and a rig from `dynamically_define_micarray` are identical, as
are the name lookup and the mono capsule that None stands for. On the
shoebox an Eigenmike32's IRs are held within 1e-4 of the reference's peak
(tests/test_torch_image_source.py says why not 1e-5). On rlr a tiny
Eigenmike32 scene renders its 32 channels, and its exact direct path at the 32
capsules is held within 5e-5 of the reference's peak (the tolerance of
tests/test_torch_raytracer.py); 1, 32 and 64 capsules render through the
fused renderer, the plan path and the classic render; and K3's plain version at 32 and 64
capsules is held to the interpret-mode Pallas K3 on the same inputs (bins
identical, sums within 1e-6 of the histogram's peak, as
tests/test_torch_kernels.py holds it).
"""

import random
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu import micarrays as jmic
from audiblelight_tpu.ops.pallas_kernels import deposit_histogram_pallas
from audiblelight_tpu.rir import raytracer as jrt
from audiblelight_tpu.worldstate.shoebox_backend import WorldStateShoebox as JaxShoebox
from audiblelight_tpu_torch import micarrays as tmic
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene, write_outputs
from audiblelight_tpu_torch.geometry.mesh import save_obj, scanned_like_room
from audiblelight_tpu_torch.io.audio import wav_read
from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.pipeline import render_scenes_pipelined
from audiblelight_tpu_torch.rir import raytracer as trt
from audiblelight_tpu_torch.worldstate.shoebox_backend import WorldStateShoebox
from test_torch_cuda import deposit_inputs

torch.set_num_threads(1)

SR = 24000
REPO = Path(__file__).resolve().parents[1]
RIGS = ("MonoCapsule", "Eigenmike32", "Eigenmike64")


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them, so the test files that run after it in
    the same process draw what they would have drawn without it."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


def _placed(mic):
    mic.set_absolute_coordinates(np.array([2.0, 1.5, 1.2]))
    return mic


@pytest.mark.parametrize("rig", RIGS)
def test_rig_geometry_and_dict_identical(rig):
    got, want = _placed(getattr(tmic, rig)()), _placed(getattr(jmic, rig)())
    assert got.to_dict() == want.to_dict()
    assert (got.name, got.capsule_names, got.n_capsules, got.n_channels, got.channel_layout_type) == (
        want.name, want.capsule_names, want.n_capsules, want.n_channels, want.channel_layout_type)
    assert got.n_capsules == {"MonoCapsule": 1, "Eigenmike32": 32, "Eigenmike64": 64}[rig]
    np.testing.assert_array_equal(got.coordinates_absolute, want.coordinates_absolute)
    assert tmic.MicArray.from_dict(want.to_dict()) == got


@pytest.mark.parametrize("coords", ["coordinates_cartesian", "coordinates_polar"])
def test_dynamic_rig_identical(coords):
    """A rig defined at run time, by Cartesian or polar capsules, and one
    loaded from a dict whose type neither package knows."""
    table = np.array([[0.1, 0.0, 0.0], [0.0, 0.1, 0.0], [0.0, 0.0, 0.1]]) if coords == "coordinates_cartesian" \
        else np.array([[0.0, 0.0, 0.05], [90.0, 0.0, 0.05], [0.0, 90.0, 0.05]])
    kw = {coords: table, "name": "tri", "micarray_type": "TriRig"}
    got, want = _placed(tmic.dynamically_define_micarray(**kw)()), _placed(jmic.dynamically_define_micarray(**kw)())
    assert type(got).__name__ == type(want).__name__ == "TriRig"
    assert got.to_dict() == want.to_dict()
    assert got.capsule_names == ["capsule000", "capsule001", "capsule002"]
    loaded = tmic.MicArray.from_dict(want.to_dict())
    assert type(loaded).__name__ == "TriRig" and loaded.to_dict() == want.to_dict()


def test_name_lookup_and_none_match_reference():
    assert [m().name for m in tmic.MICARRAY_LIST] == [m().name for m in jmic.MICARRAY_LIST]
    for mic in jmic.MICARRAY_LIST:
        assert tmic.get_micarray_from_string(mic().name).__name__ == mic.__name__
        assert tmic.sanitize_microphone_input(mic().name).__name__ == mic.__name__
    assert tmic.sanitize_microphone_input(None) is tmic.MonoCapsule
    assert jmic.sanitize_microphone_input(None) is jmic.MonoCapsule
    with pytest.raises(ValueError, match="Cannot find array"):
        tmic.get_micarray_from_string("eigenmike16")


def test_eigenmike32_shoebox_irs_match_reference():
    states = []
    for cls, kw in ((WorldStateShoebox, dict(device="cpu")), (JaxShoebox, {})):
        ws = cls(dimensions=[5.0, 4.0, 3.0], sample_rate=SR, max_order=2, max_ir_length=0.08, seed=3, **kw)
        ws.add_microphone(microphone_type="eigenmike32", position=[2.5, 2.0, 1.5], alias="em")
        ws.add_emitters(n_emitters=2, keep_existing=True)
        ws.simulate()
        states.append(ws)
    got, want = states[0].irs["em"].numpy(), np.asarray(states[1].irs["em"])
    assert got.shape == want.shape == (32, 2, int(0.08 * SR))
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"Eigenmike32 shoebox IRs: max |diff| / peak {gap:.2e}")
    assert gap <= 1e-4


@pytest.fixture(scope="module")
def rlr_assets(tmp_path_factory):
    """The repo's WAVs and a nonconvex 6 x 4 x 3 m room as an OBJ."""
    root = tmp_path_factory.mktemp("rigs")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    obj = save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0), root / "room.obj")
    return root, obj


def _rlr_scene(rlr_assets, mic: str):
    """A tiny rlr scene: two static events and one moving, 64 rays x 4
    bounces, 0.1 s IRs, gaussian ambience."""
    root, obj = rlr_assets
    tutils.seed_everything(3)
    scene = Scene(duration=4.0, sample_rate=SR, backend="rlr", fg_path=root / "fg", max_overlap=3, device="cpu",
                  backend_kwargs=dict(mesh=str(obj), seed=5, add_to_context=False,
                                      rlr_kwargs=dict(indirect_ray_count=64, indirect_ray_depth=4,
                                                      max_ir_length=0.1, mesh_simplification=True)))
    scene.add_microphone(microphone_type=mic)
    for event_type in ("static", "static", "moving"):
        scene.add_event(event_type=event_type, max_place_attempts=100)
    scene.add_ambience(noise="gaussian")
    return scene


def _render_fused(scene, out: Path) -> None:
    """The fused renderer (`render_scenes_pipelined`, the SELD CLI's rlr path) and the
    scene's files, as `generate()` wrote them before it took the classic
    render."""
    render_scenes_pipelined([scene], lambda s, payloads: setattr(s, "audio", payloads))
    write_outputs(scene, out / "audio_out", out / "metadata_out")


RIG_PATHS = [("monocapsule", "fused"), ("monocapsule", "plan"), ("eigenmike32", "plan"), ("eigenmike64", "fused"),
             ("monocapsule", "classic"), ("eigenmike32", "classic"), ("eigenmike64", "classic")]


# The fused and plan cases keep their ids from when `generate(compiled=False)` took the fused renderer
RIG_IDS = [f"{mic}-{dict(fused=False, plan=True).get(path, path)}" for mic, path in RIG_PATHS]


@pytest.mark.parametrize("mic,path", RIG_PATHS, ids=RIG_IDS)
def test_rlr_rig_scene_renders_every_capsule(rlr_assets, tmp_path, mic, path):
    """1, 32 and 64 omni capsules through the fused renderer, the plan path
    and the classic render (`generate()`'s default): one int16 channel per
    capsule, with sound; on the classic render every event's spatial audio
    has the rig's channels."""
    scene = _rlr_scene(rlr_assets, mic)
    if path == "fused":
        _render_fused(scene, tmp_path)
    else:
        scene.generate(output_dir=tmp_path, compiled=path == "plan")
    data, sr = wav_read(tmp_path / "audio_out_mic000.wav")
    n = {"monocapsule": 1, "eigenmike32": 32, "eigenmike64": 64}[mic]
    assert sr == SR and data.shape == (n, 4 * SR) and np.abs(data).max() > 100 / 32768
    for event in scene.events.values() if path == "classic" else ():
        audio = event.spatial_audio["mic000"]
        assert audio.shape[0] == n and np.isfinite(audio).all() and np.abs(audio).max() > 0


def test_eigenmike32_rlr_scene_and_direct_path(rlr_assets, tmp_path):
    """The fused renderer writes all 32 capsules' channels; the exact direct
    path at the 32 capsules against the reference's."""
    scene = _rlr_scene(rlr_assets, "eigenmike32")
    _render_fused(scene, tmp_path)
    data, sr = wav_read(tmp_path / "audio_out_mic000.wav")
    assert sr == SR and data.shape == (32, 4 * SR) and np.abs(data).max() > 100 / 32768
    irs = scene.state.trace_irs_device()["mic000"]
    assert tuple(irs.shape) == (32, scene.state.num_emitters, int(0.1 * SR)) and bool(torch.isfinite(irs).all())
    tris = scene.state.mesh.triangles.astype(np.float32)
    src = scene.state._emitter_positions().astype(np.float32)
    caps = scene.state.microphones["mic000"].coordinates_absolute.astype(np.float32)
    want = np.asarray(jrt.direct_paths_ir(jnp.asarray(tris), jnp.asarray(src), jnp.asarray(caps), 2400, sr=SR))
    got = trt.direct_paths_ir(torch.from_numpy(tris), torch.from_numpy(src), torch.from_numpy(caps), 2400, sr=SR)
    assert want.shape == tuple(got.shape) == (len(src), 32, 2400) and np.abs(want).max() > 0
    assert np.abs(got.numpy() - want).max() <= 5e-5 * np.abs(want).max()


@pytest.mark.parametrize("n_caps", [32, 64])
def test_deposit_histogram_at_eigenmike_widths_matches_pallas(n_caps):
    """K3's plain version with 32 and 64 capsules (groups of 3 sources x
    capsules) against the interpret-mode Pallas K3, arrivals spread and
    crowded."""
    rng = np.random.default_rng(n_caps)
    for dist_max in (30.0, (10.0, 30.0)):
        args = deposit_inputs(rng, 3, 64, n_caps, 4, dist_max)
        kw = dict(n_sources=3, n_bins=101, bin_dt=0.002, c_sound=343.0)
        want = np.asarray(deposit_histogram_pallas(*map(jnp.asarray, args), interpret=True, **kw))
        got = ck.deposit_histogram(*map(torch.from_numpy, args), **kw).numpy()
        assert got.shape == want.shape == (3, n_caps, 4, 101)
        np.testing.assert_array_equal(got != 0, want != 0)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    warps, cluster = ck.deposit_histogram_shape(16 * n_caps, 1, 4, 501, True)
    assert 1 <= warps <= 8 and cluster == 1  # 512 or 1,024 groups fill the card without clusters
