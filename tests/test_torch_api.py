"""The port's public API against the JAX package's.

- The front door: `from audiblelight_tpu_torch import Scene, ...` and the
  subpackages' `__all__` (ops, rir, geometry, io) equal to the reference's
  but for the listed renames; importing every module of the port, in a
  fresh process, leaves `jax` and the reference out of `sys.modules`, opens
  no CUDA context and builds no kernel.
- Parity: every public name of every module of `audiblelight_tpu` (its
  top-level functions, classes, constants and public methods, and its
  `__all__`) has a counterpart in the port's module, but for the names on
  the exception list, which must equal the list in ROADMAP.md and hold only
  names that exist in the reference and are missing from the port.
- The helpers added for parity (TriMesh.sample_surface and scaled,
  WorldStateRLR.create_scene and create_plot, the four ops.scaling
  functions, the utils helpers, the config constants) against the
  reference's: sample_surface draws the same points from the same seed,
  the rest agree within 1e-6.
"""

import ast
import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
REF_DIR = REPO / "audiblelight_tpu"

# Reference module -> port module, where the port renamed it
MODULE_RENAMES = {"ops.pallas_kernels": "ops.cuda_kernels", "ops.fx_jax": "ops.fx_torch"}
# (reference module, name) -> the port's name, where the port renamed it
NAME_RENAMES = {
    ("ops", "powerlaw_psd_gaussian_jax"): "powerlaw_psd_gaussian",
    ("ops.noise", "powerlaw_psd_gaussian_jax"): "powerlaw_psd_gaussian",
    ("profiling", "xla_trace"): "torch_trace",
    ("ops.pallas_kernels", "ray_first_hit_pallas"): "ray_first_hit",
    ("ops.pallas_kernels", "segments_occluded_pallas"): "segments_occluded",
    ("ops.pallas_kernels", "bin_histogram_pallas"): "bin_histogram",
    ("ops.pallas_kernels", "deposit_histogram_pallas"): "deposit_histogram",
    ("ops.pallas_kernels", "deposit_histogram_foa_pallas"): "deposit_histogram_foa",
}
PACKAGES = ["", "ops", "rir", "geometry", "io"]
FRONT_DOOR = ["Scene", "Event", "Ambience", "MicArray", "WorldState", "__version__"]


def _targets(t):
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _targets(e)


def reference_public_names(path: Path) -> set:
    """A module's public names: its top-level functions, classes and
    assigned names, its public classes' public methods ("Class.method"),
    and its `__all__`."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{b.name}" for b in node.body
                           if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) and not b.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                for name in _targets(t):
                    if name == "__all__":
                        out.update(ast.literal_eval(node.value))
                    elif not name.startswith("_"):
                        out.add(name)
    return out


def reference_modules() -> dict:
    """Dotted module name relative to the package ("" for the package) -> file."""
    mods = {}
    for path in sorted(REF_DIR.rglob("*.py")):
        parts = path.relative_to(REF_DIR).with_suffix("").parts
        mods[".".join(parts[:-1] if parts[-1] == "__init__" else parts)] = path
    return mods


def roadmap_exceptions() -> set:
    """The names listed under ROADMAP.md's heading of the JAX package's
    names without a counterpart: each bullet's first backquoted name."""
    text = (REPO / "ROADMAP.md").read_text()
    section = text.split("#### Names of the JAX package without a counterpart in the port", 1)[1]
    section = re.split(r"\n#{2,4} ", section, maxsplit=1)[0]
    return set(re.findall(r"^- `([\w.]+)`", section, flags=re.M))


# Every reference name without a counterpart, each with its reason in ROADMAP.md
EXCEPTIONS = {
    "custom_types",
    "download_data",
    "geometry.grid",
    "config.USE_PALLAS_RAYCAST",
    "config.MESH_AXIS_SCENE",
    "config.MESH_AXIS_TIME",
    "geometry.queries.pad_triangles",
    "ops.pallas_kernels.pallas_supported",
    "ops.pallas_kernels.LANES",
    "ops.pallas_kernels.RAY_BLOCK",
    "ops.pallas_kernels.BIG_LANES",
    "ops.pallas_kernels.FACE_GROUP",
    "ops.pallas_kernels.FACE_TILE",
    "ops.pallas_kernels.SMALL_LANES",
    "ops.pallas_kernels.SMALL_ROWS",
    "ops.pallas_kernels.HIST_RAY_BLOCK",
    "ops.pallas_kernels.HIST_GROUP_BLOCK",
    "ops.mxu_first_hit.MXU_R_BLOCK",
    "ops.pair_first_hit.FACE_GROUP",
    "ops.sorted_first_hit.FACE_GROUP",
    "ops.sorted_first_hit.SFH_LANES",
    "ops.sorted_first_hit.AZ_BINS",
    "ops.sorted_first_hit.EL_BINS",
    "ops.sorted_first_hit.CELL_BITS",
    "ops.star_occlusion.FACE_GROUP",
    "ops.star_occlusion.STAR_LANES",
    "ops.tiled_first_hit.FACE_GROUP",
    "ops.tiled_first_hit.FH_LANES",
    "ops.tiled_first_hit.DONE_CHECK_EVERY",
    "ops.convolve.tv_convolve_spec_from_parts",
    "ops.stft.istft_overlap_add_from_parts",
    "pipeline.FusedSceneRenderer.plan_args",
    "render.ScenePlan.tree_flatten",
    "rir.hrtf.HRTFSet.tree_flatten",
    "rir.hrtf.HRTFSet.tree_unflatten",
    "utils.rng_key",
    "utils.ensure_native_lib",
    "worldstate.mesh_backend.WorldStateRLR.tris_device",
    "worldstate.mesh_backend.WorldStateRLR.acoustic_tris_device",
    "worldstate.mesh_backend.WorldStateRLR.face_props_device",
    "worldstate.mesh_backend.WorldStateRLR.grid_accel",
}


def _port_module(ref_mod: str):
    mod = MODULE_RENAMES.get(ref_mod, ref_mod)
    return importlib.import_module("audiblelight_tpu_torch" + (f".{mod}" if mod else ""))


def _has(obj, dotted: str) -> bool:
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def test_front_door_fresh_process():
    """In a fresh process: the reference's first line on the port, every
    subpackage's reference `__all__`, then every module of the port; no
    `jax`, no reference module, no CUDA context, no kernel built."""
    code = f"""
import importlib, json, pkgutil, sys
import torch
from audiblelight_tpu_torch import {", ".join(FRONT_DOOR)}
names = {json.dumps({p: getattr(importlib.import_module("audiblelight_tpu" + (f".{p}" if p else "")), "__all__")
                     for p in PACKAGES})}
renames = {{"powerlaw_psd_gaussian_jax": "powerlaw_psd_gaussian"}}
for pkg, alls in names.items():
    mod = importlib.import_module("audiblelight_tpu_torch" + ("." + pkg if pkg else ""))
    for name in alls:
        getattr(mod, renames.get(name, name))
import audiblelight_tpu_torch
for info in pkgutil.walk_packages(audiblelight_tpu_torch.__path__, "audiblelight_tpu_torch."):
    importlib.import_module(info.name)
from audiblelight_tpu_torch.ops import build
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "audiblelight_tpu"
             or m.startswith("audiblelight_tpu."))
print(json.dumps(dict(version=__version__, bad=bad, cuda=torch.cuda.is_initialized(), built=sorted(build._LOADED))))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env,
                         cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == dict(version="0.1.0", bad=[], cuda=False, built=[])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_all_matches_reference(pkg):
    ref = importlib.import_module("audiblelight_tpu" + (f".{pkg}" if pkg else ""))
    port = importlib.import_module("audiblelight_tpu_torch" + (f".{pkg}" if pkg else ""))
    want = [NAME_RENAMES.get((pkg, n), n) for n in ref.__all__]
    assert port.__all__ == want
    for name in want:
        assert hasattr(port, name), name
    assert port.__version__ == ref.__version__ if pkg == "" else True


def test_every_reference_name_has_a_counterpart():
    missing, stale = [], []
    for ref_mod, path in reference_modules().items():
        if ref_mod in EXCEPTIONS:
            continue
        port = _port_module(ref_mod)
        port_all = set(getattr(port, "__all__", ()))
        ref_all = None
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__"
                                                    for t in node.targets):
                ref_all = ast.literal_eval(node.value)
        for name in sorted(reference_public_names(path)):
            qual = f"{ref_mod}.{name}" if ref_mod else name
            port_name = NAME_RENAMES.get((ref_mod, name), name)
            if qual in EXCEPTIONS:
                (stale if _has(port, port_name) else []).append(qual)
                continue
            if not _has(port, port_name):
                missing.append(qual)
            elif ref_all is not None and name in ref_all and port_name not in port_all:
                missing.append(f"{qual} (not in the port's __all__)")
    assert missing == [], missing
    assert stale == [], f"listed as exceptions but present in the port: {stale}"
    # Every exception names a real module or public name of the reference
    mods = reference_modules()
    for qual in EXCEPTIONS:
        if qual in mods:
            continue
        mod = max((m for m in mods if m and qual.startswith(m + ".")), key=len)
        assert qual[len(mod) + 1:] in reference_public_names(mods[mod]), qual


def test_exception_list_is_roadmaps():
    assert roadmap_exceptions() == EXCEPTIONS


def test_trimesh_sample_surface_and_scaled():
    from audiblelight_tpu.geometry.mesh import scanned_like_room as j_room
    from audiblelight_tpu_torch.geometry.mesh import scanned_like_room as t_room

    jm, tm = j_room(subdivision_levels=1, seed=3), t_room(subdivision_levels=1, seed=3)
    want = jm.sample_surface(500, np.random.default_rng(11))
    got = tm.sample_surface(500, np.random.default_rng(11))
    np.testing.assert_array_equal(got, want)
    js, ts = jm.scaled(0.001), tm.scaled(0.001)
    np.testing.assert_allclose(ts.vertices, js.vertices, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ts.faces, js.faces)
    assert ts.metadata == js.metadata and ts.faces is not tm.faces


def _rlr_states():
    from audiblelight_tpu.geometry.mesh import box_mesh as j_box
    from audiblelight_tpu.worldstate import WorldStateRLR as JState
    from audiblelight_tpu_torch.geometry.mesh import box_mesh as t_box
    from audiblelight_tpu_torch.worldstate import WorldStateRLR as TState

    states = (JState(j_box(extents=[6.0, 4.0, 3.0], center=[3.0, 2.0, 1.5]), seed=1),
              TState(t_box(extents=[6.0, 4.0, 3.0], center=[3.0, 2.0, 1.5]), seed=1, device="cpu"))
    for st in states:
        st.add_microphone(microphone_type="ambeovr", position=[3.0, 2.0, 1.5], alias="mic")
        st.add_emitter(position=[1.0, 1.0, 1.0], alias="a")
        st.add_emitter(position=[5.0, 3.0, 2.0], alias="b", keep_existing=True)
    return states


def test_create_scene_matches_reference():
    want, got = (st.create_scene() for st in _rlr_states())
    assert list(got) == list(want) == ["mesh", "mic_capsule000", "mic_capsule001", "mic_capsule002",
                                       "mic_capsule003", "a_000", "b_000"]
    for name in want:
        np.testing.assert_allclose(got[name].vertices, want[name].vertices, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[name].faces, want[name].faces)


def test_create_plot_returns_a_figure():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = _rlr_states()[1].create_plot()
    assert isinstance(fig, matplotlib.figure.Figure) and len(fig.axes) == 2
    plt.close(fig)


def test_scaling_matches_reference():
    from audiblelight_tpu.ops import scaling as js
    from audiblelight_tpu_torch.ops import scaling as ts

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 500)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)

    def close(got, want):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())

    close(ts.apply_snr(xt, 0.3), js.apply_snr(xj, 0.3))
    close(ts.db_to_multiplier(-20.0, xt.abs()), js.db_to_multiplier(-20.0, jnp.abs(xj)))
    close(ts.db_to_multiplier(-20.0, 0.5), js.db_to_multiplier(-20.0, 0.5))
    close(ts.peak_normalize(xt), js.peak_normalize(xj))
    close(ts.peak_normalize(xt, axis=-1), js.peak_normalize(xj, axis=-1))
    for n in (200, 500, 800):
        close(ts.pad_or_truncate_audio(xt, n), js.pad_or_truncate_audio(xj, n))


def test_utils_helpers_match_reference(tmp_path, caplog):
    from audiblelight_tpu import utils as ju
    from audiblelight_tpu_torch import utils as tu

    pts = np.random.default_rng(1).uniform(-3, 3, (10, 3))
    np.testing.assert_array_equal(tu.center_coordinates(pts), ju.center_coordinates(pts))
    assert tu.TRAJECTORY_SHAPES == ju.TRAJECTORY_SHAPES
    for d in ("a/b/c", "a/d", "e", "f/b"):
        (tmp_path / d).mkdir(parents=True)
    for fn in ("list_all_directories", "list_deepest_directories", "list_innermost_directory_names",
               "list_innermost_directory_names_unique"):
        assert getattr(tu, fn)(tmp_path) == getattr(ju, fn)(tmp_path), fn
    with pytest.raises(FileNotFoundError):
        tu.list_all_directories(tmp_path / "missing")
    assert tu.safe_import("json") is json
    with pytest.raises(ImportError, match="no_such_module"):
        tu.safe_import("no_such_module")
    with pytest.raises(ImportError, match="^install it$"):
        tu.safe_import("no_such_module", "install it")
    args = [(2, 3), (3, 2), (4, 0.5)]
    assert tu.dynamic_parallel_run(pow, args, n_jobs=1) == ju.dynamic_parallel_run(pow, args, n_jobs=1) == [8, 9, 2.0]
    assert tu.dynamic_parallel_run(pow, args, n_jobs=2) == [8, 9, 2.0]
    tu.logger.setLevel("DEBUG")
    try:
        with tu.timer("sum a range"):
            sum(range(10))
    finally:
        tu.logger.setLevel("WARNING")


def test_config_constants_match_reference():
    """Every constant both configs define has the reference's value; the
    ten that the port lacked among them."""
    from audiblelight_tpu import config as jc
    from audiblelight_tpu_torch import config as tc

    shared = [n for n in vars(jc) if n.isupper() and hasattr(tc, n)]
    for name in ("DEFAULT_BACKEND", "DEFAULT_CHANNEL_LAYOUT", "DEFAULT_EVENT_DURATION", "DEFAULT_EVENT_SNR",
                 "MAX_EMITTERS_PER_EVENT", "MAX_EVENTS_PER_SCENE", "MIN_REF_DB", "MAX_REF_DB",
                 "RAY_TRACER_MAX_IR_LENGTH", "VIDEO_TEXTURE_DECIMATE", "USE_STAR_OCCLUSION"):
        assert name in shared, name
    for name in shared:
        assert getattr(tc, name) == getattr(jc, name), name


def test_world_state_accessors_and_star_switch(monkeypatch):
    """WorldStateRLR's accessors hand out its device state's tables; with
    config.USE_STAR_OCCLUSION off the exact rain mode has no star layout
    (the dense any-hit queries each hit point), as in the reference."""
    from audiblelight_tpu_torch import config
    from audiblelight_tpu_torch.worldstate import TWorldState, WorldState  # noqa: F401

    st = _rlr_states()[1]
    assert st.acoustic_mesh is st.mesh  # no mesh_simplification: the full mesh
    assert st.diffraction_graph_tris is None and st.mesh_tiles is None
    centre = np.array([[3.0, 2.0, 1.5]])
    assert st.rain_occlusion_for(centre) is st.device_state.rain_occlusion_for(centre)
    assert st.star_accel_for(centre[0], 0.02) is None  # a 12-face convex room

    class Built(Exception):
        pass

    def build(*_):
        raise Built

    # A room where the star would pay: the switch alone decides
    monkeypatch.setattr(config, "GRID_ACCEL_MIN_FACES", 0)
    monkeypatch.setattr(st.device_state, "convex", False)
    monkeypatch.setattr(st.device_state, "_cached_tree", build)
    with pytest.raises(Built):
        st.star_accel_for(centre[0], 0.02)
    monkeypatch.setattr(config, "USE_STAR_OCCLUSION", False)
    assert st.star_accel_for(centre[0], 0.02) is None
    inputs = st.device_state.rain_inputs(centre, centre)
    assert inputs["star"] is None and inputs["occlusion"] is True
