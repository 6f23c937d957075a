"""The ray-traced mesh backend: device state and world state.

Counterpart of audiblelight_tpu/worldstate/mesh_backend.py.

- `MeshDeviceState`, the device half: the engine configuration defaults, the
  acoustic LOD, per-face material tables with the Sabine area correction,
  the diffraction-graph LOD, the per-face rain visibility tables ("face"
  rain mode), the star occlusion layouts ("exact" rain mode), the first-hit
  and any-hit trees and, with config.USE_TILED_FIRST_HIT or
  config.USE_MXU_FIRST_HIT, the full mesh's face tree for K7 or
  the LOD's tables and tree for K8, each built once per mesh, built from a
  TriMesh plus an engine-config dict.
- `WorldStateRLR`, the host half the Scene talks to: mesh and engine config,
  the placement `rng`, the validity tests placement runs, relative
  coordinates, serialisation, the walk that seeds each trace, and the trace
  of every microphone's IR bank (`trace_irs_device`, `get_irs`).

Placement's validity tests (point in mesh, surface distance, line of sight,
the openness heuristic) run on the host BVH (`native_bvh`, the port's copy
of the reference's cpp/geomlib.cpp), as the reference runs them: many small
batches, no device round trip each. Where the library cannot be built they
run through the torch queries on the world state's device (K1, K2 and the
plain point-in-mesh and surface-distance queries), with the reference's
warning. The trace seeds come from a walk of their own, keyed by the world
state's seed and a counter: they never draw from the placement streams, so
the same seed places the same events as the reference.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np
import torch

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.geometry.mesh import TriMesh, load_mesh
from audiblelight_tpu_torch.geometry.queries import (
    nearest_surface_distance,
    points_inside_mesh,
    ray_mesh_first_hit,
    segments_occluded,
)
from audiblelight_tpu_torch.micarrays import MicArray
from audiblelight_tpu_torch.ops.cuda_kernels import SMALL_F_MAX, any_hit_tree, first_hit_table
from audiblelight_tpu_torch.ops.mxu_first_hit import MXU_F_MAX, build_mxu_face_tables
from audiblelight_tpu_torch.ops.star_occlusion import build_star_accel, star_tree
from audiblelight_tpu_torch.ops.tiled_first_hit import build_tiled_tree
from audiblelight_tpu_torch.rir.materials import (
    get_material_absorption,
    get_material_scattering,
    get_material_transmission,
    octave_band_centers,
    validate_material,
)
from audiblelight_tpu_torch.utils import logger, resolve_device
from audiblelight_tpu_torch.worldstate.base import Emitter, WorldState
from audiblelight_tpu_torch.worldstate.placement import PlacementMixin

# Engine-config fields and defaults, keyed by the reference rlr config names.
ENGINE_FIELD_DEFAULTS = {
    "sample_rate": config.SAMPLE_RATE,
    "direct_ray_count": config.RAY_TRACER_DIRECT_RAY_COUNT,
    "indirect_ray_count": config.RAY_TRACER_INDIRECT_RAY_COUNT,
    "indirect_ray_depth": config.RAY_TRACER_INDIRECT_RAY_DEPTH,
    "max_ir_length": config.MAX_IR_SECONDS,
    "frequency_bands": config.RAY_TRACER_FREQUENCY_BANDS,
    "direct_sh_order": config.RAY_TRACER_DIRECT_SH_ORDER,
    "indirect_sh_order": config.RAY_TRACER_INDIRECT_SH_ORDER,
    "unit_scale": 1.0,
    "speed_of_sound": config.SPEED_OF_SOUND,
    "thread_count": 1,
    "diffraction": True,
    "max_diffraction_order": 10,
    "transmission": False,
    # False = trace the full mesh; True = decimate to
    # config.MESH_SIMPLIFICATION_TARGET_FACES; an int = face budget; a float =
    # clustering voxel size in metres. The direct path always uses the full mesh.
    "mesh_simplification": False,
    "temporal_coherence": False,
    "dmin": 1.0,
    "hist_bin_dt": 0.002,
    # Diffuse-rain visibility: "exact" = one query per hit point (the star
    # any-hit on big nonconvex meshes, else the dense one); "face" =
    # precomputed per-face centroid visibility, one gather per bounce;
    # "auto" = "face" whenever mesh_simplification is active, else "exact".
    "rain_visibility": "auto",
    "source_bucketing": True,
    "shared_visibility": True,
    "ray_decimation": False,
}


def engine_config(overrides: Optional[dict] = None) -> dict:
    """The engine config: defaults updated by `overrides` (unknown keys raise)."""
    cfg = dict(ENGINE_FIELD_DEFAULTS)
    for k, v in (overrides or {}).items():
        if k not in cfg:
            raise AttributeError(f"Ray-tracing engine has no attribute {k}")
        cfg[k] = v
    return cfg


def rain_mode(cfg: dict) -> str:
    """Resolve cfg["rain_visibility"] ("auto" follows mesh_simplification)."""
    mode = str(cfg["rain_visibility"])
    if mode == "auto":
        return "face" if bool(cfg["mesh_simplification"]) else "exact"
    if mode not in ("exact", "face"):
        raise ValueError(f"rain_visibility must be exact|face|auto, got {mode!r}")
    return mode


def acoustic_mesh(mesh: TriMesh, cfg: dict) -> TriMesh:
    """The mesh the stochastic tail traces: a vertex-clustered LOD when
    cfg["mesh_simplification"] is on, else the full mesh itself."""
    ms = cfg["mesh_simplification"]
    if ms is False:
        return mesh
    if ms is True:
        return mesh.simplified(target_faces=config.MESH_SIMPLIFICATION_TARGET_FACES)
    if isinstance(ms, int):
        return mesh.simplified(target_faces=int(ms))
    if isinstance(ms, float):
        return mesh.simplified(voxel=float(ms))
    raise ValueError(
        f"mesh_simplification must be a bool, int face budget or float voxel size, got {ms!r}"
    )


def face_props(mesh: TriMesh, amesh: TriMesh, material: str, n_bands: int):
    """Per-face (absorption (F', B), scattering (F',), transmission (F', B))
    numpy tables for the acoustic mesh `amesh` of `mesh`.

    Sabine-consistent decimation: clustering shrinks the total surface area,
    which would lengthen the decay, so the absorption is scaled by the area
    ratio (total absorbing power, hence RT60, is kept).
    """
    n_faces = len(amesh.faces)
    bands = octave_band_centers(int(n_bands))
    alpha = get_material_absorption(material, bands)
    tau = get_material_transmission(material, bands)
    if amesh is not mesh and amesh.area > 0:
        alpha = np.clip(np.asarray(alpha, dtype=np.float32) * float(mesh.area / amesh.area), 0.0, 1.0)
    return (
        np.broadcast_to(np.asarray(alpha, dtype=np.float32), (n_faces, len(bands))),
        np.full((n_faces,), get_material_scattering(material), dtype=np.float32),
        np.broadcast_to(np.asarray(tau, dtype=np.float32), (n_faces, len(bands))),
    )


class MeshDeviceState:
    """Device tensors of one room: the full and acoustic triangles, acoustic
    normals, per-face materials, the diffraction-graph LOD, and cached rain
    tables.

    Build it from a mesh with `from_mesh`; the constructor takes the arrays
    themselves (numpy or tensors), e.g. the ones another implementation built.

    Arguments:
        tris: (F, 3, 3) full-resolution triangles (direct path, diffraction
            trigger).
        acoustic_tris, acoustic_normals: (F', 3, 3), (F', 3) the mesh the
            stochastic tail traces.
        absorption, scattering: (F', B), (F',) per-face materials.
        transmission: (F', B) per-face transmission coefficients, which the
            tail reads where cfg["transmission"] is on (required then).
        convex: True when the room is a convex enclosure (no occlusion).
        diffraction_graph_tris: (F'', 3, 3) triangles the diffraction
            candidate legs check against, or None for `tris`.
        cfg: engine config (see `engine_config`).
        device: where the tensors live (default `cuda`; raises without a card).
    """

    def __init__(self, tris, acoustic_tris, acoustic_normals, absorption, scattering,
                 convex: bool, diffraction_graph_tris=None, cfg: Optional[dict] = None,
                 device=None, transmission=None):
        self.cfg = engine_config(cfg)
        if bool(self.cfg["transmission"]) and transmission is None:
            raise ValueError("transmission=True requires the per-face transmission table")
        self.device = resolve_device(device)
        self.convex = bool(convex)
        self.tris = self._tensor(tris)
        self.acoustic_tris = self.tris if acoustic_tris is tris else self._tensor(acoustic_tris)
        self.acoustic_normals = self._tensor(acoustic_normals)
        self.absorption = self._tensor(absorption)
        self.scattering = self._tensor(scattering)
        self.transmission = None if transmission is None else self._tensor(transmission)
        if diffraction_graph_tris is None or diffraction_graph_tris is acoustic_tris:
            # The LOD itself (one tensor, so one cached any-hit tree)
            self.diffraction_graph_tris = None if diffraction_graph_tris is None else self.acoustic_tris
        else:
            self.diffraction_graph_tris = self._tensor(diffraction_graph_tris)
        self._rain_cache: dict = {}
        self._star_cache: dict = {}
        self._tiled_tree = None
        self._first_hit_tables: dict = {}
        self._mxu_tables: dict = {}
        self._any_hit_trees: dict = {}

    @classmethod
    def from_mesh(cls, mesh: TriMesh, cfg: Optional[dict] = None,
                  material: Optional[str] = None, device=None) -> "MeshDeviceState":
        """The device state of `mesh` under engine config `cfg`."""
        cfg = engine_config(cfg)
        material = validate_material(material)
        amesh = acoustic_mesh(mesh, cfg)
        absorption, scattering, tau = face_props(mesh, amesh, material, cfg["frequency_bands"])
        if len(mesh.faces) < config.GRID_ACCEL_MIN_FACES:
            graph = None
        elif amesh is not mesh:
            graph = amesh.triangles
        else:
            graph = mesh.simplified(target_faces=config.MESH_SIMPLIFICATION_TARGET_FACES).triangles
        return cls(mesh.triangles, amesh.triangles, amesh.face_normals, absorption, scattering,
                   convex=mesh.is_convex, diffraction_graph_tris=graph, cfg=cfg, device=device,
                   transmission=tau if bool(cfg["transmission"]) else None)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, dtype=np.float32), device=self.device)

    def rain_occlusion_for(self, listener_points) -> torch.Tensor:
        """Cached (P, F') per-face rain-occlusion table for the acoustic mesh,
        keyed by the listener points rounded to 0.1 mm."""
        from audiblelight_tpu_torch.rir.raytracer import face_rain_occlusion

        pts = np.atleast_2d(np.asarray(listener_points, dtype=np.float64))
        key = tuple(np.round(pts, 4).ravel().tolist())
        if key not in self._rain_cache:
            self._rain_cache[key] = face_rain_occlusion(
                self.acoustic_tris, self.acoustic_normals, self._tensor(pts), self.any_hit_tree(self.acoustic_tris)
            )
        return self._rain_cache[key]

    def star_accel_for(self, center, r_pad: float):
        """The cached star occlusion layout of the acoustic mesh about
        `center`, valid for segment ends within `r_pad` of it; keyed by the
        centre rounded to 0.1 mm and r_pad. None where it does not pay: a
        convex room, an acoustic mesh under GRID_ACCEL_MIN_FACES faces, or
        too many faces near the centre (build_star_accel); the exact mode
        then runs the dense any-hit."""
        if self.convex or self.acoustic_tris.shape[0] < config.GRID_ACCEL_MIN_FACES:
            return None
        center = np.asarray(center, dtype=np.float64).reshape(3)
        key = (tuple(np.round(center, 4).tolist()), round(float(r_pad), 4))
        if key not in self._star_cache:
            tris = self.acoustic_tris.cpu().numpy()
            tree = self._cached_tree("star", lambda: star_tree(tris, self.device))
            star = build_star_accel(tris, center, r_pad, device=self.device, tree=tree)
            if star is None:
                logger.info("Star occlusion layout does not pay here: the exact rain mode runs the dense any-hit")
            else:
                logger.info(f"Built occlusion structure: {star}")
            self._star_cache[key] = star
        return self._star_cache[key]

    def first_hit_table(self, tris: torch.Tensor) -> tuple:
        """The cached first-hit table (`cuda_kernels.first_hit_table`) of
        `tris`, this state's full or acoustic triangles, built once: for
        more than SMALL_F_MAX faces the big variant's table and face tree,
        else the classic rows and the cached any-hit tree of `tris`, which
        K1 small walks (one tree for the first hit and the occlusion
        queries)."""
        key = id(tris)
        if key not in self._first_hit_tables:
            if tris.shape[0] <= SMALL_F_MAX:
                self._first_hit_tables[key] = first_hit_table(tris, self.any_hit_tree(tris))
            else:
                self._first_hit_tables[key] = first_hit_table(tris)
                logger.info(f"Built first-hit face tree: {self._first_hit_tables[key][3]}")
        return self._first_hit_tables[key]

    def mxu_tables(self, tris: torch.Tensor):
        """The cached K8 tables and face tree (`build_mxu_face_tables`) of
        `tris`, this state's full or acoustic triangles, built once; None
        where the route does not apply (config.USE_MXU_FIRST_HIT off, or
        more than MXU_F_MAX faces)."""
        if not config.USE_MXU_FIRST_HIT or tris.shape[0] > MXU_F_MAX:
            return None
        key = id(tris)
        if key not in self._mxu_tables:
            self._mxu_tables[key] = self._timed("K8 tables and face tree", lambda: build_mxu_face_tables(tris))
        return self._mxu_tables[key]

    def _timed(self, what: str, build):
        """`build()`, its build time logged (host clock, synchronised)."""
        t0 = time.perf_counter()
        out = build()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info(f"Built {what}: {out} in {1e3 * (time.perf_counter() - t0):.1f} ms")
        return out

    def any_hit_tree(self, tris: torch.Tensor):
        """The cached any-hit tree (`cuda_kernels.any_hit_tree`) of `tris`,
        this state's full, acoustic or diffraction-graph triangles, built
        once: every segment query on them walks it."""
        return self._cached_tree(id(tris), lambda: any_hit_tree(tris))

    def _cached_tree(self, key, build):
        if key not in self._any_hit_trees:
            self._any_hit_trees[key] = self._timed("any-hit face tree", build)
        return self._any_hit_trees[key]

    @property
    def tiled_tree(self):
        """The cached face tree of the full mesh for the tiled first hit
        (K7, `build_tiled_tree`), or None: the flag
        config.USE_TILED_FIRST_HIT is off, or the mesh has fewer than
        GRID_ACCEL_MIN_FACES faces."""
        if not config.USE_TILED_FIRST_HIT or self.tris.shape[0] < config.GRID_ACCEL_MIN_FACES:
            return None
        if self._tiled_tree is None:
            self._tiled_tree = self._timed("K7 face tree", lambda: build_tiled_tree(self.tris, device=self.device))
        return self._tiled_tree

    def rain_inputs(self, capsules, listeners) -> dict:
        """The tracer's rain-visibility keywords (face_occlusion, star,
        occlusion, shared_visibility) for a rig whose capsules are
        `capsules` (C, 3) and whose traced listener points are `listeners`,
        as the engine config's rain mode resolves them."""
        shared = bool(self.cfg["shared_visibility"])
        out = dict(face_occlusion=None, star=None, occlusion=not self.convex, shared_visibility=shared)
        if self.convex:
            return out
        caps = np.atleast_2d(np.asarray(capsules, dtype=np.float64))
        center = caps.mean(axis=0)
        if rain_mode(self.cfg) == "face":
            out["face_occlusion"] = self.rain_occlusion_for(center[None] if shared else listeners)
        elif shared:
            out["star"] = self.star_accel_for(center, r_pad=0.02)
        else:
            out["star"] = self.star_accel_for(center, float(np.linalg.norm(caps - center, axis=1).max()) + 0.02)
        return out


    def _trace_kwargs(self, encoding: str, hrtf=None) -> dict:
        """The tracer's keywords under this room's engine config: the tail
        on the acoustic mesh, the direct path on the full mesh, diffraction
        in a nonconvex room; K7's tree where the tail traces the full mesh
        itself and that tree is built."""
        cfg = self.cfg
        sr = int(cfg["sample_rate"])
        return dict(
            n_samples=int(round(float(cfg["max_ir_length"]) * sr)),
            sr=sr,
            n_rays=int(cfg["indirect_ray_count"]),
            max_depth=min(int(cfg["indirect_ray_depth"]), 200),
            bin_dt=float(cfg["hist_bin_dt"]),
            c=float(cfg["speed_of_sound"]),
            tri_normals=self.acoustic_normals,
            tris_direct=self.tris,
            diffraction=bool(cfg["diffraction"]) and not self.convex,
            diffraction_order=max(1, int(cfg["max_diffraction_order"])),
            tris_diffraction_graph=self.diffraction_graph_tris,
            decimate=bool(cfg["ray_decimation"]),
            encoding=encoding,
            sh_order_direct=int(cfg["direct_sh_order"]),
            sh_order_indirect=int(cfg["indirect_sh_order"]),
            tiled_tree=self.tiled_tree if self.acoustic_tris is self.tris else None,
            fh_table=self.first_hit_table(self.acoustic_tris),
            any_hit_tree=self.any_hit_tree,
            mxu_tables=self.mxu_tables(self.acoustic_tris),
            hrtf=hrtf,
            transmission=bool(cfg["transmission"]),
            face_transmission=self.transmission,
        )

    def trace_rirs(self, gen: torch.Generator, sources: torch.Tensor, listeners: torch.Tensor,
                   encoding: str, rain: dict, hrtf=None) -> torch.Tensor:
        """(C_out, E, L) RIRs of `sources` at `listeners` under this room's
        engine config (`_trace_kwargs`) with the rain visibility `rain`
        (`rain_inputs`); `hrtf` a measured binaural set."""
        from audiblelight_tpu_torch.rir.raytracer import trace_rirs_multi

        return trace_rirs_multi(gen, self.acoustic_tris, self.absorption, self.scattering, sources, listeners,
                                **self._trace_kwargs(encoding, hrtf), **rain)

    def trace_rirs_batch(self, gens: list, sources: torch.Tensor, listeners: torch.Tensor, encoding: str,
                         face_occlusion: Optional[torch.Tensor], hrtf=None) -> list:
        """B scenes' RIRs in one bounce loop (`raytracer.trace_rirs_batch`):
        sources (B, S, 3), listeners (B, C, 3), each scene's per-face rain
        table stacked (B, P, F') or None in a convex room, one generator per
        scene. Returns B tensors of (C_out, S, L), scene b's equal to its
        `trace_rirs` with gens[b]."""
        from audiblelight_tpu_torch.rir.raytracer import trace_rirs_batch

        return trace_rirs_batch(gens, self.acoustic_tris, self.absorption, self.scattering, sources, listeners,
                                face_occlusion=face_occlusion, **self._trace_kwargs(encoding, hrtf))


# Tracer encoding of each one-point channel layout
LAYOUT_ENCODINGS = {"foa": "foa", "hoa2": "sh2", "hoa3": "sh3", "binaural": "binaural"}


def mic_encoding(mic: MicArray) -> tuple:
    """(tracer encoding, traced listener points (P, 3), capsules (C, 3)) of
    a placed microphone: every capsule for "mic" layouts (omni), the rig's
    centre for the one-point layouts."""
    caps = np.atleast_2d(np.asarray(utils.coerce2d(mic.coordinates_absolute), dtype=np.float64))
    if mic.channel_layout_type == "mic":
        return "omni", caps, caps
    centre = np.atleast_2d(np.asarray(utils.coerce2d(mic.coordinates_center), dtype=np.float64))
    return LAYOUT_ENCODINGS[mic.channel_layout_type], centre, caps


class _EngineContext:
    """Listener/source/object counts of the engine context, and the ray
    efficiency of the last simulation."""

    def __init__(self, cfg: dict):
        self.config = cfg
        self.listeners: list = []
        self.sources: list = []
        self.object_count = 0
        self.indirect_ray_efficiency = None

    def get_listener_count(self) -> int:
        return len(self.listeners)

    def get_source_count(self) -> int:
        return len(self.sources)

    def get_object_count(self) -> int:
        return self.object_count

    def get_indirect_ray_efficiency(self) -> float:
        return self.indirect_ray_efficiency if self.indirect_ray_efficiency is not None else 0.0


class WorldStateRLR(PlacementMixin, WorldState):
    """A WorldState whose sound is ray-traced inside a 3D mesh.

    Arguments as the reference's; `device` is where the mesh lives for the
    placement queries and the trace (default `cuda`; raises without a card).
    `waypoints_json` names the navigation waypoints of predefined-trajectory
    events (default: `resources/waypoints/gibson/<mesh name>.json` beside
    the package, where it exists); `repair_threshold` repairs a mesh that is
    not watertight when its share of broken faces is under it.
    """

    name = "RLR"

    def __init__(
        self,
        mesh: Union[str, Path, TriMesh],
        sample_rate: Optional[utils.Numeric] = config.SAMPLE_RATE,
        empty_space_around_mic: Optional[utils.Numeric] = config.EMPTY_SPACE_AROUND_MIC,
        empty_space_around_emitter: Optional[utils.Numeric] = config.EMPTY_SPACE_AROUND_EMITTER,
        empty_space_around_surface: Optional[utils.Numeric] = config.EMPTY_SPACE_AROUND_SURFACE,
        empty_space_around_capsule: Optional[utils.Numeric] = config.EMPTY_SPACE_AROUND_CAPSULE,
        add_to_context: Optional[bool] = True,
        ensure_minimum_weighted_average_ray_length: Optional[bool] = False,
        minimum_weighted_average_ray_length: Optional[utils.Numeric] = config.MIN_AVG_RAY_LENGTH,
        repair_threshold: Optional[utils.Numeric] = None,
        waypoints_json: Optional[Union[str, Path]] = None,
        material: Optional[str] = None,
        rlr_kwargs: Optional[dict] = None,
        seed: Optional[int] = None,
        device=None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.add_to_state = add_to_context
        self.sample_rate = utils.sanitise_positive_number(sample_rate, cast_to=int)
        self.rng = np.random.default_rng(seed)
        self._trace_seed = utils.SEED if seed is None else int(seed)
        self._trace_count = 0

        self.empty_space_around_mic = utils.sanitise_positive_number(empty_space_around_mic)
        self.empty_space_around_surface = utils.sanitise_positive_number(empty_space_around_surface)
        self.empty_space_around_emitter = utils.sanitise_positive_number(empty_space_around_emitter)
        self.empty_space_around_capsule = utils.sanitise_positive_number(empty_space_around_capsule)
        self.ensure_minimum_weighted_average_ray_length = ensure_minimum_weighted_average_ray_length
        self.minimum_weighted_average_ray_length = utils.sanitise_positive_number(
            minimum_weighted_average_ray_length
        )

        self.mesh = mesh if isinstance(mesh, TriMesh) else load_mesh(mesh)
        # The engine config first: the torch queries that validate the
        # waypoints (where the host BVH cannot be built) read the device state
        self.material = validate_material(material)
        self.cfg = self._parse_rlr_config(rlr_kwargs)
        self.waypoints_json = waypoints_json
        self.waypoints = self.load_mesh_navigation_waypoints(waypoints_json)
        self.repair_threshold = repair_threshold
        if repair_threshold is not None and not self.mesh.is_watertight:
            broken = self.mesh.broken_faces()
            if len(broken) / max(len(self.mesh.faces), 1) < repair_threshold:
                self.mesh.repair()
                # The repaired faces invalidate what was built from the old ones
                for cache in ("_torch_device_states", "_native_bvh_cache"):
                    self.mesh.__dict__.pop(cache, None)
        self.ctx = None
        if self.add_to_state:
            self._setup_audio_context()

    def split_key(self) -> int:
        """The next trace seed of this world state's walk: a 63-bit integer
        from (seed, counter), independent of every placement stream."""
        state = np.random.SeedSequence([self._trace_seed, self._trace_count]).generate_state(1, np.uint64)
        self._trace_count += 1
        return int(state[0] >> np.uint64(1))

    def _parse_rlr_config(self, rlr_kwargs: Optional[dict]) -> dict:
        """The engine config, with the world state's sample rate."""
        rlr_kwargs = dict(rlr_kwargs or {})
        if "sample_rate" not in rlr_kwargs:
            rlr_kwargs["sample_rate"] = self.sample_rate
        elif rlr_kwargs["sample_rate"] != self.sample_rate:
            raise ValueError(
                f"Mismatching sample rate (expected {self.sample_rate}, got {rlr_kwargs['sample_rate']})"
            )
        for fld, default in (("temporal_coherence", False), ("dmin", 1.0)):
            if fld in rlr_kwargs and rlr_kwargs[fld] != default:
                logger.warning(f"rlr config field '{fld}'={rlr_kwargs[fld]!r} is accepted for "
                               "serialisation parity but has no effect in this tracer.")
        return engine_config(rlr_kwargs)

    @property
    def device_state(self) -> MeshDeviceState:
        """The room's device tensors, shared by every world state over the
        same mesh object, device, engine config and material."""
        cache = self.mesh.__dict__.setdefault("_torch_device_states", {})
        key = (str(self.device), str(self.material),
               tuple((k, str(v)) for k, v in self.cfg.items()), len(self.mesh.faces))
        if key not in cache:
            cache[key] = MeshDeviceState.from_mesh(self.mesh, self.cfg, material=self.material,
                                                   device=self.device)
        return cache[key]

    def _setup_audio_context(self) -> None:
        self.ctx = _EngineContext(self.cfg)
        self.ctx.object_count = 1  # the mesh

    def _update(self) -> None:
        """Refresh the context counts and every emitter's relative coordinates."""
        self._setup_audio_context()
        for mic in self.microphones.values():
            for _ in range(mic.n_listeners):
                self.ctx.listeners.append(mic.channel_layout)
        for emitter_list in self.emitters.values():
            for emitter in emitter_list:
                self.ctx.sources.append(emitter.coordinates_absolute)
        self._update_relative_coordinates()

    def load_mesh_navigation_waypoints(self, waypoints_json: Optional[Union[Path, str]] = None) -> list:
        """The navigation waypoints of this mesh: a JSON list of dictionaries,
        each with a "waypoints" list of positions, from `waypoints_json` or,
        by default, `resources/waypoints/gibson/<mesh name>.json`. Waypoint
        lists with an invalid position are dropped."""
        import json

        if waypoints_json is None:
            mesh_fname = self.mesh.metadata.get("fname", "")
            # A generated mesh has no file, so never any waypoints: say so quietly
            ftype = self.mesh.metadata.get("ftype", "")
            fpath = str(self.mesh.metadata.get("fpath", ""))
            procedural = ftype == "generated" or fpath.startswith("synthetic://")
            default_loc = utils.get_project_root() / "resources/waypoints/gibson"
            candidate = (default_loc / mesh_fname).with_suffix(".json")
            if not candidate.is_file():
                (logger.debug if procedural else logger.warning)(
                    f"Cannot find waypoints for mesh {mesh_fname} inside default location "
                    f"({default_loc}). No navigation waypoints will be loaded."
                )
                return []
            waypoints_json = candidate
        else:
            waypoints_json = utils.sanitise_filepath(waypoints_json)

        with open(waypoints_json) as js_in:
            js_out = json.load(js_in)
        if not isinstance(js_out, list):
            raise ValueError(f"Expected waypoints JSON to be a list of dictionaries, got {type(js_out)}")
        if not all("waypoints" in wp for wp in js_out):
            raise KeyError("Waypoints JSON must be a list of dictionaries, each containing the key 'waypoints'.")
        waypoints = [np.array(wp["waypoints"]) for wp in js_out if self._validate_position(wp["waypoints"])]
        if len(waypoints) == 0:
            logger.warning("No valid navigation waypoints found!")
        return waypoints

    # ------------------------------------------------------------------
    # Geometry
    # ------------------------------------------------------------------

    @property
    def bounds(self) -> np.ndarray:
        return self.mesh.bounds

    def _points(self, positions) -> torch.Tensor:
        return torch.as_tensor(np.asarray(positions, dtype=np.float32), device=self.device)

    @property
    def native_bvh(self):
        """The host BVH of the mesh (`geometry.native.NativeBVH`) for
        placement's queries, or None where the library cannot be built (the
        torch queries run instead). Cached on the mesh, keyed by its face
        count: dataset runs build many world states over one mesh object."""
        if getattr(self, "_native_bvh_failed", False):
            return None
        cached = self.mesh.__dict__.get("_native_bvh_cache")
        if cached is not None and cached[0] == len(self.mesh.faces):
            return cached[1]
        from audiblelight_tpu_torch.geometry.native import NativeBVH, native_available

        if not native_available():
            self._native_bvh_failed = True
            return None
        bvh = NativeBVH(self.mesh.triangles.astype(np.float32))
        self.mesh.__dict__["_native_bvh_cache"] = (len(self.mesh.faces), bvh)
        return bvh

    def _get_valid_positions_mask(self, pos_abs: np.ndarray) -> np.ndarray:
        """Batched position validation: distances to objects and surfaces,
        and inside the mesh."""
        positions = utils.coerce2d(np.asarray(pos_abs, dtype=np.float64))
        if positions.shape[1] != 3:
            raise ValueError("Expected input to have shape (N, 3) for XYZ coordinates")
        valid = self._distance_mask(positions)
        bvh = self.native_bvh
        if bvh is not None:
            valid &= bvh.nearest_surface_distance(positions) >= self.empty_space_around_surface
            valid &= bvh.contains(positions)
            return valid
        pts = self._points(positions)
        tris = self.device_state.tris
        valid &= nearest_surface_distance(pts, tris).cpu().numpy() >= self.empty_space_around_surface
        valid &= points_inside_mesh(pts, tris).cpu().numpy()
        return valid

    def path_exists_between_points(self, point_a: np.ndarray, point_b: np.ndarray) -> bool:
        """True when both points are inside the mesh and no face blocks the
        segment between them."""
        point_a = np.asarray(point_a, dtype=np.float64)
        point_b = np.asarray(point_b, dtype=np.float64)
        for point in (point_a, point_b):
            if point.shape != (3,):
                raise ValueError(f"Expected an array with shape (3,) but got {point.shape}")
        bvh = self.native_bvh
        if bvh is not None:
            if not bvh.contains(np.stack([point_a, point_b])).all():
                return False
            return not bool(bvh.segments_occluded(point_a[None], point_b[None])[0])
        tris = self.device_state.tris
        if not bool(points_inside_mesh(self._points(np.stack([point_a, point_b])), tris).all()):
            return False
        return not bool(segments_occluded(self._points(point_a[None]), self._points(point_b[None]), tris,
                                          self.device_state.any_hit_tree(tris))[0])

    def calculate_weighted_average_ray_length(self, point: np.ndarray,
                                              num_rays: Optional[utils.Numeric] = config.NUM_RAYS) -> float:
        """Openness heuristic: the distance^2-weighted mean ray length from a point."""
        num_rays = utils.sanitise_positive_number(num_rays, cast_to=int)
        point = utils.sanitise_coordinates(point)
        angles = self.rng.uniform(0, 2 * np.pi, num_rays)
        elevations = self.rng.uniform(-np.pi / 2, np.pi / 2, num_rays)
        cos_el = np.cos(elevations)
        directions = np.stack([cos_el * np.cos(angles), cos_el * np.sin(angles), np.sin(elevations)], -1)
        origins = np.broadcast_to(point, (num_rays, 3))
        bvh = self.native_bvh
        if bvh is not None:
            distances, _ = bvh.ray_first_hit(origins, directions)
        else:
            st = self.device_state
            t, _ = ray_mesh_first_hit(self._points(origins), self._points(directions), st.tris,
                                      st.first_hit_table(st.tris))
            distances = t.cpu().numpy()
        if np.isinf(distances).any():
            logger.warning(f"Some rays cast from point {point} have infinite distances: is the mesh watertight?")
            distances = distances[np.isfinite(distances)]
        weights = distances**2
        return float(np.sum(distances * weights) / np.sum(weights))

    def _emitter_positions(self) -> np.ndarray:
        """All emitter coordinates, flattened in registration order: (E, 3)."""
        coords = [e.coordinates_absolute for lst in self.emitters.values() for e in lst]
        return np.stack(coords) if coords else np.zeros((0, 3))

    def _rain_mode(self) -> str:
        return rain_mode(self.cfg)

    # ------------------------------------------------------------------
    # Simulation
    # ------------------------------------------------------------------

    def _simulation_sanity_check(self) -> None:
        assert self.num_emitters > 0, "Must have added valid emitters before calling `simulate`!"
        assert len(self.microphones) > 0, "Must have added microphones before calling `simulate`!"
        assert all(
            issubclass(type(m), MicArray) for m in self.microphones.values()
        ), "Non-microphone objects in microphone attribute"
        assert self.ctx.get_listener_count() > 0
        assert self.ctx.get_source_count() > 0
        assert self.ctx.get_object_count() == 1
        assert sum(len(em) for em in self.emitters.values()) == self.ctx.get_source_count()
        assert sum(m.n_listeners for m in self.microphones.values()) == self.ctx.get_listener_count()

    def simulate(self) -> None:
        """Trace the IRs of every (microphone, emitter) pair, after the
        reference's sanity checks; then estimate the ray efficiency from the
        mesh's watertightness and warn below WARN_WHEN_RAY_EFFICIENCY_BELOW."""
        self._update()
        self._simulation_sanity_check()
        self._irs = None
        logger.info(f"Starting simulation with {self.num_emitters} emitters, {len(self.microphones)} microphones")
        self._irs = self.get_irs()
        escaped = len(self.mesh.broken_faces()) / max(len(self.mesh.faces), 1)
        efficiency = float(np.clip(1.0 - escaped, 0.0, 1.0))
        self.ctx.indirect_ray_efficiency = efficiency
        if efficiency < config.WARN_WHEN_RAY_EFFICIENCY_BELOW:
            logger.warning(
                f"Ray efficiency is below {config.WARN_WHEN_RAY_EFFICIENCY_BELOW:.0%}. "
                f"The mesh may have holes; consider a lower `repair_threshold` or repairing it."
            )

    def get_irs(self) -> OrderedDict:
        """{mic alias: (C_out, n_emitters, n_samples)} IRs as host numpy
        arrays (also kept on each mic as `mic.irs`)."""
        out = OrderedDict()
        for alias, irs in self.trace_irs_device().items():
            out[alias] = self.microphones[alias].irs = irs.cpu().numpy()
        return out

    @property
    def irs(self) -> OrderedDict:
        """The simulated IRs, taken to the host from the last device trace
        where only `trace_irs_device` has run."""
        cached = getattr(self, "_irs_device_cache", None)
        if self._irs is None and cached is not None:
            self._irs = OrderedDict((a, v.cpu().numpy()) for a, v in cached[1].items())
            for a, arr in self._irs.items():
                self.microphones[a].irs = arr
        return super().irs

    def trace_irs_device(self) -> OrderedDict:
        """Trace the IRs of every microphone, {alias: (C_out, E, L)} tensors
        on the world state's device, as the reference traces them: emitters
        padded to the next power of two with the first one (source
        bucketing, dropped after the trace), one trace per microphone with
        its own seed from the trace walk, the rain visibility of the engine
        config's mode, a binaural head with `hrtf_sofa` through its measured
        set. One trace per configuration: a second call with the same room,
        config, emitters and microphones (and HRTF file) returns the first's."""
        self._update()
        if self.num_emitters == 0 or not self.microphones:
            raise ValueError("add microphones and emitters before tracing")
        st = self.device_state
        cache_key = (
            id(st),
            tuple(np.round(self._emitter_positions().ravel(), 6).tolist()),
            tuple((a, m.name, m.channel_layout_type,
                   tuple(np.round(np.ravel(m.coordinates_absolute), 6).tolist()),
                   str(getattr(m, "hrtf_sofa", None)))  # a changed SOFA file retraces
                  for a, m in self.microphones.items()),
        )
        cached = getattr(self, "_irs_device_cache", None)
        if cached is not None and cached[0] == cache_key:
            return cached[1]
        src = self._emitter_positions().astype(np.float32)
        n_src = len(src)
        if bool(self.cfg["source_bucketing"]):
            bucket = 1
            while bucket < n_src:
                bucket *= 2
            src = np.concatenate([src, np.tile(src[:1], (bucket - n_src, 1))])
        sources = self._points(src)
        out = OrderedDict()
        for alias, mic in self.microphones.items():
            encoding, listeners, caps = mic_encoding(mic)
            listeners_t = self._points(listeners)
            gen = torch.Generator(device=self.device).manual_seed(self.split_key())
            hrtf = (mic.load_hrtf(self.sample_rate, self.device)
                    if encoding == "binaural" and getattr(mic, "hrtf_sofa", None) else None)
            irs = st.trace_rirs(gen, sources, listeners_t, encoding, st.rain_inputs(caps, listeners), hrtf)
            out[alias] = irs[:, :n_src]
        self._irs_device_cache = (cache_key, out)
        return out

    # ------------------------------------------------------------------
    # Serialisation
    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        if self.ctx is None:
            self._setup_audio_context()
            self._update()
        return dict(
            backend=self.name,
            sample_rate=self.sample_rate,
            emitters={
                alias: [utils.coerce_nested_inputs(e.coordinates_absolute) for e in lst]
                for alias, lst in self.emitters.items()
            },
            microphones={a: m.to_dict() for a, m in self.microphones.items()},
            mesh=dict(**self.mesh.metadata, bounds=self.mesh.bounds.tolist(),
                      centroid=self.mesh.centroid.tolist()),
            rlr_config=dict(self.cfg),
            empty_space_around_mic=self.empty_space_around_mic,
            empty_space_around_emitter=self.empty_space_around_emitter,
            empty_space_around_surface=self.empty_space_around_surface,
            empty_space_around_capsule=self.empty_space_around_capsule,
            repair_threshold=self.repair_threshold,
            material=self.material,
            # Only where one was named: the reference's dict has no such key
            **({} if self.waypoints_json is None else dict(waypoints_json=str(self.waypoints_json))),
        )

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any], device=None) -> "WorldStateRLR":
        for k in ["emitters", "microphones", "mesh", "rlr_config", "sample_rate"]:
            if k not in input_dict:
                raise KeyError(f"Missing key: '{k}'")
        state = cls(
            mesh=input_dict["mesh"]["fpath"],
            sample_rate=input_dict["sample_rate"],
            empty_space_around_mic=input_dict["empty_space_around_mic"],
            empty_space_around_emitter=input_dict["empty_space_around_emitter"],
            empty_space_around_surface=input_dict["empty_space_around_surface"],
            empty_space_around_capsule=input_dict["empty_space_around_capsule"],
            repair_threshold=input_dict["repair_threshold"],
            rlr_kwargs=input_dict["rlr_config"],
            material=input_dict.get("material", None),
            waypoints_json=input_dict.get("waypoints_json", None),
            device=device,
        )
        state.microphones = OrderedDict(
            {a: MicArray.from_dict(v) for a, v in input_dict["microphones"].items()}
        )
        state.emitters = OrderedDict(
            {a: [Emitter(alias=a, coordinates_absolute=v_) for v_ in v]
             for a, v in input_dict["emitters"].items()}
        )
        state._update()
        return state

    def __str__(self) -> str:
        return (
            f"'{self.__class__.__name__}' with mesh '{self.mesh.metadata.get('fpath', '?')}' and "
            f"{len(self)} objects ({len(self.microphones)} microphones, {self.num_emitters} emitters)"
        )
