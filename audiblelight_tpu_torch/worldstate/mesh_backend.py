"""Device state of the ray-traced mesh backend.

Counterpart of the device-state half of
audiblelight_tpu/worldstate/mesh_backend.py (WorldStateRLR): the engine
configuration defaults, the acoustic LOD, per-face material tables with the
Sabine area correction, the diffraction-graph LOD and the per-face rain
visibility table. It works from a TriMesh plus an engine-config dict; the
Scene, placement and the PRNG walk belong to the host half.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from audiblelight_tpu_torch import config
from audiblelight_tpu_torch.geometry.mesh import TriMesh
from audiblelight_tpu_torch.rir.materials import (
    get_material_absorption,
    get_material_scattering,
    get_material_transmission,
    octave_band_centers,
    validate_material,
)
from audiblelight_tpu_torch.utils import resolve_device

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
    # "face" = precomputed per-face centroid visibility; "auto" = "face"
    # whenever mesh_simplification is active, else "exact" (per-hit queries,
    # which this package does not run).
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
        convex: True when the room is a convex enclosure (no occlusion).
        diffraction_graph_tris: (F'', 3, 3) triangles the diffraction
            candidate legs check against, or None for `tris`.
        cfg: engine config (see `engine_config`).
        device: where the tensors live (default `cuda`; raises without a card).
    """

    def __init__(self, tris, acoustic_tris, acoustic_normals, absorption, scattering,
                 convex: bool, diffraction_graph_tris=None, cfg: Optional[dict] = None,
                 device=None):
        self.cfg = engine_config(cfg)
        if bool(self.cfg["transmission"]):
            raise NotImplementedError("transmission is not ported")
        self.device = resolve_device(device)
        self.convex = bool(convex)
        self.tris = self._tensor(tris)
        self.acoustic_tris = self.tris if acoustic_tris is tris else self._tensor(acoustic_tris)
        self.acoustic_normals = self._tensor(acoustic_normals)
        self.absorption = self._tensor(absorption)
        self.scattering = self._tensor(scattering)
        self.diffraction_graph_tris = (
            None if diffraction_graph_tris is None else self._tensor(diffraction_graph_tris)
        )
        self._rain_cache: dict = {}

    @classmethod
    def from_mesh(cls, mesh: TriMesh, cfg: Optional[dict] = None,
                  material: Optional[str] = None, device=None) -> "MeshDeviceState":
        """The device state of `mesh` under engine config `cfg`."""
        cfg = engine_config(cfg)
        material = validate_material(material)
        amesh = acoustic_mesh(mesh, cfg)
        absorption, scattering, _ = face_props(mesh, amesh, material, cfg["frequency_bands"])
        if len(mesh.faces) < config.GRID_ACCEL_MIN_FACES:
            graph = None
        elif amesh is not mesh:
            graph = amesh.triangles
        else:
            graph = mesh.simplified(target_faces=config.MESH_SIMPLIFICATION_TARGET_FACES).triangles
        return cls(mesh.triangles, amesh.triangles, amesh.face_normals, absorption, scattering,
                   convex=mesh.is_convex, diffraction_graph_tris=graph, cfg=cfg, device=device)

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
                self.acoustic_tris, self.acoustic_normals, self._tensor(pts)
            )
        return self._rain_cache[key]
