"""Geometry: host mesh loading and repair (`TriMesh`) and the batched
queries on the device that back placement and the ray tracer: point in
mesh, nearest surface, segment occlusion and first hit (counterpart of
audiblelight_tpu/geometry/)."""

from audiblelight_tpu_torch.geometry.mesh import TriMesh, box_mesh, load_mesh, scanned_like_room
from audiblelight_tpu_torch.geometry.queries import (
    nearest_surface_distance,
    points_inside_mesh,
    ray_mesh_first_hit,
    segments_occluded,
)

__all__ = [
    "TriMesh",
    "load_mesh",
    "box_mesh",
    "scanned_like_room",
    "points_inside_mesh",
    "nearest_surface_distance",
    "segments_occluded",
    "ray_mesh_first_hit",
]
