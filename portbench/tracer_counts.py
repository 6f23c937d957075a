"""The bytes the ray tracer's kernels need, counted from the data alone:
each ray or segment handed in read once and its result written once, each
face read once a launch (its three corners, 36 bytes), each histogram
written once. Independent of how the program lays them out."""

from __future__ import annotations

import functools

F32 = 4
FACE_BYTES = 9 * F32  # a triangle's three corners
RAY_IN, HIT_OUT = 6 * F32, 2 * F32  # origin and direction; distance and face
SEGMENT_IN, BLOCKED_OUT = 6 * F32, 1  # start and end; a flag
# The one-bend lattice (angles x radii) and the multi-bend graph (stations
# x angles x radii) of each source's diffraction search
BEND_LATTICE = 16 * 12
GRAPH_STATIONS, GRAPH_LATTICE = 4, 12 * 4


@functools.lru_cache(maxsize=None)
def mesh_faces(mesh: str, budget: int) -> tuple:
    """(the mesh's faces, its acoustic LOD's) under a face budget."""
    from portbench import manifest
    from portbench.reference.rlr import lod

    v, f = manifest.load_mesh(mesh)
    return len(f), len(lod(v, f, budget)[1])


def first_hit_bytes(rays: int, launches: int, faces: int) -> int:
    return rays * (RAY_IN + HIT_OUT) + launches * faces * FACE_BYTES


def deposit_bytes(rays: int, launches: int, rays_a_source: int, capsules: int, bands: int, n_bins: int) -> int:
    """Each ray's hit, normal, band energies, path and capsules' flags read;
    each source's (capsules, bands, bins) histogram written, every launch."""
    per_ray = 3 * F32 + 3 * F32 + bands * F32 + F32 + capsules
    return rays * per_ray + (rays // rays_a_source) * capsules * bands * n_bins * F32


def any_hit_queries(sources: int, capsules: int, faces: int, lod_faces: int, order: int) -> list:
    """(segments, faces) of each segment query a scene's trace makes past
    its rain table: the direct paths and the diffraction trigger on the
    full mesh, the one-bend legs and (order >= 2) the graph's legs."""
    from portbench.reference.rlr import GRAPH_LOD_MIN_FACES

    legs = lod_faces if faces >= GRAPH_LOD_MIN_FACES else faces
    out = [(sources * capsules, faces), (sources * capsules, faces), (sources * 2 * BEND_LATTICE, legs)]
    if order >= 2:
        nodes = GRAPH_STATIONS * GRAPH_LATTICE
        out.append((sources * (2 * nodes + nodes * nodes), legs))
    return out


def any_hit_bytes(queries: list) -> int:
    return sum(n * (SEGMENT_IN + BLOCKED_OUT) + f * FACE_BYTES for n, f in queries)
