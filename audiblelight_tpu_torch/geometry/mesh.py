"""Host-side triangle mesh (numpy): the port's copy of audiblelight_tpu's TriMesh.

Only what the render path needs: derived quantities, the convexity test that
switches occlusion off, midpoint subdivision, vertex-clustering decimation
(the acoustic LOD), and the two synthetic room generators. The arithmetic is
kept line for line with the reference so both packages build the same
triangles and the same LOD from the same seed.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np


class TriMesh:
    """An indexed triangle mesh with cached derived quantities."""

    def __init__(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        metadata: Optional[dict] = None,
    ):
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int32)
        if self.vertices.ndim != 2 or self.vertices.shape[1] != 3:
            raise ValueError(f"vertices must be (V, 3), got {self.vertices.shape}")
        if self.faces.ndim != 2 or self.faces.shape[1] != 3:
            raise ValueError(f"faces must be (F, 3), got {self.faces.shape}")
        self.metadata = metadata or {}
        self._tri_cache = None
        self._is_convex = None
        self._simplify_memo = {}

    @property
    def triangles(self) -> np.ndarray:
        """(F, 3, 3) triangle vertex array."""
        if self._tri_cache is None or self._tri_cache.shape[0] != len(self.faces):
            self._tri_cache = self.vertices[self.faces]
        return self._tri_cache

    @property
    def bounds(self) -> np.ndarray:
        """(2, 3) [min; max] axis-aligned bounds."""
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    @property
    def face_normals(self) -> np.ndarray:
        """(F, 3) unit face normals."""
        tri = self.triangles
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.maximum(norm, 1e-30)

    @property
    def face_areas(self) -> np.ndarray:
        """(F,) triangle areas."""
        tri = self.triangles
        return 0.5 * np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
        )

    @property
    def area(self) -> float:
        return float(self.face_areas.sum())

    @property
    def is_watertight(self) -> bool:
        """True when every edge is shared by exactly two faces."""
        if len(self.faces) == 0:
            return False
        f = self.faces
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        _, counts = np.unique(edges, axis=0, return_counts=True)
        return bool(np.all(counts == 2))

    @property
    def is_convex(self) -> bool:
        """True for a connected, watertight mesh whose every edge is convex.

        For a convex enclosure no interior segment meets the surface, so the
        tracer skips its visibility queries exactly. The test is local (O(E)):
        each edge's two faces see each other's opposite vertex on one
        consistent side, and all referenced vertices form one component.
        """
        if self._is_convex is not None:
            return self._is_convex
        if len(self.faces) == 0 or not self.is_watertight:
            self._is_convex = False
            return False
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        f = self.faces
        ii = np.concatenate([f[:, 0], f[:, 1], f[:, 2]])
        jj = np.concatenate([f[:, 1], f[:, 2], f[:, 0]])
        adj = coo_matrix((np.ones(len(ii)), (ii, jj)), shape=(len(self.vertices),) * 2)
        _, labels = connected_components(adj, directed=False)
        referenced = np.zeros(len(self.vertices), dtype=bool)
        referenced[f.ravel()] = True
        if len(np.unique(labels[referenced])) > 1:
            self._is_convex = False
            return False
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        edges_sorted = np.sort(edges, axis=1)
        opposite = np.concatenate([f[:, 2], f[:, 0], f[:, 1]])
        face_of = np.tile(np.arange(len(f)), 3)
        _, inverse = np.unique(edges_sorted, axis=0, return_inverse=True)
        order = np.argsort(inverse.ravel(), kind="stable")
        fa, fb = face_of[order[0::2]], face_of[order[1::2]]
        ov_a, ov_b = opposite[order[0::2]], opposite[order[1::2]]
        tol = 1e-6 * float(np.max(np.ptp(self.vertices, axis=0)) + 1e-12)
        normals = self.face_normals
        anchors = self.vertices[f[:, 0]]
        s_ab = np.einsum("ek,ek->e", normals[fa], self.vertices[ov_b] - anchors[fa])
        s_ba = np.einsum("ek,ek->e", normals[fb], self.vertices[ov_a] - anchors[fb])
        s = np.concatenate([s_ab, s_ba])
        self._is_convex = bool(np.all(s >= -tol) or np.all(s <= tol))
        return self._is_convex

    def subdivided(self, levels: int = 1) -> "TriMesh":
        """Midpoint-subdivide each face into 4, `levels` times (watertight in,
        watertight out: midpoints are shared per edge)."""
        vertices = self.vertices.copy()
        faces = self.faces.copy()
        for _ in range(levels):
            n_v = len(vertices)
            e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
            uniq, inverse = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True)
            inverse = inverse.ravel()
            midpoints = 0.5 * (vertices[uniq[:, 0]] + vertices[uniq[:, 1]])
            vertices = np.concatenate([vertices, midpoints])
            f = len(faces)
            m01 = n_v + inverse[:f]
            m12 = n_v + inverse[f : 2 * f]
            m20 = n_v + inverse[2 * f :]
            a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
            faces = np.concatenate(
                [
                    np.stack([a, m01, m20], 1),
                    np.stack([m01, b, m12], 1),
                    np.stack([m20, m12, c], 1),
                    np.stack([m01, m12, m20], 1),
                ]
            )
        return TriMesh(vertices, faces.astype(np.int32), dict(self.metadata))

    def simplified(
        self, voxel: Optional[float] = None, target_faces: Optional[int] = None
    ) -> "TriMesh":
        """Vertex-clustering decimation: the acoustic LOD the energy tail traces.

        Snaps vertices to a `voxel` grid, merges each cluster to its mean,
        drops collapsed faces and deduplicates identical ones. With
        `target_faces` the voxel is found by geometric bisection so the result
        lands at or under the budget. Results are memoised on the mesh.
        """
        if (voxel is None) == (target_faces is None):
            raise ValueError("pass exactly one of voxel= or target_faces=")
        memo_key = ("v", float(voxel)) if voxel is not None else ("t", int(target_faces))
        if memo_key in self._simplify_memo:
            return self._simplify_memo[memo_key]
        if target_faces is not None:
            if len(self.faces) <= target_faces:
                return TriMesh(self.vertices.copy(), self.faces.copy(), dict(self.metadata))
            extent = float(np.max(self.bounds[1] - self.bounds[0]))
            lo, hi = extent / 4096.0, extent / 4.0
            best = None
            for _ in range(24):
                mid = float(np.sqrt(lo * hi))
                m = self._cluster(mid)
                if len(m.faces) > target_faces:
                    lo = mid
                else:
                    best = (mid, m)
                    hi = mid
                if hi / lo < 1.02:
                    break
            result = best[1] if best is not None else self._cluster(hi)
        else:
            result = self._cluster(float(voxel))
        self._simplify_memo[memo_key] = result
        return result

    def _cluster(self, voxel: float) -> "TriMesh":
        """Uncached vertex-clustering worker for `simplified` (one voxel size)."""
        v = self.vertices
        origin = v.min(axis=0)
        key = np.floor((v - origin) / float(voxel)).astype(np.int64)
        _, cluster, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
        cluster = cluster.ravel()
        rep = np.zeros((len(counts), 3), dtype=np.float64)
        np.add.at(rep, cluster, v)
        rep /= counts[:, None]

        f = cluster[self.faces]
        ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 2] != f[:, 0])
        f = f[ok]
        if len(f):
            # Canonical cyclic rotation keeps orientation, so an opposite-wound
            # twin (thin double-sided geometry) is not merged away.
            argmin = np.argmin(f, axis=1)
            canon = np.stack(
                [np.take_along_axis(f, (argmin[:, None] + k) % 3, axis=1)[:, 0] for k in range(3)],
                axis=1,
            )
            _, keep = np.unique(canon, axis=0, return_index=True)
            f = f[np.sort(keep)]
        meta = dict(self.metadata)
        meta["simplified_from_faces"] = len(self.faces)
        meta["simplified_voxel"] = float(voxel)
        return TriMesh(rep, f.astype(np.int32), meta)

    def jittered(self, amplitude: float, seed: int = 0) -> "TriMesh":
        """Displace vertices by uniform noise of +-`amplitude` (shared vertices
        move together, so watertightness is kept)."""
        rng = np.random.default_rng(seed)
        noise = rng.uniform(-amplitude, amplitude, self.vertices.shape)
        return TriMesh(self.vertices + noise, self.faces.copy(), dict(self.metadata))


def box_mesh(
    extents: Union[list, np.ndarray] = (1.0, 1.0, 1.0),
    center: Union[list, np.ndarray] = (0.0, 0.0, 0.0),
    inward_normals: bool = True,
) -> TriMesh:
    """An axis-aligned box (12 triangles). With `inward_normals` the box encloses
    an interior acoustic volume (a shoebox room); otherwise it is a solid."""
    ex = np.asarray(extents, dtype=float) / 2.0
    c = np.asarray(center, dtype=float)
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], dtype=float
    )
    vertices = corners * ex + c
    # Outward-wound faces of the unit box (corner indexing: bit2=x, bit1=y, bit0=z)
    faces = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        dtype=np.int32,
    )
    if inward_normals:
        faces = faces[:, ::-1]
    return TriMesh(vertices, faces, metadata=dict(fname="box", ftype="generated", fpath="box"))


def scanned_like_room(
    extents=(7.0, 5.0, 3.0),
    center=None,
    n_furniture: int = 8,
    subdivision_levels: int = 5,
    jitter: float = 0.015,
    seed: int = 0,
) -> TriMesh:
    """A dense, noisy, nonconvex interior resembling a 3D-scanned room: a box
    shell plus furniture/partition boxes, midpoint-subdivided and
    vertex-jittered (110,592 faces at the defaults)."""
    extents = np.asarray(extents, dtype=np.float64)
    if center is None:
        center = extents / 2
    rng = np.random.default_rng(seed)

    parts = [box_mesh(extents=extents, center=center)]
    lo = center - extents / 2
    for _ in range(max(0, int(n_furniture))):
        if rng.uniform() < 0.4:
            length = rng.uniform(0.3, 0.6) * extents[1]
            ext = np.array([rng.uniform(0.1, 0.25), length, extents[2] * 0.95])
            pos = lo + np.array([rng.uniform(0.25, 0.75) * extents[0], length / 2, ext[2] / 2])
        else:
            ext = rng.uniform([0.4, 0.4, 0.4], [1.6, 2.0, 1.3])
            pos = lo + np.array(
                [
                    rng.uniform(0.15, 0.85) * extents[0],
                    rng.uniform(0.15, 0.85) * extents[1],
                    ext[2] / 2,
                ]
            )
        parts.append(box_mesh(extents=ext, center=pos, inward_normals=False))

    vertices = np.concatenate([p.vertices for p in parts])
    faces_list, offset = [], 0
    for p in parts:
        faces_list.append(p.faces + offset)
        offset += len(p.vertices)
    mesh = TriMesh(vertices, np.concatenate(faces_list))
    mesh = mesh.subdivided(subdivision_levels)
    if jitter:
        mesh = mesh.jittered(jitter, seed=seed)
    mesh.metadata.update(fname=f"scanned_like_{seed}", fpath=f"synthetic://scanned_like_{seed}")
    return mesh
