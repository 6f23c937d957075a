"""Host-side triangle mesh (numpy): the port's copy of audiblelight_tpu's TriMesh.

Derived quantities, the convexity test that switches occlusion off, mesh
repair (degenerate faces, winding), midpoint subdivision, vertex-clustering
decimation (the acoustic LOD), glTF/GLB, OBJ and PLY files, and the two
synthetic room generators. The arithmetic is kept line for line with the
reference so both packages build the same triangles, the same repair and
the same LOD from the same seed.
"""

from __future__ import annotations

from pathlib import Path
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
        self.visuals = None  # io.gltf.MeshVisuals of a glTF mesh with a material layer
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
    def centroid(self) -> np.ndarray:
        """Mean of the vertices (the world state's serialised mesh centroid)."""
        return self.vertices.mean(axis=0)

    def broken_faces(self) -> np.ndarray:
        """Indices of faces with an edge not shared by exactly two faces."""
        f = self.faces
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        _, inverse, counts = np.unique(edges, axis=0, return_inverse=True, return_counts=True)
        bad_edge = counts[inverse.ravel()] != 2
        return np.flatnonzero(bad_edge.reshape(3, len(f)).any(axis=0))

    def remove_degenerate_faces(self) -> int:
        """Drop zero-area faces in place; returns the number removed."""
        keep = self.face_areas > 1e-12
        removed = int((~keep).sum())
        if removed:
            self.faces = self.faces[keep]
            self._tri_cache = None
        return removed

    def fix_winding(self) -> None:
        """Orient faces consistently by propagating the winding across shared
        edges: the reference's walk (seeds in face order, a stack, each
        edge's faces in face order), over Python lists."""
        f = self.faces.tolist()
        n_faces = len(f)
        if n_faces == 0:
            return
        edge_map: dict = {}
        for fi, (a, b, c) in enumerate(f):
            for u, v in ((a, b), (b, c), (c, a)):
                edge_map.setdefault((u, v) if u < v else (v, u), []).append((fi, u, v))

        visited = [False] * n_faces
        flip = [False] * n_faces
        for seed in range(n_faces):
            if visited[seed]:
                continue
            stack = [seed]
            visited[seed] = True
            while stack:
                fi = stack.pop()
                fa = f[fi][::-1] if flip[fi] else f[fi]
                directed = {(fa[0], fa[1]), (fa[1], fa[2]), (fa[2], fa[0])}
                for u, v in ((fa[0], fa[1]), (fa[1], fa[2]), (fa[2], fa[0])):
                    for fj, ja, jb in edge_map.get((u, v) if u < v else (v, u), ()):
                        if fj == fi or visited[fj]:
                            continue
                        # Coherent winding: the two faces traverse their
                        # shared edge in opposite directions
                        if (ja, jb) in directed:
                            flip[fj] = True
                        visited[fj] = True
                        stack.append(fj)
        flip = np.asarray(flip)
        if flip.any():
            self.faces[flip] = self.faces[flip][:, ::-1]
            self._tri_cache = None

    def repair(self) -> None:
        """Best-effort in-place repair: degenerate removal, then the winding fix."""
        from audiblelight_tpu_torch.utils import logger

        self.remove_degenerate_faces()
        self.fix_winding()
        logger.info(f"Broken faces after repair: {len(self.broken_faces())}")

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


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def _load_obj(path: Path) -> tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                # 1-based; negative indices count back from the vertices so far
                raw = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [r - 1 if r > 0 else len(verts) + r for r in raw]
                for i in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32)


_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def _load_ply(path: Path) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts = n_faces = 0
        fmt, props, face_types, current = "ascii", [], ("uchar", "int"), None
        for line in header:
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "format":
                fmt = toks[1]
            elif toks[0] == "element":
                current = toks[1]
                if current == "vertex":
                    n_verts = int(toks[2])
                elif current == "face":
                    n_faces = int(toks[2])
            elif toks[0] == "property" and current == "vertex":
                props.append((toks[-1], toks[1]))
            elif toks[0] == "property" and current == "face" and toks[1] == "list":
                face_types = (toks[2], toks[3])
        faces = []
        if fmt == "ascii":
            verts = []
            for _ in range(n_verts):
                vals = f.readline().split()
                verts.append([float(vals[i]) for i, (nm, _) in enumerate(props) if nm in "xyz"][:3])
            for _ in range(n_faces):
                vals = [int(x) for x in f.readline().split()]
                cnt, idx = vals[0], vals[1:]
                for i in range(1, cnt - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
            return np.asarray(verts), np.asarray(faces, dtype=np.int32)
        if fmt != "binary_little_endian":
            raise ValueError(f"Unsupported PLY format '{fmt}' in {path} "
                             "(ascii and binary_little_endian are supported)")
        dtype = np.dtype([(nm, _PLY_TYPES[tp]) for nm, tp in props])
        vdata = np.frombuffer(f.read(dtype.itemsize * n_verts), dtype=dtype)
        verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], axis=1).astype(np.float64)
        cnt_dt, idx_dt = np.dtype(_PLY_TYPES[face_types[0]]), np.dtype(_PLY_TYPES[face_types[1]])
        for _ in range(n_faces):
            cnt = int(np.frombuffer(f.read(cnt_dt.itemsize), dtype=cnt_dt)[0])
            idx = np.frombuffer(f.read(idx_dt.itemsize * cnt), dtype=idx_dt)
            for i in range(1, cnt - 1):
                faces.append([idx[0], idx[i], idx[i + 1]])
        return verts, np.asarray(faces, dtype=np.int32)


def load_mesh(mesh_fpath: Union[str, Path]) -> TriMesh:
    """Load a glTF/GLB, OBJ or PLY mesh and coerce its units to metres.
    Metadata carries the file's stem, suffix and path; a glTF mesh keeps its
    material layer in `visuals`. A mesh over 1000 units across is taken as
    millimetres; over 100, as centimetres, except a glTF mesh, whose units
    are metres by the format's spec."""
    from audiblelight_tpu_torch.utils import logger, sanitise_filepath

    mesh_fpath = sanitise_filepath(mesh_fpath)
    suffix = mesh_fpath.suffix.lower()
    visuals = None
    if suffix in (".glb", ".gltf"):
        from audiblelight_tpu_torch.io.gltf import load_gltf

        vertices, faces, visuals = load_gltf(mesh_fpath, with_visuals=True)
    elif suffix == ".obj":
        vertices, faces = _load_obj(mesh_fpath)
    elif suffix == ".ply":
        vertices, faces = _load_ply(mesh_fpath)
    else:
        raise ValueError(f"Unsupported mesh format: {suffix}")
    mesh = TriMesh(vertices, faces,
                   metadata=dict(fname=mesh_fpath.stem, ftype=mesh_fpath.suffix, fpath=str(mesh_fpath)))
    mesh.visuals = visuals
    extent = np.max(mesh.bounds[1] - mesh.bounds[0])
    units_defined = suffix in (".glb", ".gltf")
    factor = 1000.0 if extent > 1000.0 else (100.0 if (extent > 100.0 and not units_defined) else 1.0)
    if factor != 1.0:
        unit = "millimetres" if factor == 1000.0 else "centimetres"
        logger.warning(f"Mesh {mesh_fpath.stem} spans {extent:.0f} units; assuming {unit} "
                       "and converting to meters")
        mesh.vertices = mesh.vertices / factor
        mesh._tri_cache = None
    return mesh


def save_obj(mesh: TriMesh, path: Union[str, Path]) -> Path:
    """Write `mesh` as a Wavefront OBJ whose vertices read back exactly."""
    path = Path(path)
    with open(path, "w") as f:
        f.writelines(f"v {x!r} {y!r} {z!r}\n" for x, y, z in mesh.vertices.tolist())
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in mesh.faces.tolist())
    return path


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
