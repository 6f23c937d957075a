"""Free space in a mesh room, for the traffic generator: plain numpy in
float64, importing nothing of the program.

A point is free when it lies inside the closed mesh (the parity of the
faces a ray from it along `PARITY_DIR` crosses) and at least `margin` from
every face (the exact distance to each triangle). A path of free points is
clear when no leg between consecutive points crosses a face.

The tests look only at the faces that can matter, through grids built once
per mesh and margin in a process:

* cubes as wide as the margin, each listing every face whose box, grown by
  the margin, meets it: a face within the margin of a point is listed in
  the point's cube;
* columns along `PARITY_DIR`, each listing every face whose shadow along
  that direction meets it: the ray from a point can cross only the faces
  of its column;
* cubes SUB times finer, which settle most points without a face: free
  where no face's box comes within the margin of the cube, near where a
  vertex lies in the cube or next to it.
"""

from __future__ import annotations

import functools

import numpy as np

# Off every axis and every diagonal of an axis-aligned room
PARITY_DIR = np.array([0.2113248654, 0.3780643156, 0.9013327842])
PARITY_DIR = PARITY_DIR / np.linalg.norm(PARITY_DIR)
COLUMN_M = 0.1
# Fine cubes a wide cube spans along an axis: over 2 sqrt(3), so that any
# two points of two neighbouring fine cubes lie within the margin
SUB = 4
_FREE, _OUT, _NEAR, _OPEN = 0, 1, 2, 3
_DET_EPS = 1e-12


def _dot(a, b):
    return np.einsum("...i,...i->...", a, b)


def point_triangle_dist2(p, a, b, c) -> np.ndarray:
    """Squared distance from points p to triangles (a, b, c), pairwise:
    the closest point by its Voronoi region (Ericson, Real-Time Collision
    Detection, 5.1.5)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2

    def ratio(num, den):
        return np.clip(num / np.where(den == 0.0, 1.0, den), 0.0, 1.0)[..., None]

    denom = va + vb + vc
    safe = np.where(denom == 0.0, 1.0, denom)
    q = a + (vb / safe)[..., None] * ab + (vc / safe)[..., None] * ac
    # Ericson returns at the first region that holds, in the reverse of
    # this order: here the last assignment wins
    regions = (
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), b + ratio(d4 - d3, (d4 - d3) + (d5 - d6)) * (c - b)),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ratio(d2, d2 - d6) * ac),
        ((d6 >= 0) & (d5 <= d6), np.broadcast_to(c, q.shape)),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ratio(d1, d1 - d3) * ab),
        ((d3 >= 0) & (d4 <= d3), np.broadcast_to(b, q.shape)),
        ((d1 <= 0) & (d2 <= 0), np.broadcast_to(a, q.shape)),
    )
    for mask, point in regions:
        q = np.where(mask[..., None], point, q)
    diff = p - q
    return _dot(diff, diff)


def ray_crosses(o, d, a, b, c, t_max=np.inf) -> np.ndarray:
    """Whether o + t d, 0 < t < t_max, crosses triangle (a, b, c), pairwise
    (Moller and Trumbore)."""
    e1, e2 = b - a, c - a
    pvec = np.cross(d, e2)
    det = _dot(e1, pvec)
    ok = np.abs(det) > _DET_EPS
    inv = 1.0 / np.where(ok, det, 1.0)
    tvec = o - a
    u = _dot(tvec, pvec) * inv
    qvec = np.cross(tvec, e1)
    v = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    return ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t < t_max)


def _csr(keys: np.ndarray, items: np.ndarray, n: int) -> tuple:
    """(start (n + 1,), items sorted by key) of (key, item) pairs."""
    order = np.argsort(keys, kind="stable")
    return np.searchsorted(keys[order], np.arange(n + 1)), items[order]


def _pairs(lo: np.ndarray, hi: np.ndarray) -> tuple:
    """Every integer cell (i, ...) with lo <= i <= hi per row, as (row, cell (k, D))."""
    span = hi - lo + 1
    count = np.prod(span, axis=1)
    row = np.repeat(np.arange(len(lo)), count)
    k = np.arange(len(row)) - np.repeat(np.cumsum(count) - count, count)
    cells = np.empty((len(row), lo.shape[1]), dtype=np.int64)
    for axis in range(lo.shape[1] - 1, -1, -1):
        s = span[row, axis]
        cells[:, axis] = lo[row, axis] + k % s
        k //= s
    return row, cells


def _grow(mask: np.ndarray, k: int) -> np.ndarray:
    """`mask` with every cell within k cells of a set one set, along each axis."""
    for axis in range(mask.ndim):
        grown = mask.copy()
        for s in range(1, k + 1):
            head = tuple(slice(s, None) if d == axis else slice(None) for d in range(mask.ndim))
            tail = tuple(slice(None, -s) if d == axis else slice(None) for d in range(mask.ndim))
            grown[head] |= mask[tail]
            grown[tail] |= mask[head]
        mask = grown
    return mask


def _flat(cells, shape):
    return (cells[..., 0] * shape[1] + cells[..., 1]) * shape[2] + cells[..., 2]


class MeshSpace:
    """Where sources and the rig may stand in a closed triangle mesh: inside
    it and at least `margin` from every face. The traffic's `FreeSpace` for
    a mesh room."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray, margin: float):
        self.margin = float(margin)
        tri = np.asarray(vertices, dtype=np.float64)[np.asarray(faces)]
        self.a, self.b, self.c = tri[:, 0].copy(), tri[:, 1].copy(), tri[:, 2].copy()
        self.centre = tri.mean(axis=1)
        self.radius = np.linalg.norm(tri - self.centre[:, None], axis=2).max(axis=1)
        n = np.cross(self.b - self.a, self.c - self.a)
        self.normal = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)
        lo, hi = tri.reshape(-1, 3).min(axis=0), tri.reshape(-1, 3).max(axis=0)
        # A point inside the mesh and within the margin of its box is within
        # the margin of a face: draw only in the box shrunk by it
        self.lo, self.hi = lo + self.margin, hi - self.margin
        self.origin = lo - 1e-6
        self.shape = np.floor((hi - self.origin) / self.margin).astype(np.int64) + 1
        grow = self.margin * (1 + 1e-9) + 1e-9
        row, cells = _pairs(self._cube(tri.min(axis=1) - grow), self._cube(tri.max(axis=1) + grow))
        self.cube_start, self.cube_faces = _csr(_flat(cells, self.shape), row, int(np.prod(self.shape)))
        # Each listed face's centre, and the square of the margin and its radius
        self.cube_centre = self.centre[self.cube_faces]
        self.cube_reach2 = (self.margin + self.radius[self.cube_faces]) ** 2
        # Columns along PARITY_DIR: the faces' shadows on the plane across it
        u = np.cross(PARITY_DIR, [1.0, 0.0, 0.0])
        u /= np.linalg.norm(u)
        self.uv = np.stack([u, np.cross(PARITY_DIR, u)])
        proj = (tri @ self.uv.T).reshape(-1, 2)
        self.col_origin = proj.min(axis=0) - 1e-6
        self.col_shape = np.floor((proj.max(axis=0) - self.col_origin) / COLUMN_M).astype(np.int64) + 1
        proj = proj.reshape(-1, 3, 2)
        row, cols = _pairs(self._column(proj.min(axis=1)), self._column(proj.max(axis=1)))
        self.col_start, self.col_faces = _csr(cols[:, 0] * self.col_shape[1] + cols[:, 1], row,
                                              int(np.prod(self.col_shape)))
        # Each cube's centre's side of the mesh, the side of every point of
        # the cube that is the margin from each face: the centre lies within
        # sqrt(3) / 2 margins of it, and no face comes that near
        idx = np.stack(np.unravel_index(np.arange(int(np.prod(self.shape))), self.shape), axis=1)
        self.cube_inside = self.inside(self.origin + (idx + 0.5) * self.margin)
        # The fine cubes. Where no face's box meets the fine cubes within SUB
        # of one, every face lies the margin or more from each of its points,
        # which lie on the side of their cube's centre. Where a vertex lies
        # in the fine cubes within 1 of one, each of its points lies within
        # 2 sqrt(3) / SUB margins of that vertex
        fine = self.shape * SUB
        box = np.zeros(fine, dtype=bool)
        box[tuple(_pairs(self._fine(tri.min(axis=1)), self._fine(tri.max(axis=1)))[1].T)] = True
        vertex = np.zeros(fine, dtype=bool)
        vertex[tuple(self._fine(tri.reshape(-1, 3)).T)] = True
        clear = ~_grow(box, SUB)
        inside = np.repeat(np.repeat(np.repeat(self.cube_inside.reshape(self.shape), SUB, 0), SUB, 1), SUB, 2)
        state = np.full(fine, _OPEN, dtype=np.int8)
        state[clear & inside] = _FREE
        state[clear & ~inside] = _OUT
        state[_grow(vertex, 1)] = _NEAR
        self.fine_state = state.ravel()

    def _cube(self, pts):
        return np.clip(np.floor((pts - self.origin) / self.margin).astype(np.int64), 0, self.shape - 1)

    def _fine(self, pts):
        return np.clip(np.floor((pts - self.origin) * (SUB / self.margin)).astype(np.int64), 0,
                       self.shape * SUB - 1)

    def _column(self, uv):
        return np.clip(np.floor((uv - self.col_origin) / COLUMN_M).astype(np.int64), 0, self.col_shape - 1)

    def inside(self, pts: np.ndarray) -> np.ndarray:
        """(N,) whether each point lies inside the mesh: the faces the ray
        along PARITY_DIR crosses, counted, are odd."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        col = self._column(pts @ self.uv.T)
        keys = col[:, 0] * self.col_shape[1] + col[:, 1]
        count = self.col_start[keys + 1] - self.col_start[keys]
        row = np.repeat(np.arange(len(pts)), count)
        first = np.repeat(self.col_start[keys] - (np.cumsum(count) - count), count)
        f = self.col_faces[first + np.arange(len(row))]
        hits = ray_crosses(pts[row], PARITY_DIR, self.a[f], self.b[f], self.c[f])
        return np.bincount(row[hits], minlength=len(pts)) % 2 == 1

    def _near(self, p: np.ndarray, cube: int) -> bool:
        """Whether a face lies nearer than the margin to the point p, in the
        cube `cube`. Of the faces the cube lists, one is that near where its
        centre is, and can be only where its centre lies within the margin
        and its radius and its plane within the margin; the exact distance
        is taken where these bounds do not decide."""
        s, e = self.cube_start[cube], self.cube_start[cube + 1]
        v = self.cube_centre[s:e] - p
        d2 = _dot(v, v)
        if len(d2) and d2.min() < self.margin**2:
            return True
        f = self.cube_faces[s:e][d2 <= self.cube_reach2[s:e]]
        f = f[np.abs(_dot(self.normal[f], p - self.a[f])) < self.margin]
        return bool(np.any(point_triangle_dist2(p, self.a[f], self.b[f], self.c[f]) < self.margin**2))

    def ok(self, pts: np.ndarray) -> bool:
        """Whether every point is free: in the drawing box, inside the mesh,
        and at least the margin from every face. Its fine cube settles a
        point, or its cube's side of the mesh and `_near` do."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        state = self.fine_state[_flat(self._fine(pts), self.shape * SUB)]
        if not np.all((pts >= self.lo) & (pts <= self.hi)) or np.any((state == _OUT) | (state == _NEAR)):
            return False
        open_ = np.flatnonzero(state == _OPEN)
        cube = _flat(self._cube(pts[open_]), self.shape)
        return bool(self.cube_inside[cube].all()) and not any(self._near(pts[i], c) for i, c in zip(open_, cube))

    def clear(self, pts: np.ndarray) -> bool:
        """Whether no leg between consecutive free points crosses a face.
        A face that a leg crosses lies at least the margin from both ends,
        so only a leg longer than 2 margins can cross one; such a leg is
        sampled at most 2 margins apart, and a face it crosses is within the
        margin of a sample, so listed in the sample's cube."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        for a, b in zip(pts[:-1], pts[1:]):
            n = int(np.ceil(np.linalg.norm(b - a) / (2 * self.margin)))
            if n <= 1:
                continue
            cubes = np.unique(_flat(self._cube(a + np.linspace(0.0, 1.0, n + 1)[:, None] * (b - a)), self.shape))
            f = np.unique(np.concatenate([self.cube_faces[self.cube_start[c]:self.cube_start[c + 1]] for c in cubes]))
            if np.any(ray_crosses(a, b - a, self.a[f], self.b[f], self.c[f], 1.0)):
                return False
        return True

    def point(self, rng, z_range=None) -> np.ndarray:
        if z_range is None:
            return rng.uniform(self.lo, self.hi)
        lo, hi = self.lo.copy(), self.hi.copy()
        lo[2], hi[2] = max(lo[2], z_range[0]), min(hi[2], z_range[1])
        return rng.uniform(lo, hi)


@functools.lru_cache(maxsize=None)
def space(name: str, margin: float) -> MeshSpace:
    """The MeshSpace of `meshes/<name>.npz`, built once per process."""
    from portbench import manifest

    return MeshSpace(*manifest.load_mesh(name), margin)
