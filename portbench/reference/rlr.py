"""The reference of the rlr backend: a stochastic ray tracer over a closed
triangle mesh, worked out in float64 by brute force.

What the configuration states, stage by stage:

* The acoustic LOD: the mesh's vertices clustered on a voxel grid from the
  vertices' least corner (each cluster at the mean of its members), faces
  that collapse dropped and repeated faces (the same vertices in the same
  cyclic order) kept once; the voxel is bisected geometrically between a
  4096th and a quarter of the mesh's longest side, at most 24 times or
  until the bounds lie within 2 % of each other, to the finest voxel whose
  LOD has at most `LOD_FACES` faces. A mesh within the budget is its own
  LOD.
* The face properties: absorption `DEFAULT_ABSORPTION` in every band times
  the mesh's area over the LOD's (clipped to [0, 1]), scattering
  `DEFAULT_SCATTERING`.
* The rain table: a LOD face is hidden when the segment from its centroid
  (moved 1e-4 m off the face toward the rig) to the mean of the capsules
  crosses a LOD face.
* A segment is blocked by a face that a point of it strictly between 1e-4
  m from either end lies on (Moller-Trumbore, barycentric slack 1e-9).
* The tail: every source sends `indirect_ray_count` rays along the
  normalised standard normal draws, each with 1 / rays of the energy in
  each band. A bounce takes each live ray to its nearest face (t > 1e-9,
  the lowest face on a tie), takes the absorbed share off, deposits
  energy x cos / (4 pi^2 max(d, 0.01)^2) toward each capsule that sees the
  face (rain table), cos the angle between the face's normal (turned to
  meet the ray) and the capsule, d its distance, in the bin of arrival
  (path + d) / c over `HIST_BIN_DT` where that bin is inside the
  histogram, and leaves 1e-4 m off the face: diffusely (cosine-weighted
  about the normal) where its roulette draw falls under the scattering,
  else specularly. It lives on while it hit a face, its peak band energy
  times the rays a source is exceeds 1e-6, and its path is shorter than c
  times the histogram's span. The loop stops once every ray of the scene
  is dead, or after `indirect_ray_depth` bounces.
* The responses: per (source, capsule, band) a white carrier drawn from
  the scene's generator, shaped by the band's log-frequency weight, over
  its RMS, times the histogram's envelope sqrt(E / bin samples) linearly
  interpolated between bin centres, summed over the bands; plus the
  direct path (a Hann-windowed sinc of 65 taps at d / c with amplitude
  1 / (4 pi max(d, 0.01)), zero where the full mesh blocks it); plus,
  where it is blocked, knife-edge diffraction: the clear bend of least
  detour on a polar lattice (16 angles, 12 radii 0.05-4 m) in the
  mid-plane between source and rig centre, else the least path through 4
  stations of 48 lattice points each, each bend attenuating by
  10 log10(3 + 40 delta f / c) dB, delivered as a linear-phase spectrum.
  Of lattice points of equal detour (a radius's angles, which exact
  arithmetic cannot tell apart) the first in lattice order is taken.
* The audio (`reference.audio`): the stems of a static or a moving event
  as the shoebox's, no per-stem quantisation, each placed at its onset;
  the white bed drawn from the scene's generator after the carriers,
  peak-normalised per channel and scaled to a mean |x| of 10^(ref_db /
  20); the sum clipped, times 32767, truncated.

The draws are the program's: one generator a scene, seeded from the world
state's trace walk, on the program's device type, each draw in float32 in
the order and the sizes the configuration states. So the reference follows
the program's rays, and what is left between them is float32's rounding
(and the rays it sends to another face). `lowp` rounds each stage's output
(the ray state after each bounce, the histograms, the carriers, the
responses, and the audio stages'): the identity for the reference,
bfloat16 for the control.
"""

from __future__ import annotations

import functools
import hashlib
import math

import numpy as np
import torch

from portbench import manifest
from portbench.reference import audio

F64 = torch.float64
# The engine's settings that the CLI leaves at the program's defaults: the
# LOD's face budget, the bands, the histogram's bin (s), the diffraction
# order, the speed of sound (m/s) and every face's default properties
LOD_FACES, BANDS, HIST_BIN_DT = 4096, 4, 0.002
MAX_DIFFRACTION_ORDER, SPEED_OF_SOUND = 10, 343.0
DEFAULT_ABSORPTION, DEFAULT_SCATTERING = 0.1, 0.5
# The barycentric slack and least t of a first hit; a segment's end margin
EDGE, T_MIN, MARGIN = 1e-9, 1e-9, 1e-4
# Rays off a face they leave, and a rain segment's start
OFFSET = 1e-4
# (ray, face) pairs a block of the brute-force tests takes at once
PAIRS = 1 << 24
# Meshes of at least this many faces check diffraction legs on their LOD
GRAPH_LOD_MIN_FACES = 16384


# ---------------------------------------------------------------------------
# The acoustic LOD
# ---------------------------------------------------------------------------


def cluster(vertices: np.ndarray, faces: np.ndarray, voxel: float) -> tuple:
    """(vertices, faces) of the mesh clustered on a grid of `voxel` metres."""
    origin = vertices.min(axis=0)
    key = np.floor((vertices - origin) / voxel).astype(np.int64)
    _, member, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    member = member.ravel()
    rep = np.zeros((len(counts), 3))
    np.add.at(rep, member, vertices)
    rep /= counts[:, None]
    f = member[faces]
    f = f[(f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 2] != f[:, 0])]
    if len(f):
        lead = np.argmin(f, axis=1)
        rows = np.arange(len(f))
        canon = np.stack([f[rows, (lead + k) % 3] for k in range(3)], axis=1)
        _, first = np.unique(canon, axis=0, return_index=True)
        f = f[np.sort(first)]
    return rep, f.astype(np.int32)


def lod(vertices: np.ndarray, faces: np.ndarray, budget: int) -> tuple:
    """The acoustic LOD (vertices, faces) of a mesh under `budget` faces."""
    if len(faces) <= budget:
        return vertices.copy(), faces.copy()
    extent = float(np.max(vertices.max(axis=0) - vertices.min(axis=0)))
    lo, hi = extent / 4096.0, extent / 4.0
    best = None
    for _ in range(24):
        mid = float(np.sqrt(lo * hi))
        m = cluster(vertices, faces, mid)
        if len(m[1]) > budget:
            lo = mid
        else:
            best, hi = m, mid
        if hi / lo < 1.02:
            break
    return best if best is not None else cluster(vertices, faces, hi)


def area(tris: np.ndarray) -> float:
    return float(0.5 * np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=1).sum())


class Faces:
    """Triangles on a device in float64, with the per-face terms of the
    brute-force ray test: a corner a, edges e1 and e2, n = e1 x e2, a x e1,
    a x e2 and a . n (coordinates about `centre`)."""

    def __init__(self, tris: np.ndarray, centre: np.ndarray, device):
        t = torch.as_tensor(tris - centre, dtype=F64, device=device)
        self.count = t.shape[0]
        self.a, self.e1, self.e2 = t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
        self.n = torch.linalg.cross(self.e1, self.e2, dim=-1)
        self.ae1 = torch.linalg.cross(self.a, self.e1, dim=-1)
        self.ae2 = torch.linalg.cross(self.a, self.e2, dim=-1)
        self.an = (self.a * self.n).sum(-1)

    def pairs(self, o: torch.Tensor, d: torch.Tensor, det_min: float) -> tuple:
        """(inside, t) of rays o + t d (R, 3) against every face, (R, F)
        each: Moller-Trumbore's u, v and t as scalar triple products."""
        m = torch.linalg.cross(o, d, dim=-1)
        det = -(d @ self.n.T)
        ok = det.abs() > det_min
        det = torch.where(ok, det, torch.ones_like(det))
        u = (m @ self.e2.T + d @ self.ae2.T) / det
        v = -(m @ self.e1.T + d @ self.ae1.T) / det
        t = (o @ self.n.T - self.an) / det
        return ok & (u >= -EDGE) & (u <= 1 + EDGE) & (v >= -EDGE) & (u + v <= 1 + EDGE), t

    @property
    def step(self) -> int:
        """Rays a block of the tests takes."""
        return max(1, PAIRS // max(self.count, 1))

    def first_hit(self, o: torch.Tensor, d: torch.Tensor) -> tuple:
        """(t, face) of each ray's nearest face, (inf, -1) on a miss. A mesh
        of more than 512 faces takes every non-zero determinant, a smaller
        one those over 1e-9, as the program's two tests do."""
        det_min = 0.0 if self.count > 512 else 1e-9
        t_out = torch.full((len(o),), math.inf, dtype=F64, device=o.device)
        f_out = torch.full((len(o),), -1, dtype=torch.int64, device=o.device)
        step = self.step
        for r0 in range(0, len(o), step):
            inside, t = self.pairs(o[r0 : r0 + step], d[r0 : r0 + step], det_min)
            t = torch.where(inside & (t > T_MIN), t, math.inf)
            best, face = t.min(dim=1)
            t_out[r0 : r0 + step] = best
            f_out[r0 : r0 + step] = torch.where(torch.isfinite(best), face, -1)
        return t_out, f_out

    def blocked(self, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
        """(R,) True where a face crosses the open segment start -> end."""
        seg = ends - starts
        length = torch.linalg.vector_norm(seg, dim=-1)
        d = seg / length.clamp_min(1e-9)[:, None]
        out = torch.zeros(len(starts), dtype=torch.bool, device=starts.device)
        step = self.step
        for r0 in range(0, len(starts), step):
            inside, t = self.pairs(starts[r0 : r0 + step], d[r0 : r0 + step], 1e-9)
            out[r0 : r0 + step] = (inside & (t > MARGIN) & (t < (length[r0 : r0 + step] - MARGIN)[:, None])).any(1)
        return out


class Room:
    """A mesh room on a device: its full faces, its LOD's faces, normals and
    properties, the faces diffraction legs are checked against."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray, device):
        self.centre = 0.5 * (vertices.min(axis=0) + vertices.max(axis=0))
        full = vertices[faces]
        lv, lf = lod(vertices, faces, LOD_FACES)
        tris = lv[lf]
        self.lod_vertices, self.lod_faces = lv, lf
        self.full = Faces(full, self.centre, device)
        self.lod = Faces(tris, self.centre, device)
        self.legs = self.lod if len(faces) >= GRAPH_LOD_MIN_FACES else self.full
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        self.normals = torch.as_tensor(n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30), dtype=F64,
                                       device=device)
        self.centroids = torch.as_tensor(tris.mean(axis=1) - self.centre, dtype=F64, device=device)
        alpha = min(max(DEFAULT_ABSORPTION * area(full) / area(tris), 0.0), 1.0)
        self.absorption = torch.full((len(tris), BANDS), alpha, dtype=F64, device=device)
        self.scattering = DEFAULT_SCATTERING


@functools.lru_cache(maxsize=4)
def _room(name: str, digest: str, device: str) -> Room:
    v, f = manifest.load_mesh(name)
    return Room(v, f, torch.device(device))


def room_of(config: dict, spec: dict, device) -> Room:
    """The scene's room, built once per mesh and device."""
    vertices, faces = manifest.load_mesh(spec["room"]["mesh"])
    digest = hashlib.sha256(vertices.tobytes() + faces.tobytes()).hexdigest()
    return _room(spec["room"]["mesh"], digest, str(torch.device(device)))


# ---------------------------------------------------------------------------
# The tail
# ---------------------------------------------------------------------------


def trace_seed(state_seed: int) -> int:
    """The first seed of the world state's trace walk."""
    return int(np.random.SeedSequence([int(state_seed), 0]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def rain_table(room: Room, point: torch.Tensor) -> torch.Tensor:
    """(F',) True where the LOD face's centroid cannot see `point`."""
    to_p = point[None] - room.centroids
    n = torch.where(((room.normals * to_p).sum(-1) >= 0)[:, None], room.normals, -room.normals)
    starts = room.centroids + OFFSET * n
    return room.lod.blocked(starts, point[None].expand_as(starts))


def _helper_axis(v: torch.Tensor) -> torch.Tensor:
    use_x = (v[:, 0].abs() < 0.9).to(v.dtype)
    return torch.stack([use_x, 1.0 - use_x, torch.zeros_like(use_x)], dim=-1)


def _unit(v: torch.Tensor, tiny: float) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(tiny)


def histograms(gen, room: Room, sources: torch.Tensor, caps: torch.Tensor, hidden: torch.Tensor, eng: dict,
               n_bins: int, lowp) -> tuple:
    """((S, C, bands, n_bins) energy histograms, bounces run)."""
    dev = sources.device
    n_rays, depth = int(eng["indirect_ray_count"]), min(int(eng["indirect_ray_depth"]), 200)
    bin_dt, c = HIST_BIN_DT, SPEED_OF_SOUND
    n_src, n_caps, n_bands = len(sources), len(caps), BANDS
    rows = n_src * n_rays
    dirs = torch.randn((rows, 3), generator=gen, device=dev).to(F64)
    d = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    o = sources.repeat_interleave(n_rays, dim=0)
    energy = torch.full((rows, n_bands), 1.0 / n_rays, dtype=F64, device=dev)
    dist = torch.zeros(rows, dtype=F64, device=dev)
    alive = torch.ones(rows, dtype=torch.bool, device=dev)
    hist = torch.zeros((n_src * n_caps * n_bins, n_bands), dtype=F64, device=dev)
    source = torch.arange(rows, device=dev) // n_rays
    bounces = 0
    for _ in range(depth):
        if not bool(alive.any()):
            break
        bounces += 1
        live = alive.nonzero().squeeze(1)
        t, face = room.lod.first_hit(o[live], d[live])
        u1 = torch.rand(rows, generator=gen, device=dev).to(F64)[live]
        u2 = torch.rand(rows, generator=gen, device=dev).to(F64)[live]
        roulette = torch.rand(rows, generator=gen, device=dev).to(F64)[live]
        ok = torch.isfinite(t)
        live, t, face, u1, u2, roulette = live[ok], t[ok], face[ok], u1[ok], u2[ok], roulette[ok]
        dl = d[live]
        hit = o[live] + t[:, None] * dl
        new_dist = dist[live] + t
        n = room.normals[face]
        n = torch.where(((n * dl).sum(-1) > 0)[:, None], -n, n)
        e_refl = energy[live] * (1.0 - room.absorption[face])
        seen = ~hidden[face]
        for k in range(n_caps):
            v = caps[k][None] - hit
            dd = torch.linalg.vector_norm(v, dim=-1)
            cos = ((v * n).sum(-1) / dd.clamp_min(1e-9)).clamp_min(0.0)
            b = torch.floor((new_dist + dd) / c / bin_dt)
            keep = seen & (cos > 0) & (b < n_bins)
            geom = cos / (4.0 * math.pi**2 * dd.clamp_min(1e-2) ** 2)
            row = (source[live] * n_caps + k) * n_bins + b.clamp(0, n_bins - 1).long()
            hist.index_add_(0, row[keep], (e_refl * geom[:, None])[keep])
        spec = dl - 2.0 * (dl * n).sum(-1, keepdim=True) * n
        t1 = _unit(torch.linalg.cross(n, _helper_axis(n), dim=-1), 1e-12)
        t2 = torch.linalg.cross(n, t1, dim=-1)
        rad, phi = torch.sqrt(u1), 2.0 * math.pi * u2
        diffuse = (rad * torch.cos(phi))[:, None] * t1 + (rad * torch.sin(phi))[:, None] * t2 \
            + torch.sqrt(1.0 - u1)[:, None] * n
        alive = torch.zeros_like(alive)
        alive[live] = (e_refl.amax(-1) * n_rays > 1e-6) & (new_dist < c * n_bins * bin_dt)
        o[live] = lowp(hit + OFFSET * n)
        d[live] = lowp(torch.where((roulette < room.scattering)[:, None], diffuse, spec))
        energy[live] = lowp(e_refl)
        dist[live] = lowp(new_dist)
    hist = hist.reshape(n_src, n_caps, n_bins, n_bands).permute(0, 1, 3, 2)
    return lowp(hist), bounces


def band_centres(n_bands: int, device) -> torch.Tensor:
    f = np.geomspace(125.0, 8000.0, n_bands) if n_bands > 1 else np.array([1000.0])
    return torch.as_tensor(f, dtype=F64, device=device)


def band_weights(freqs: torch.Tensor, centres: torch.Tensor) -> torch.Tensor:
    """(bands, freqs) weights linear in log frequency between the band
    centres, held at the ends; each frequency's sum to 1."""
    if len(centres) == 1:
        return torch.ones((1, len(freqs)), dtype=F64, device=freqs.device)
    logf, logb = torch.log(freqs.clamp_min(1.0)), torch.log(centres)
    hi = torch.searchsorted(logb, logf).clamp(1, len(centres) - 1)
    lo = hi - 1
    w_hi = ((logf - logb[lo]) / (logb[hi] - logb[lo])).clamp(0.0, 1.0)
    w = torch.zeros((len(centres), len(freqs)), dtype=F64, device=freqs.device)
    cols = torch.arange(len(freqs), device=freqs.device)
    w[lo, cols] += 1.0 - w_hi
    w[hi, cols] += w_hi
    return w


def tail(gen, hist: torch.Tensor, n: int, sr: int, bin_dt: float, lowp) -> torch.Tensor:
    """(S, C, n) responses of the histograms (S, C, bands, bins)."""
    dev = hist.device
    freqs = torch.arange(n // 2 + 1, dtype=F64, device=dev) * (sr / n)
    shape = torch.sqrt(band_weights(freqs, band_centres(hist.shape[2], dev)))
    white = torch.randn(hist.shape[:3] + (n,), generator=gen, device=dev).to(F64)
    carriers = lowp(torch.fft.irfft(torch.fft.rfft(white) * shape, n=n))
    carriers = carriers / torch.sqrt((carriers**2).mean(-1, keepdim=True) + 1e-20)
    bin_samples = bin_dt * sr
    env_bins = torch.sqrt(hist / bin_samples)
    pos = torch.arange(n, dtype=F64, device=dev) / bin_samples - 0.5
    lo = torch.floor(pos).long().clamp(0, hist.shape[-1] - 1)
    hi = (lo + 1).clamp(max=hist.shape[-1] - 1)
    frac = (pos - lo).clamp(0.0, 1.0)
    env = env_bins[..., lo] * (1 - frac) + env_bins[..., hi] * frac
    return (carriers * env).sum(dim=2)


# ---------------------------------------------------------------------------
# The direct path and diffraction
# ---------------------------------------------------------------------------


def direct(sources, caps, blocked, n: int, sr: int, c: float) -> torch.Tensor:
    """(S, C, n) windowed-sinc direct paths, zero where blocked (S, C)."""
    dev = sources.device
    d = torch.linalg.vector_norm(sources[:, None] - caps[None], dim=-1)
    amp = (~blocked).to(F64) / (4.0 * math.pi * d.clamp_min(1e-2))
    delay = d * sr / c
    k = torch.arange(-32, 33, device=dev)
    window = torch.as_tensor(np.hanning(65), dtype=F64, device=dev)
    whole = torch.floor(delay).long()
    taps = torch.sinc(k - (delay - whole)[..., None]) * window
    pos = whole[..., None] + k
    vals = amp[..., None] * taps * ((pos >= 0) & (pos < n))
    return torch.zeros(d.shape + (n,), dtype=F64, device=dev).scatter_add_(2, pos.clamp(0, n - 1), vals)


def _first_least(x: torch.Tensor, dim: int) -> tuple:
    """(least, index): the first index along `dim` whose value lies within
    1e-9 of the least (relative), so that equal values up to rounding pick
    the first."""
    least = x.min(dim=dim, keepdim=True).values
    near = x <= least + 1e-9 * least.abs()
    return least.squeeze(dim), near.to(torch.int8).argmax(dim=dim)


def _frame(sources, centre):
    dvec = centre[None] - sources
    d = torch.linalg.vector_norm(dvec, dim=-1)
    axis = dvec / d.clamp_min(1e-9)[:, None]
    u = _unit(torch.linalg.cross(axis, _helper_axis(axis), dim=-1), 1e-9)
    return d, axis, u, torch.linalg.cross(axis, u, dim=-1)


def _lattice(u, v, n_angles: int, n_radii: int) -> torch.Tensor:
    """(S, angles, radii, 3) offsets in the plane of u and v."""
    a = torch.arange(n_angles, dtype=F64, device=u.device) * (2.0 * math.pi / n_angles)
    r = torch.as_tensor(np.geomspace(0.05, 4.0, n_radii), dtype=F64, device=u.device)
    ring = torch.cos(a)[None, :, None] * u[:, None] + torch.sin(a)[None, :, None] * v[:, None]
    return ring[:, :, None, :] * r[None, None, :, None]


def _ends(starts, ends, over: float = 5e-4):
    g = ends - starts
    return ends + over * g / torch.linalg.vector_norm(g, dim=-1, keepdim=True).clamp_min(1e-9)


def _graph(room: Room, sources, centre, order: int) -> tuple:
    """The multi-bend detour: (found, path to the last bend with 0.05 m a
    station, last bend, per-bend local detours (S, stations))."""
    n_src, dev = len(sources), sources.device
    d, axis, u, v = _frame(sources, centre)
    stations = max(2, min(int(order), 4))
    per = 48
    nodes_n = stations * per
    fracs = (torch.arange(stations, dtype=F64, device=dev) + 1.0) / (stations + 1.0)
    at = sources[:, None] + fracs[None, :, None] * (d[:, None] * axis)[:, None]
    nodes = (at[:, :, None] + _lattice(u, v, 12, 4).reshape(n_src, 1, per, 3)).reshape(n_src, nodes_n, 3)
    src_b = sources[:, None].expand(n_src, nodes_n, 3)
    starts = torch.cat([src_b, nodes.repeat_interleave(nodes_n, dim=1), nodes], dim=1)
    raw = torch.cat([nodes, nodes.repeat(1, nodes_n, 1), centre.expand(n_src, nodes_n, 3)], dim=1)
    occ = room.legs.blocked(starts.reshape(-1, 3), _ends(starts, raw).reshape(-1, 3)).reshape(n_src, -1)
    occ_src, occ_lis = occ[:, :nodes_n], occ[:, nodes_n + nodes_n**2 :]
    occ_pair = occ[:, nodes_n : nodes_n + nodes_n**2].reshape(n_src, nodes_n, nodes_n)
    hop = 0.05
    w_src = torch.where(occ_src, math.inf, torch.linalg.vector_norm(nodes - sources[:, None], dim=-1) + hop)
    w_lis = torch.where(occ_lis, math.inf, torch.linalg.vector_norm(centre - nodes, dim=-1))
    station = torch.arange(nodes_n, device=dev) // per
    fwd = station[None, :] > station[:, None]
    pair_len = torch.linalg.vector_norm(nodes[:, None] - nodes[:, :, None], dim=-1)
    w_pair = torch.where(fwd[None] & ~occ_pair, pair_len + hop, math.inf)
    dist = w_src
    parent = torch.full((n_src, nodes_n), -1, dtype=torch.int64, device=dev)
    for _ in range(stations - 1):
        via, frm = _first_least(dist[:, :, None] + w_pair, 1)
        better = via < dist
        parent = torch.where(better, frm, parent)
        dist = torch.minimum(dist, via)
    total, last = _first_least(dist + w_lis, 1)
    rows = torch.arange(n_src, device=dev)
    found = torch.isfinite(total)
    cur, nxt = last, centre.expand(n_src, 3)
    deltas = torch.zeros((n_src, stations), dtype=F64, device=dev)
    slot = torch.zeros(n_src, dtype=torch.int64, device=dev)
    for _ in range(stations):
        here = nodes[rows, cur.clamp_min(0)]
        par = parent[rows, cur.clamp_min(0)]
        prev = torch.where((par < 0)[:, None], sources, nodes[rows, par.clamp_min(0)])
        delta = (torch.linalg.vector_norm(here - prev, dim=-1) + torch.linalg.vector_norm(nxt - here, dim=-1)
                 - torch.linalg.vector_norm(nxt - prev, dim=-1)).clamp_min(0.0)
        on = cur >= 0
        deltas = torch.where(on[:, None] & (torch.arange(stations, device=dev)[None] == slot[:, None]),
                             delta[:, None], deltas)
        cur = torch.where(on, par, torch.full_like(par, -2))
        nxt = torch.where(on[:, None], prev, nxt)
        slot = slot + on.long()
    return found, dist[rows, last], nodes[rows, last], deltas


def diffraction(room: Room, sources, caps, blocked, n: int, sr: int, c: float, order: int) -> torch.Tensor:
    """(S, C, n) knife-edge arrivals of the blocked (source, capsule) pairs."""
    n_src, dev = len(sources), sources.device
    centre = caps.mean(dim=0)
    d, axis, u, v = _frame(sources, centre)
    mid = 0.5 * (sources + centre[None])
    bends = (mid[:, None, None] + _lattice(u, v, 16, 12)).reshape(n_src, -1, 3)
    k = bends.shape[1]
    d1 = torch.linalg.vector_norm(bends - sources[:, None], dim=-1)
    d2c = torch.linalg.vector_norm(bends - centre, dim=-1)
    starts = torch.cat([sources[:, None].expand(n_src, k, 3), centre.expand(n_src, k, 3)], dim=1)
    raw = torch.cat([bends, bends], dim=1)
    # The legs run source -> bend and centre -> bend
    occ = room.legs.blocked(starts.reshape(-1, 3), _ends(starts, raw).reshape(-1, 3)).reshape(n_src, 2, k)
    least, best = _first_least(torch.where(~occ[:, 0] & ~occ[:, 1], d1 + d2c, math.inf), 1)
    rows = torch.arange(n_src, device=dev)
    found = torch.isfinite(least)
    bend = bends[rows, best]
    path = d1[rows, best][:, None] + torch.linalg.vector_norm(caps[None] - bend[:, None], dim=-1)
    straight = torch.linalg.vector_norm(caps[None] - sources[:, None], dim=-1)
    deltas = (path - straight).clamp_min(0.0)[..., None]
    if order >= 2:
        found_g, dist_g, bend_g, deltas_g = _graph(room, sources, centre, order)
        path_g = dist_g[:, None] + torch.linalg.vector_norm(caps[None] - bend_g[:, None], dim=-1)
        use = ~found & found_g
        found = found | found_g
        path = torch.where(use[:, None], path_g, path)
        deltas = torch.where(use[:, None, None], deltas_g[:, None, :].expand(n_src, len(caps), -1),
                             torch.nn.functional.pad(deltas, (0, deltas_g.shape[1] - 1)))
    centres = band_centres(room.absorption.shape[1], dev)
    fresnel = 2.0 * deltas[..., None] * centres / c
    att = (10.0 * torch.log10(3.0 + 20.0 * fresnel) * (deltas[..., None] > 5e-3)).sum(dim=2)
    att = torch.where((deltas <= 5e-3).all(dim=2)[..., None], 10.0 * math.log10(3.0), att)
    gain = 10.0 ** (-att / 20.0) / (4.0 * math.pi * path.clamp_min(1e-2))[..., None]
    gain = gain * (blocked & found[:, None])[..., None]
    freqs = torch.arange(n // 2 + 1, dtype=F64, device=dev) * (sr / n)
    delay = path * sr / c
    mag = (gain @ band_weights(freqs, centres)) * (delay < n - 1)[..., None]
    spec = mag * torch.exp(-2j * math.pi * freqs / sr * delay[..., None])
    # A real signal's DC and Nyquist bins
    spec[..., 0] = spec[..., 0].real
    if n % 2 == 0:
        spec[..., -1] = spec[..., -1].real
    return torch.fft.irfft(spec, n=n)


# ---------------------------------------------------------------------------
# A scene
# ---------------------------------------------------------------------------


def bucket(n: int) -> int:
    """The sources a scene of `n` emitters traces: the next power of two."""
    return 1 << max(0, (n - 1).bit_length())


def emitters(spec: dict) -> np.ndarray:
    """Every emitter of the scene in the order the events add them."""
    return np.array([p for e in spec["events"] for p in (e["trajectory"] if e["moving"] else [e["position"]])],
                    dtype=np.float64)


def responses(config: dict, spec: dict, device, lowp=audio.exact) -> tuple:
    """((C, E, n) float64 responses of the scene's E emitters at its C
    capsules, the generator after the responses' draws, bounces run)."""
    eng, sr = config["engine"], int(config["sample_rate"])
    room = room_of(config, spec, device)
    c = SPEED_OF_SOUND
    n = round(float(eng["max_ir_length"]) * sr)
    n_bins = int(np.ceil(n / sr / HIST_BIN_DT)) + 1
    src = emitters(spec)
    src = np.concatenate([src, np.repeat(src[:1], bucket(len(src)) - len(src), axis=0)])
    caps_np = np.asarray(spec["mic"]["position"], dtype=np.float64) + np.asarray(config["rig"]["capsules"])
    sources = torch.as_tensor(src - room.centre, dtype=F64, device=device)
    caps = torch.as_tensor(caps_np - room.centre, dtype=F64, device=device)
    gen = torch.Generator(device=device).manual_seed(trace_seed(spec["state_seed"]))
    hidden = rain_table(room, caps.mean(dim=0))
    hist, bounces = histograms(gen, room, sources, caps, hidden, eng, n_bins, lowp)
    irs = tail(gen, hist, n, sr, HIST_BIN_DT, lowp)
    seg_s = caps[None].expand(len(src), -1, 3).reshape(-1, 3)
    seg_e = sources[:, None].expand(-1, len(caps), 3).reshape(-1, 3)
    blocked = room.full.blocked(seg_s, seg_e).reshape(len(src), len(caps))
    irs = irs + direct(sources, caps, blocked, n, sr, c)
    if bool(eng["diffraction"]):
        irs = irs + diffraction(room, sources, caps, blocked, n, sr, c, MAX_DIFFRACTION_ORDER)
    return lowp(irs[: len(emitters(spec))].transpose(0, 1)), gen, bounces


def render(config: dict, spec: dict, clips: list, bed_seed: int, device, lowp=audio.exact) -> np.ndarray:
    """The (C, T) int16 payload of one scene. The bed comes from the scene's
    generator, so `bed_seed` (the host bed's) is not read."""
    irs, gen, _ = responses(config, spec, device, lowp)
    return payload(spec, clips, irs, gen, config, device, lowp)


def payload(spec: dict, clips: list, irs: torch.Tensor, gen, config: dict, device, lowp=audio.exact) -> np.ndarray:
    """The device mix of a scene whose emitters have the responses `irs`
    (C, E, n), its bed drawn from `gen`."""
    sr = int(spec["sample_rate"])
    t = round(spec["duration"] * sr)
    s = round(float(config["pipeline"]["plan_kwargs"]["pad_audio_seconds"]) * sr)
    mix = torch.zeros((irs.shape[0], t), dtype=F64, device=device)
    first = 0
    for ev in spec["events"]:
        k = len(ev["trajectory"]) if ev["moving"] else 1
        ev_irs = audio.normalised(irs[:, first : first + k].transpose(0, 1))
        first += k
        x = audio.dry(clips[ev["clip"]], ev["duration"], sr)
        m = min(len(x), s)
        x = lowp(torch.as_tensor(np.pad(x[:m], (0, s - m)), dtype=F64, device=device))
        start = max(0, round(ev["scene_start"] * sr))
        place = min(max(min(round((ev["scene_start"] + ev["duration"]) * sr), t) - start, 0), s)
        if ev["moving"]:
            times = np.linspace(0.0, ev["duration"], k)
            w = lowp(torch.as_tensor(audio.crossfade(times, sr, audio.n_frames(s)), dtype=F64, device=device))
            wet = audio.moving_wet(x, ev_irs, w, s, m)
        else:
            wet = audio.convolve(x, ev_irs[0], s)
        stem = lowp(audio.levelled(wet, m, place, float(ev["snr"]), float(spec["ref_db"])))
        end = min(s, t - start)
        if end > 0:
            mix[:, start : start + end] += stem[:, :end]
    noise = torch.randn(mix.shape, generator=gen, device=device).to(F64)
    noise = noise / (noise.abs().amax(dim=-1, keepdim=True) + 1e-15)
    bed = lowp(noise * (10.0 ** (float(spec["ref_db"]) / 20.0) / (noise.abs().mean() + 1e-15)))
    mix = lowp(mix + bed).cpu().numpy()
    return (np.clip(mix, -1.0, 1.0) * 32767.0).astype(np.int16)


def numbers(program: np.ndarray, reference: np.ndarray) -> dict:
    """The widest payload gap in int16 steps, and the payload's error
    relative to the reference's: ||program - reference|| / ||reference||
    over every sample of every channel (a shape mismatch reads 1e9)."""
    if program.shape != reference.shape:
        return dict(payload_gap_lsb=audio.payload_gap(program, reference), payload_rel_err=1e9)
    diff = program.astype(np.float64) - reference.astype(np.float64)
    return dict(payload_gap_lsb=audio.payload_gap(program, reference),
                payload_rel_err=float(np.linalg.norm(diff) / max(np.linalg.norm(reference.astype(np.float64)), 1.0)))
