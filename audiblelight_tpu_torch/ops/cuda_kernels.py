"""The tracer's kernels: wrappers for the CUDA kernels in `csrc/` and their
plain PyTorch versions.

Counterpart of audiblelight_tpu/ops/pallas_kernels.py and
audiblelight_tpu/ops/star_occlusion.py:

- `ray_first_hit`       <- ray_first_hit_pallas (big and small variants)
- `segments_occluded`   <- segments_occluded_pallas
- `deposit_histogram`   <- deposit_histogram_pallas
- `deposit_histogram_foa` <- deposit_histogram_foa_pallas
- `bin_histogram`       <- bin_histogram_pallas
- `star_any_hit`        <- star_segments_occluded's kernel (the glue around
  it, azimuth sort and block ranges, is ops/star_occlusion.py)
- `first_hit_tiled`     <- tiled_first_hit's kernel (the glue, ray sort and
  per-block tile order, is ops/tiled_first_hit.py)
- `first_hit_mxu`       <- mxu_first_hit's kernel (the glue, ray vectors and
  the exact plane re-evaluation, is ops/mxu_first_hit.py)
- `first_hit_sorted`    <- sorted_first_hit's kernel (the glue, cone sort and
  per-block tile order, is ops/sorted_first_hit.py)
- `first_hit_pair`      <- pair_first_hit's kernel (the glue, slab test,
  candidate tiles, tile-aligned pair layout and rounds, is
  ops/pair_first_hit.py)

Each wrapper prepares its inputs in PyTorch (the same preparation feeds the
kernel and the plain version), then runs the plain version when the tensors
lie on the CPU and launches the kernel when they lie on a CUDA device. There
is no fallback from one to the other. The plain versions write the
arithmetic out component by component, in the order of the Pallas bodies,
and chunk over faces so that no (rays, faces) temporary is built whole.

`launch_counts` counts kernel launches per kernel (only the CUDA branch
counts); `reset_launch_counts` zeroes it.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from audiblelight_tpu_torch import config
from audiblelight_tpu_torch.utils import cross3, dot3, norm3

SMALL_F_MAX = 512  # face count at or below which the classic Moller-Trumbore variant runs
_EPS = 1e-9
_BIG = 3.0e38
_MARGIN = 1e-4
# Elements of one (rays, faces) chunk in the plain versions
_CHUNK_ELEMS = 1 << 22

launch_counts = {"first_hit_big": 0, "first_hit_small": 0, "any_hit": 0, "deposit_histogram": 0,
                 "deposit_histogram_foa": 0, "bin_histogram": 0, "star_any_hit": 0, "first_hit_tiled": 0,
                 "first_hit_mxu": 0, "first_hit_sorted": 0, "first_hit_pair": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _face_chunk(n_rays: int, n_faces: int) -> int:
    return max(1, min(n_faces, _CHUNK_ELEMS // max(n_rays, 1)))


def _check(name: str, x: torch.Tensor, shape: tuple, dtype: torch.dtype, device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _on_card(x: torch.Tensor) -> bool:
    """True when `x` lies on a CUDA device (the kernel route)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not config.USE_CUDA_KERNELS:
        raise RuntimeError("config.USE_CUDA_KERNELS is False: no kernel route for CUDA tensors")
    return True


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


_FUNCTIONS: dict = {}


def _lib(name: str, fn: str, layout: list):
    """The ctypes function `fn` of kernel library `name`, with argtypes set."""
    f = _FUNCTIONS.get(fn)
    if f is None:
        from audiblelight_tpu_torch.ops.build import load

        f = getattr(load(name), fn)
        f.argtypes = layout
        f.restype = ctypes.c_int
        _FUNCTIONS[fn] = f
    return f


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# K1: first hit
# ---------------------------------------------------------------------------


def big_face_table(tris: torch.Tensor):
    """The centre and the (F, 16) face table of the big variant, built
    exactly as pallas_kernels.py:248-266 builds them; ray origins are moved
    by the same centre.

    The centre is the middle of the bounds of the REAL vertices: sentinel
    faces at PAD_DISTANCE (1e9) are left out, or they would drag the centre
    away and waste the precision the centring protects. Columns are
    [e2, w2, -e1, -w1, -n, -k] with w_i = A x e_i, n = e1 x e2, k = A . n.
    """
    tris32 = tris.to(torch.float32)
    verts = tris32.reshape(-1, 3)
    fake = ~(verts.abs() < 1.0e8).all(dim=-1, keepdim=True)
    vmin = verts.masked_fill(fake, math.inf).amin(dim=0)
    vmax = verts.masked_fill(fake, -math.inf).amax(dim=0)
    center = torch.where(torch.isfinite(vmin + vmax), 0.5 * (vmin + vmax), torch.zeros_like(vmin))
    av = tris32[:, 0] - center
    e1 = tris32[:, 1] - tris32[:, 0]
    e2 = tris32[:, 2] - tris32[:, 0]
    w1 = cross3(av, e1)
    w2 = cross3(av, e2)
    nrm = cross3(e1, e2)
    kk = dot3(av, nrm)
    tab = torch.cat([e2, w2, -e1, -w1, -nrm, -kk[:, None]], dim=1).contiguous()
    return center, tab


def mt_face_table(tris: torch.Tensor) -> torch.Tensor:
    """(F, 9) face table [a, e1, e2] of the classic Moller-Trumbore bodies."""
    tris32 = tris.to(torch.float32)
    return torch.cat(
        [tris32[:, 0], tris32[:, 1] - tris32[:, 0], tris32[:, 2] - tris32[:, 0]], dim=1
    ).contiguous()


def first_hit_table(tris: torch.Tensor) -> tuple:
    """(variant, centre or None, face table) of the first-hit kernel for
    `tris` (F, 3, 3). A caller that casts many rays at one mesh builds it
    once and passes it to every `ray_first_hit` call."""
    if tris.shape[0] <= SMALL_F_MAX:
        return "small", None, mt_face_table(tris)
    return ("big", *big_face_table(tris))


def _first_hit_inputs(origins, dirs, tris, table):
    """(variant, origins, dirs, face table) for the first-hit kernel or plain body."""
    variant, center, tab = first_hit_table(tris) if table is None else table
    o = torch.atleast_2d(origins).to(torch.float32)
    if center is not None:
        o = o - center
    return variant, o.contiguous(), torch.atleast_2d(dirs).to(torch.float32).contiguous(), tab


def _fold_min(best_t, best_i, t_hit, f0):
    """Min over one face chunk; the first (smallest) face index wins ties,
    and an earlier chunk keeps a tie with a later one."""
    tmin, arg = t_hit.min(dim=1)
    better = tmin < best_t
    return torch.where(better, tmin, best_t), torch.where(better, arg.to(torch.int32) + f0, best_i)


def _plucker(o, d):
    """Ray components and the Plucker moment o x d, each (..., 1) of `o`, `d`
    (..., 3): (ox, oy, oz, dx, dy, dz, odx, ody, odz)."""
    ox, oy, oz = o[..., 0:1], o[..., 1:2], o[..., 2:3]
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    return ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx


def _bilinear_pair(ray, c):
    """The big variant's test of rays `ray` (from `_plucker`) against face
    rows c = (16, ...) that broadcast against them: (inside the window with
    t > 1e-9, t), as csrc/bilinear_pair.cuh writes it, term for term."""
    ox, oy, oz, dx, dy, dz, odx, ody, odz = ray
    u_num = (odx * c[0] + ody * c[1] + odz * c[2]) + (dx * c[3] + dy * c[4] + dz * c[5])
    v_num = (odx * c[6] + ody * c[7] + odz * c[8]) + (dx * c[9] + dy * c[10] + dz * c[11])
    a = dx * c[12] + dy * c[13] + dz * c[14]
    t_num = c[15] - (ox * c[12] + oy * c[13] + oz * c[14])
    inv = 1.0 / a
    u = u_num * inv
    v = v_num * inv
    t = t_num * inv
    return (u >= -_EPS) & (u <= 1.0 + _EPS) & (v >= -_EPS) & (u + v <= 1.0 + _EPS) & (t > _EPS), t


def _first_hit_big_plain(o, d, tab):
    """Plain version of _first_hit_big_kernel on centred origins `o`."""
    r, f = o.shape[0], tab.shape[0]
    ray = _plucker(o, d)
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    step = _face_chunk(r, f)
    for f0 in range(0, f, step):
        hit, t = _bilinear_pair(ray, tab[f0 : f0 + step].T[:, None, :])  # faces (16, 1, Fc)
        best_t, best_i = _fold_min(best_t, best_i, torch.where(hit, t, _BIG), f0)
    return best_t, best_i


def _mt_pair(o, d, c):
    """Classic Moller-Trumbore for rays (R, 1) x faces c = (9, 1, Fc):
    (inside the window, t), as the Pallas small and any-hit bodies write it."""
    return _mt_pair_xyz(o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3], c)


def _mt_pair_xyz(ox, oy, oz, dx, dy, dz, c):
    """`_mt_pair` on ray components and face rows c = (9, ...) that
    broadcast against them (csrc/mt_pair.cuh, term for term)."""
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = c[:9]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    valid_a = a.abs() > _EPS
    inv = 1.0 / torch.where(valid_a, a, torch.ones_like(a))
    sx = ox - ax
    sy = oy - ay
    sz = oz - az
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    in_tri = valid_a & (u >= -_EPS) & (u <= 1.0 + _EPS) & (v >= -_EPS) & (u + v <= 1.0 + _EPS)
    return in_tri, t


def _first_hit_small_plain(o, d, tab):
    """Plain version of _first_hit_small_kernel."""
    r, f = o.shape[0], tab.shape[0]
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    step = _face_chunk(r, f)
    for f0 in range(0, f, step):
        in_tri, t = _mt_pair(o, d, tab[f0 : f0 + step].T[:, None, :])
        best_t, best_i = _fold_min(best_t, best_i, torch.where(in_tri & (t > _EPS), t, _BIG), f0)
    return best_t, best_i


def _finish_first_hit(best_t, best_i):
    miss = best_t >= _BIG
    return (
        torch.where(miss, torch.full_like(best_t, math.inf), best_t),
        torch.where(miss, torch.full_like(best_i, -1), best_i),
    )


def ray_first_hit_plain(origins, dirs, tris, table=None):
    """Plain PyTorch version of `ray_first_hit` (any device)."""
    variant, o, d, tab = _first_hit_inputs(origins, dirs, tris, table)
    body = _first_hit_big_plain if variant == "big" else _first_hit_small_plain
    return _finish_first_hit(*body(o, d, tab))


def ray_first_hit(origins, dirs, tris, table=None):
    """First hit (t (R,), face (R,) int32) of each ray against `tris` (F, 3, 3).

    t = +inf and face = -1 where a ray escapes. On equal t the smallest face
    index wins. F > 512 runs the big-variant arithmetic (centred coordinates,
    precomputed face table), F <= 512 classic Moller-Trumbore, as the Pallas
    kernel does. `table` is `first_hit_table(tris)` where the caller keeps it.
    """
    variant, o, d, tab = _first_hit_inputs(origins, dirs, tris, table)
    if not _on_card(o):
        body = _first_hit_big_plain if variant == "big" else _first_hit_small_plain
        return _finish_first_hit(*body(o, d, tab))
    r, f = o.shape[0], tab.shape[0]
    dev = o.device
    _check("origins", o, (r, 3), torch.float32, dev)
    _check("dirs", d, (r, 3), torch.float32, dev)
    _check("face table", tab, (f, 16 if variant == "big" else 9), torch.float32, dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    name = f"first_hit_{variant}"
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("first_hit", name, [vp, vp, vp, ci, ci, vp, vp, vp])
    launch_counts[name] += 1
    _raise_on(fn(_ptr(o), _ptr(d), _ptr(tab), r, f, _ptr(t), _ptr(idx), _stream(o)), name)
    return t, idx


# ---------------------------------------------------------------------------
# K2: any hit (segment occlusion)
# ---------------------------------------------------------------------------


def _any_hit_inputs(starts, ends, tris):
    """(origins, unit directions, lengths, face table) as the Pallas wrapper
    builds them (pallas_kernels.py:452-468)."""
    starts = torch.atleast_2d(starts).to(torch.float32)
    ends = torch.atleast_2d(ends).to(torch.float32)
    seg = ends - starts
    length = norm3(seg)
    dirs = seg / torch.clamp_min(length, _EPS)[:, None]
    return starts.contiguous(), dirs.contiguous(), length.contiguous(), mt_face_table(tris)


def _any_hit_plain(o, d, length, tab):
    r, f = o.shape[0], tab.shape[0]
    t_max = (length - _MARGIN)[:, None]
    blocked = torch.zeros(r, dtype=torch.bool, device=o.device)
    step = _face_chunk(r, f)
    for f0 in range(0, f, step):
        in_tri, t = _mt_pair(o, d, tab[f0 : f0 + step].T[:, None, :])
        blocked |= (in_tri & (t > _MARGIN) & (t < t_max)).any(dim=1)
    return blocked


def segments_occluded_plain(starts, ends, tris):
    """Plain PyTorch version of `segments_occluded` (any device)."""
    return _any_hit_plain(*_any_hit_inputs(starts, ends, tris))


def segments_occluded(starts, ends, tris):
    """(R,) bool: True where a face crosses the open segment start -> end,
    inside the window 1e-4 < t < length - 1e-4 (segments that end ON a
    surface do not count as blocked). Zero-length segments are never blocked.
    """
    o, d, length, tab = _any_hit_inputs(starts, ends, tris)
    if not _on_card(o):
        return _any_hit_plain(o, d, length, tab)
    r, f = o.shape[0], tab.shape[0]
    dev = o.device
    _check("starts", o, (r, 3), torch.float32, dev)
    _check("dirs", d, (r, 3), torch.float32, dev)
    _check("lengths", length, (r,), torch.float32, dev)
    _check("face table", tab, (f, 9), torch.float32, dev)
    out = torch.empty(r, dtype=torch.uint8, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("any_hit", "any_hit", [vp, vp, vp, vp, ci, ci, vp, vp])
    launch_counts["any_hit"] += 1
    _raise_on(fn(_ptr(o), _ptr(d), _ptr(length), _ptr(tab), r, f, _ptr(out), _stream(o)), "any_hit")
    return out.to(torch.bool)


# ---------------------------------------------------------------------------
# K3: fused deposit + histogram
# ---------------------------------------------------------------------------

HIST_LANES = 128  # the histogram is padded to a multiple of this many bins


def _f32(x: float) -> float:
    """`x` rounded to float32."""
    return float(np.float32(x))


def _deposit_constants(n_bins: int, bin_dt: float, c_sound: float):
    """(n_bins_pad, 1/bin_dt, range limit, 1/c, 4 pi^2) as the f32 values the
    Pallas kernel uses: each is formed in double on the host, then rounded.

    The arrival time is (dist + d) * (1/c): XLA folds the kernel's division
    by the constant c into that multiply, and arrivals on a bin edge land in
    the bin it gives."""
    n_bins_pad = max(HIST_LANES, -(-n_bins // HIST_LANES) * HIST_LANES)
    return (
        n_bins_pad,
        _f32(1.0 / bin_dt),
        _f32(n_bins_pad * bin_dt),
        _f32(1.0 / c_sound),
        _f32(4.0 * math.pi**2),
    )


def deposit_histogram_plain(hit, normal, e_refl, dist, occ, listener_pos,
                            n_sources: int, n_bins: int, bin_dt: float, c_sound: float):
    """Plain PyTorch version of `deposit_histogram` (any device)."""
    n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2 = _deposit_constants(n_bins, bin_dt, c_sound)
    dev = hit.device
    tr, n_bands = e_refl.shape
    cl = listener_pos.shape[0]
    lis = listener_pos.to(torch.float32)
    vx = lis[:, 0:1] - hit[None, :, 0]
    vy = lis[:, 1:2] - hit[None, :, 1]
    vz = lis[:, 2:3] - hit[None, :, 2]
    d2 = vx * vx + vy * vy + vz * vz
    d = torch.sqrt(d2)
    cos_th = torch.clamp_min(
        (vx * normal[None, :, 0] + vy * normal[None, :, 1] + vz * normal[None, :, 2])
        / torch.clamp_min(d, 1e-9),
        0.0,
    )
    arrival = (dist[None] + d) * inv_c
    bins = (arrival * inv_bin_dt).to(torch.int32)
    visible = ~occ & (cos_th > 0.0) & (arrival < range_limit)
    m = torch.clamp_min(d, 1e-2)
    geom = torch.where(visible, cos_th / (four_pi2 * (m * m)), torch.zeros_like(d))
    dep = e_refl[None] * geom[..., None]  # (C, TR, B)
    bins = bins.clamp(0, n_bins_pad - 1)
    r = tr // n_sources
    group = (torch.arange(cl, device=dev)[:, None] * n_sources
             + torch.arange(tr, device=dev)[None] // r)  # (C, TR): c * E + e
    flat = (group * n_bins_pad + bins).reshape(-1)
    out = torch.zeros(cl * n_sources * n_bins_pad, n_bands, dtype=torch.float32, device=dev)
    out.index_add_(0, flat, dep.reshape(-1, n_bands))
    out = out.reshape(cl, n_sources, n_bins_pad, n_bands)[:, :, :n_bins]
    return out.permute(1, 0, 3, 2).contiguous()


def deposit_histogram(hit, normal, e_refl, dist, occ, listener_pos,
                      n_sources: int, n_bins: int, bin_dt: float, c_sound: float):
    """Fused diffuse-rain deposit + per-(source, capsule) arrival histogram.

    Arguments:
        hit, normal: (TR, 3) hit points and incoming-facing normals, TR =
            n_sources * rays, source-major.
        e_refl: (TR, B) reflected energies; dist: (TR,) path lengths so far.
        occ: (C, TR) bool, True where the capsule does not receive the ray.
        listener_pos: (C, 3) capsule positions.

    Returns (n_sources, C, B, n_bins) f32 energy to add to the histograms.
    """
    if not _on_card(hit):
        return deposit_histogram_plain(hit, normal, e_refl, dist, occ, listener_pos,
                                       n_sources, n_bins, bin_dt, c_sound)
    n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2 = _deposit_constants(n_bins, bin_dt, c_sound)
    tr, n_bands = e_refl.shape
    cl = listener_pos.shape[0]
    if tr % n_sources:
        raise ValueError(f"{tr} rays do not split into {n_sources} sources")
    dev = hit.device
    _check("hit", hit, (tr, 3), torch.float32, dev)
    _check("normal", normal, (tr, 3), torch.float32, dev)
    _check("e_refl", e_refl, (tr, n_bands), torch.float32, dev)
    _check("dist", dist, (tr,), torch.float32, dev)
    _check("occ", occ, (cl, tr), torch.bool, dev)
    _check("listener_pos", listener_pos, (cl, 3), torch.float32, dev)
    out = torch.empty((n_sources, cl, n_bands, n_bins), dtype=torch.float32, device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _lib("deposit_histogram", "deposit_histogram",
              [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, cf, cf, cf, vp, vp])
    launch_counts["deposit_histogram"] += 1
    err = fn(_ptr(hit), _ptr(normal), _ptr(e_refl), _ptr(dist), _ptr(occ), _ptr(listener_pos),
             n_sources, tr // n_sources, cl, n_bands, n_bins, n_bins_pad,
             inv_bin_dt, range_limit, inv_c, four_pi2, _ptr(out), _stream(hit))
    _raise_on(err, "deposit_histogram")
    return out


# ---------------------------------------------------------------------------
# K4: fused deposit + AmbiX first-order encode + histogram
# ---------------------------------------------------------------------------


def deposit_histogram_foa_plain(hit, normal, e_refl, dist, occ, listener_pos,
                                n_sources: int, n_bins: int, bin_dt: float, c_sound: float):
    """Plain PyTorch version of `deposit_histogram_foa` (any device)."""
    n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2 = _deposit_constants(n_bins, bin_dt, c_sound)
    tr, n_bands = e_refl.shape
    lis = listener_pos.to(torch.float32).reshape(3)
    vx = lis[0] - hit[:, 0]
    vy = lis[1] - hit[:, 1]
    vz = lis[2] - hit[:, 2]
    d = torch.sqrt(vx * vx + vy * vy + vz * vz)
    inv_d = 1.0 / torch.clamp_min(d, 1e-9)
    cos_th = torch.clamp_min((vx * normal[:, 0] + vy * normal[:, 1] + vz * normal[:, 2]) * inv_d, 0.0)
    arrival = (dist + d) * inv_c
    bins = (arrival * inv_bin_dt).to(torch.int32).clamp(0, n_bins_pad - 1)
    visible = ~occ.reshape(tr) & (cos_th > 0.0) & (arrival < range_limit)
    m = torch.clamp_min(d, 1e-2)
    geom = torch.where(visible, cos_th / (four_pi2 * (m * m)), torch.zeros_like(d))
    dep = e_refl * geom[:, None]  # (TR, B)
    gains = torch.stack([-vx * inv_d, -vy * inv_d, -vz * inv_d], dim=1)  # (TR, 3)
    w = torch.cat([dep[:, None, :], dep[:, None, :] * gains[:, :, None]], dim=1)  # (TR, 4, B)
    r = tr // n_sources
    flat = torch.arange(tr, device=hit.device) // r * n_bins_pad + bins
    out = torch.zeros(n_sources * n_bins_pad, 4 * n_bands, dtype=torch.float32, device=hit.device)
    out.index_add_(0, flat, w.reshape(tr, 4 * n_bands))
    out = out.reshape(n_sources, n_bins_pad, 4, n_bands)[:, :n_bins]
    return out.permute(0, 2, 3, 1).contiguous()


def deposit_histogram_foa(hit, normal, e_refl, dist, occ, listener_pos,
                          n_sources: int, n_bins: int, bin_dt: float, c_sound: float):
    """Fused diffuse-rain deposit + AmbiX order-1 encode + per-source arrival
    histogram for one listener point (the FOA rig).

    Arguments:
        hit, normal: (TR, 3) hit points and incoming-facing normals, TR =
            n_sources * rays, source-major.
        e_refl: (TR, B) reflected energies; dist: (TR,) path lengths so far.
        occ: (1, TR) bool, True where the listener does not receive the ray.
        listener_pos: (1, 3) the listener point.

    Returns (n_sources, 4, B, n_bins) f32 energy in channels [W, X, Y, Z]:
    W the deposit, X/Y/Z the deposit times the arrival direction's component.
    """
    if not _on_card(hit):
        return deposit_histogram_foa_plain(hit, normal, e_refl, dist, occ, listener_pos,
                                           n_sources, n_bins, bin_dt, c_sound)
    n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2 = _deposit_constants(n_bins, bin_dt, c_sound)
    tr, n_bands = e_refl.shape
    if tr % n_sources:
        raise ValueError(f"{tr} rays do not split into {n_sources} sources")
    dev = hit.device
    _check("hit", hit, (tr, 3), torch.float32, dev)
    _check("normal", normal, (tr, 3), torch.float32, dev)
    _check("e_refl", e_refl, (tr, n_bands), torch.float32, dev)
    _check("dist", dist, (tr,), torch.float32, dev)
    _check("occ", occ, (1, tr), torch.bool, dev)
    _check("listener_pos", listener_pos, (1, 3), torch.float32, dev)
    out = torch.zeros((n_sources, 4, n_bands, n_bins), dtype=torch.float32, device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _lib("deposit_histogram_foa", "deposit_histogram_foa",
              [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, cf, cf, cf, vp, vp])
    launch_counts["deposit_histogram_foa"] += 1
    err = fn(_ptr(hit), _ptr(normal), _ptr(e_refl), _ptr(dist), _ptr(occ), _ptr(listener_pos),
             n_sources, tr // n_sources, n_bands, n_bins, n_bins_pad,
             inv_bin_dt, range_limit, inv_c, four_pi2, _ptr(out), _stream(hit))
    _raise_on(err, "deposit_histogram_foa")
    return out


# ---------------------------------------------------------------------------
# K5: grouped histogram
# ---------------------------------------------------------------------------

# Widest K slice of one block's shared histogram, and its byte budget: the
# default 48 KiB of a block, so the kernel needs no opt-in
_HIST_K_SLICE = 16
_HIST_SMEM = 48 * 1024


def bin_histogram_plain(bins, dep, n_bins: int):
    """Plain PyTorch version of `bin_histogram` (any device)."""
    g, r, k = dep.shape
    b = bins.to(torch.int64)
    keep = (b >= 0) & (b < n_bins)
    flat = (torch.arange(g, device=dep.device)[:, None] * n_bins + b.clamp(0, n_bins - 1)).reshape(-1)
    vals = torch.where(keep[..., None], dep.to(torch.float32), torch.zeros((), device=dep.device))
    out = torch.zeros(g * n_bins, k, dtype=torch.float32, device=dep.device)
    out.index_add_(0, flat, vals.reshape(-1, k))
    return out.reshape(g, n_bins, k)


def bin_histogram(bins, dep, n_bins: int):
    """Grouped histogram: out[g, bin, k] = sum over rays r of dep[g, r, k]
    where bins[g, r] == bin.

    Arguments:
        bins: (G, R) integer bin indices; bins outside [0, n_bins) deposit
            nowhere (the Pallas kernel's one-hot matches no bin for them).
        dep: (G, R, K) float32 deposits.

    Returns (G, n_bins, K) float32, summed in fp32.
    """
    if not _on_card(dep):
        return bin_histogram_plain(bins, dep, n_bins)
    g, r, k = dep.shape
    if n_bins * 4 > _HIST_SMEM:
        raise ValueError(f"bin_histogram: {n_bins} bins do not fit one block's shared histogram")
    k_slice = min(k, _HIST_K_SLICE, _HIST_SMEM // (4 * n_bins))
    dev = dep.device
    bins = bins.to(torch.int32).contiguous()
    _check("bins", bins, (g, r), torch.int32, dev)
    _check("dep", dep, (g, r, k), torch.float32, dev)
    out = torch.empty((g, n_bins, k), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("bin_histogram", "bin_histogram", [vp, vp, ci, ci, ci, ci, ci, vp, vp])
    launch_counts["bin_histogram"] += 1
    err = fn(_ptr(bins), _ptr(dep), g, r, k, n_bins, k_slice, _ptr(out), _stream(dep))
    _raise_on(err, "bin_histogram")
    return out


# ---------------------------------------------------------------------------
# K6: star any-hit (azimuth-culled segment occlusion toward one end point)
# ---------------------------------------------------------------------------

STAR_BLOCK = 256  # azimuth-sorted segments per block (kBlock in csrc/star_any_hit.cu)
STAR_TILE_FACES = 256  # narrow faces per tile (kTileFaces)
_TWO_PI = 2.0 * math.pi


def star_tile_overlap(brange, tile_meta):
    """(n_blocks, n_tiles) bool: which (segment block, narrow tile) pairs the
    kernel tests. The circular test of star_occlusion.py:_star_kernel in f32:
    the difference of the centres wrapped by d - 2 pi floor(d / 2 pi + 0.5),
    against the sum of the half-widths."""
    b_cen = (brange[0] + brange[1]) * 0.5
    b_half = (brange[1] - brange[0]) * 0.5
    d = tile_meta[0][None, :] - b_cen[:, None]
    # A tensor divisor: a division by a Python scalar may run as a multiply
    # by its reciprocal on the card, the kernel divides
    two_pi = torch.full((), _TWO_PI, dtype=torch.float32, device=d.device)
    d = d - two_pi * torch.floor(d / two_pi + 0.5)
    return d.abs() <= tile_meta[1][None, :] + b_half[:, None]


def star_any_hit_plain(o, d, length, brange, narrow_tab, tile_meta, wide_tab, n_wide: int):
    """Plain PyTorch version of `star_any_hit` (any device): the same block x
    tile cull, each kept pair through the dense any-hit's arithmetic."""
    r_pad = o.shape[0]
    n_tiles = tile_meta.shape[1]
    blocked = torch.zeros(r_pad, dtype=torch.bool, device=o.device)
    overlap = star_tile_overlap(brange, tile_meta)
    lanes = torch.arange(STAR_BLOCK, device=o.device)
    for tl in range(n_tiles):
        blocks = torch.nonzero(overlap[:, tl]).flatten()
        if blocks.numel() == 0:
            continue
        rows = (blocks[:, None] * STAR_BLOCK + lanes[None]).reshape(-1)
        tab = narrow_tab[tl * STAR_TILE_FACES : (tl + 1) * STAR_TILE_FACES]
        blocked[rows] |= _any_hit_plain(o[rows], d[rows], length[rows], tab)
    if n_wide > 0:
        blocked |= _any_hit_plain(o, d, length, wide_tab[:n_wide])
    return blocked


def star_any_hit(o, d, length, brange, narrow_tab, tile_meta, wide_tab, n_wide: int):
    """Occlusion of azimuth-sorted segments toward one end point.

    Arguments:
        o, d: (R_pad, 3) segment starts and unit directions, sorted by the
            start's azimuth about the star centre; length: (R_pad,) lengths.
            R_pad is a multiple of STAR_BLOCK (padding rows have length 0).
        brange: (2, R_pad / STAR_BLOCK) [lowest; highest] azimuth of each
            block of STAR_BLOCK segments.
        narrow_tab: (n_tiles * STAR_TILE_FACES, 9) face rows [a, e1, e2],
            sorted into tiles; tile_meta: (2, n_tiles) [window centre;
            half-width] per tile; wide_tab: (>= n_wide, 9) the faces every
            segment tests.

    Returns (R_pad,) bool, True where a face crosses the open segment inside
    1e-4 < t < length - 1e-4: the dense `segments_occluded` on the same
    segments, as long as each tile's window holds every segment its faces
    can block (star_occlusion.build_star_accel).
    """
    if not _on_card(o):
        return star_any_hit_plain(o, d, length, brange, narrow_tab, tile_meta, wide_tab, n_wide)
    r_pad, dev = o.shape[0], o.device
    n_tiles = tile_meta.shape[1]
    if r_pad % STAR_BLOCK:
        raise ValueError(f"star_any_hit: {r_pad} segments are not a multiple of {STAR_BLOCK}")
    _check("starts", o, (r_pad, 3), torch.float32, dev)
    _check("dirs", d, (r_pad, 3), torch.float32, dev)
    _check("lengths", length, (r_pad,), torch.float32, dev)
    _check("block ranges", brange, (2, r_pad // STAR_BLOCK), torch.float32, dev)
    _check("narrow table", narrow_tab, (n_tiles * STAR_TILE_FACES, 9), torch.float32, dev)
    _check("tile windows", tile_meta, (2, n_tiles), torch.float32, dev)
    _check("wide table", wide_tab, (wide_tab.shape[0], 9), torch.float32, dev)
    if not 0 <= n_wide <= wide_tab.shape[0]:
        raise ValueError(f"star_any_hit: n_wide {n_wide} outside the wide table's {wide_tab.shape[0]} rows")
    out = torch.empty(r_pad, dtype=torch.uint8, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("star_any_hit", "star_any_hit", [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp])
    launch_counts["star_any_hit"] += 1
    err = fn(_ptr(o), _ptr(d), _ptr(length), _ptr(brange), _ptr(narrow_tab), _ptr(tile_meta), _ptr(wide_tab),
             r_pad, n_tiles, int(n_wide), _ptr(out), _stream(o))
    _raise_on(err, "star_any_hit")
    return out.to(torch.bool)


# ---------------------------------------------------------------------------
# K7: tiled first hit (reachability-culled, distance-ordered, early exit)
# ---------------------------------------------------------------------------

TILED_BLOCK = 512  # sorted rays per block (kBlock in csrc/tiled_first_hit.cu)
TILED_TILE_FACES = 256  # Morton-sorted faces per tile (kTileFaces)
DONE_CHECK_EVERY = 4  # tiles between early-exit tests (kDoneCheckEvery)
_IDX_BIG = 2**30


def _lex_min(best_t, best_i, t, i):
    """The smaller of (best_t, best_i) and (t, i), t first, then the index."""
    better = (t < best_t) | ((t == best_t) & (i < best_i))
    return torch.where(better, t, best_t), torch.where(better, i, best_i)


def _tiled_reachable(bmeta, tile_aabb, tl):
    """(n_blocks,) bool: is tile tl[b] reachable from block b? The kernel's
    per-axis half-space test on the block's origin box and direction signs."""
    om, o_max, dm, d_max = bmeta[0:3].T, bmeta[3:6].T, bmeta[6:9].T, bmeta[9:12].T
    lo, hi = tile_aabb[0:3].T[tl], tile_aabb[3:6].T[tl]
    behind = ((dm >= 0.0) & (hi < om)) | ((d_max <= 0.0) & (lo > o_max))
    return ~behind.any(dim=1)


def tiled_walk_plain(o, d, bmeta, perm, dlo, face_tab, tile_aabb):
    """The kernel's walk in plain PyTorch (any device), vectorised over
    blocks: (best t (R_pad,) with 3e38 on a miss, original face (R_pad,)
    with -1 on a miss, tiles tested per block (n_blocks,) int64).

    Step i takes each block's tile perm[:, i] where it is reachable and the
    block is not done; every DONE_CHECK_EVERY steps a block whose worst best
    t is not above the next tile's bound is done. Each kept pair goes through
    `_mt_pair_xyz`, and each ray keeps the smallest (t, original index)."""
    r_pad, n_tiles = o.shape[0], tile_aabb.shape[1]
    nb = r_pad // TILED_BLOCK
    dev = o.device
    ob = o.reshape(nb, TILED_BLOCK, 1, 3)
    db = d.reshape(nb, TILED_BLOCK, 1, 3)
    faces = face_tab.reshape(n_tiles, TILED_TILE_FACES, 10)
    best_t = torch.full((nb, TILED_BLOCK), _BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((nb, TILED_BLOCK), _IDX_BIG, dtype=torch.int32, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    visited = torch.zeros(nb, dtype=torch.int64, device=dev)
    per_chunk = max(1, _CHUNK_ELEMS // (TILED_BLOCK * TILED_TILE_FACES))
    perm = perm.long()
    for i in range(n_tiles):
        tl = perm[:, i]
        blocks = torch.nonzero(~done & _tiled_reachable(bmeta, tile_aabb, tl)).flatten()
        for b0 in range(0, blocks.numel(), per_chunk):
            b = blocks[b0 : b0 + per_chunk]
            c = faces[tl[b]].permute(2, 0, 1)[:, :, None, :]  # (10, A, 1, 256)
            ox, oy, oz = ob[b].unbind(-1)
            dx, dy, dz = db[b].unbind(-1)
            in_tri, t = _mt_pair_xyz(ox, oy, oz, dx, dy, dz, c)
            hit = in_tri & (t > _EPS) & (c[9] >= 0.0)
            t_hit = torch.where(hit, t, _BIG)
            f_hit = torch.where(hit, c[9].to(torch.int32), _IDX_BIG)
            t_min = t_hit.amin(dim=2)
            i_min = torch.where(t_hit == t_min[..., None], f_hit, _IDX_BIG).amin(dim=2)
            best_t[b], best_i[b] = _lex_min(best_t[b], best_i[b], t_min, i_min)
        visited[blocks] += 1
        if i % DONE_CHECK_EVERY == DONE_CHECK_EVERY - 1:
            worst = best_t.amax(dim=1)
            nxt = dlo[:, min(i + 1, n_tiles - 1)]
            done |= (worst < _BIG) & ((worst <= nxt) | (i + 1 >= n_tiles))
            if bool(done.all()):
                break
    best_t, best_i = best_t.reshape(-1), best_i.reshape(-1)
    return best_t, torch.where(best_t >= _BIG, -1, best_i), visited


def first_hit_tiled_plain(o, d, bmeta, perm, dlo, face_tab, tile_aabb):
    """Plain PyTorch version of `first_hit_tiled` (any device)."""
    t, idx, _ = tiled_walk_plain(o, d, bmeta, perm, dlo, face_tab, tile_aabb)
    return t, idx


def first_hit_tiled(o, d, bmeta, perm, dlo, face_tab, tile_aabb):
    """First hit of sorted rays against Morton-tiled faces.

    Arguments:
        o, d: (R_pad, 3) origins and directions, sorted (octant, origin
            cell); R_pad is a multiple of TILED_BLOCK.
        bmeta: (12, n_blocks) per block of TILED_BLOCK rays: least and most
            origin, least and most direction, per axis.
        perm: (n_blocks, n_tiles) int32 each block's tiles in ascending
            order of `dlo` (n_blocks, n_tiles), the distance lower bounds.
        face_tab: (n_tiles * TILED_TILE_FACES, 10) rows [a, e1, e2, original
            index] (index -1 on padding); tile_aabb: (6, n_tiles).

    Returns (t (R_pad,), original face (R_pad,) int32): t = 3e38 and face =
    -1 on a miss. On equal t the smallest original index wins, so the result
    is the dense classic Moller-Trumbore first hit over the original faces
    (`ray_first_hit` with `dense_mt_table`) wherever the early exit's bound
    is not met with equality.
    """
    if not _on_card(o):
        return first_hit_tiled_plain(o, d, bmeta, perm, dlo, face_tab, tile_aabb)
    r_pad, dev = o.shape[0], o.device
    n_tiles = tile_aabb.shape[1]
    nb = r_pad // TILED_BLOCK
    if r_pad % TILED_BLOCK or n_tiles == 0:
        raise ValueError(f"first_hit_tiled: {r_pad} rays are not whole blocks of {TILED_BLOCK}, or no tiles")
    _check("origins", o, (r_pad, 3), torch.float32, dev)
    _check("dirs", d, (r_pad, 3), torch.float32, dev)
    _check("block boxes", bmeta, (12, nb), torch.float32, dev)
    _check("tile order", perm, (nb, n_tiles), torch.int32, dev)
    _check("tile bounds", dlo, (nb, n_tiles), torch.float32, dev)
    _check("face table", face_tab, (n_tiles * TILED_TILE_FACES, 10), torch.float32, dev)
    _check("tile boxes", tile_aabb, (6, n_tiles), torch.float32, dev)
    t = torch.empty(r_pad, dtype=torch.float32, device=dev)
    idx = torch.empty(r_pad, dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("tiled_first_hit", "first_hit_tiled", [vp, vp, vp, vp, vp, vp, vp, ci, ci, vp, vp, vp])
    launch_counts["first_hit_tiled"] += 1
    err = fn(_ptr(o), _ptr(d), _ptr(bmeta), _ptr(perm), _ptr(dlo), _ptr(face_tab), _ptr(tile_aabb),
             r_pad, n_tiles, _ptr(t), _ptr(idx), _stream(o))
    _raise_on(err, "first_hit_tiled")
    return t, idx


def dense_mt_table(tris: torch.Tensor) -> tuple:
    """A `first_hit_table` that runs the classic Moller-Trumbore variant at
    any face count: the dense first hit with the tiled kernel's arithmetic."""
    return "small", None, mt_face_table(tris)


# ---------------------------------------------------------------------------
# K8: bilinear ("MXU") first hit with a launch-face mask
# ---------------------------------------------------------------------------

MXU_PACKED_COLS = 19  # u [e2, w2], v [-e1, -w1], a [-n], t [n, -k] (kCols)
MXU_EPS_UV = 0.02  # relative barycentric slop
MXU_T_EPS = 1.0e-4  # least hit distance (m)
_MXU_DET_EPS = 1.0e-6


def _dot_left(r, c, cols):
    """sum_k r[k] * c[cols[k]], summed left to right as the kernel sums it."""
    acc = r[0] * c[cols[0]]
    for k in range(1, len(cols)):
        acc = acc + r[k] * c[cols[k]]
    return acc


def first_hit_mxu_plain(rvec, prev, packed):
    """Plain PyTorch version of `first_hit_mxu` (any device)."""
    r, f = rvec.shape[0], packed.shape[0]
    rv = [rvec[:, k : k + 1] for k in range(9)]
    skip = prev[:, None]
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=rvec.device)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=rvec.device)
    step = _face_chunk(r, f)
    for f0 in range(0, f, step):
        c = packed[f0 : f0 + step].T[:, None, :]  # (19, 1, Fc)
        u_num = _dot_left(rv[0:6], c, range(0, 6))
        v_num = _dot_left(rv[0:6], c, range(6, 12))
        det = _dot_left(rv[3:6], c, range(12, 15))
        t_num = _dot_left(rv[6:9], c, range(15, 18)) + c[18]
        valid = det.abs() > _MXU_DET_EPS
        inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
        u = u_num * inv
        v = v_num * inv
        t = t_num * inv
        lane = torch.arange(f0, f0 + c.shape[2], device=rvec.device, dtype=torch.int32)
        hit = (valid & (u >= -MXU_EPS_UV) & (u <= 1.0 + MXU_EPS_UV) & (v >= -MXU_EPS_UV)
               & (u + v <= 1.0 + MXU_EPS_UV) & (t > MXU_T_EPS) & (lane[None, :] != skip))
        best_t, best_i = _fold_min(best_t, best_i, torch.where(hit, t, _BIG), f0)
    return best_t, torch.where(best_t >= _BIG, -1, best_i)


def first_hit_mxu(rvec, prev, packed):
    """Bilinear first hit of rays against an acoustic LOD.

    Arguments:
        rvec: (R, 9) ray vectors [o' x d, d, o'], o' the origin less the
            tables' centre.
        prev: (R,) int32 the face each ray may not hit (its launch face), -1
            for none.
        packed: (F, MXU_PACKED_COLS) per-face entries [e2, w2, -e1, -w1, -n,
            n, -k] (ops/mxu_first_hit.py builds them).

    Returns (t (R,), face (R,) int32): t = 3e38 and face = -1 on a miss; the
    window has the 2 % slop MXU_EPS_UV, t > 1e-4, |det| > 1e-6; on equal t
    the smallest face index wins.
    """
    if not _on_card(rvec):
        return first_hit_mxu_plain(rvec, prev, packed)
    r, f, dev = rvec.shape[0], packed.shape[0], rvec.device
    _check("ray vectors", rvec, (r, 9), torch.float32, dev)
    _check("launch faces", prev, (r,), torch.int32, dev)
    _check("face table", packed, (f, MXU_PACKED_COLS), torch.float32, dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("mxu_first_hit", "first_hit_mxu", [vp, vp, vp, ci, ci, vp, vp, vp])
    launch_counts["first_hit_mxu"] += 1
    _raise_on(fn(_ptr(rvec), _ptr(prev), _ptr(packed), r, f, _ptr(t), _ptr(idx), _stream(rvec)), "first_hit_mxu")
    return t, idx


# ---------------------------------------------------------------------------
# K9 and K10: the cone-sorted and the pair-walk first hits over Morton tiles
# of the big variant's face table
# ---------------------------------------------------------------------------

SORTED_TILE_FACES = 256  # Morton-sorted faces per tile (kTileFaces in both sources)
SFH_LANES = 512  # sorted rays per block (kBlock in csrc/sorted_first_hit.cu)
PFH_LANES = 512  # pair lanes per block, one tile each (kBlock in csrc/pair_first_hit.cu)


def _tile_fold(ray, faces, tl):
    """Each ray's smallest (t, sorted face index) over its tile: `ray` from
    `_plucker` with (A, L, 1) components, `faces` (A, 256, 16) the tiles'
    rows, `tl` (A,) their ids. (t (A, L), face (A, L)): 3e38 and 2**30 on a
    miss, the smallest index on equal t."""
    hit, t = _bilinear_pair(ray, faces.permute(2, 0, 1)[:, :, None, :])  # (A, L, 256)
    t_hit = torch.where(hit, t, _BIG)
    lane = torch.arange(SORTED_TILE_FACES, dtype=torch.int32, device=faces.device)
    f_hit = torch.where(hit, tl.to(torch.int32)[:, None, None] * SORTED_TILE_FACES + lane, _IDX_BIG)
    t_min = t_hit.amin(dim=2)
    return t_min, torch.where(t_hit == t_min[..., None], f_hit, _IDX_BIG).amin(dim=2)


def sorted_walk_plain(o, d, alive, perm, dlo, nv, face_tab):
    """The K9 kernel's walk in plain PyTorch (any device), vectorised over
    blocks: (t (R_pad,): 0 on dead lanes, 3e38 on a miss; sorted face
    (R_pad,) int32, -1 on a dead lane or a miss; tiles visited per block
    (n_blocks,) int64).

    Step i takes each block's tile perm[:, i] while i < nv and the block is
    not done; after it a block whose largest best t (dead lanes hold 0) is
    not above the next bound dlo[:, i + 1] (3e38 past nv) is done. Each ray
    keeps the smallest (t, sorted face index) over the tiles it visits."""
    r_pad = o.shape[0]
    nb, n_tiles = r_pad // SFH_LANES, face_tab.shape[0] // SORTED_TILE_FACES
    dev = o.device
    live = alive.reshape(nb, SFH_LANES) != 0
    ray = _plucker(o.reshape(nb, SFH_LANES, 3), d.reshape(nb, SFH_LANES, 3))
    faces = face_tab.reshape(n_tiles, SORTED_TILE_FACES, 16)
    best_t = torch.where(live, _BIG, 0.0)
    best_i = torch.full((nb, SFH_LANES), _IDX_BIG, dtype=torch.int32, device=dev)
    n_visit = nv.long().clamp(max=n_tiles)
    done = n_visit == 0
    visited = torch.zeros(nb, dtype=torch.int64, device=dev)
    per_chunk = max(1, _CHUNK_ELEMS // (SFH_LANES * SORTED_TILE_FACES))
    perm = perm.long()
    for i in range(n_tiles):
        blocks = torch.nonzero(~done & (i < n_visit)).flatten()
        if blocks.numel() == 0:
            break
        for b0 in range(0, blocks.numel(), per_chunk):
            b = blocks[b0 : b0 + per_chunk]
            tl = perm[b, i]
            t_min, i_min = _tile_fold(tuple(x[b] for x in ray), faces[tl], tl)
            best_t[b], best_i[b] = _lex_min(best_t[b], best_i[b], t_min, i_min)
        visited[blocks] += 1
        nxt = torch.where(i + 1 < n_visit[blocks], dlo[blocks, min(i + 1, n_tiles - 1)], _BIG)
        done[blocks] |= best_t[blocks].amax(dim=1) <= nxt
    t = best_t.reshape(-1)
    idx = torch.where((t >= _BIG) | ~live.reshape(-1), -1, best_i.reshape(-1))
    return t, idx, visited


def first_hit_sorted(o, d, alive, perm, dlo, nv, face_tab):
    """First hit of cone-sorted rays against Morton-tiled faces (K9).

    Arguments:
        o, d: (R_pad, 3) centred origins and directions, sorted by (origin
            cell, direction cone); alive: (R_pad,) int32, 1 for a live ray.
            R_pad is a multiple of SFH_LANES.
        perm: (n_blocks, n_tiles) int32 each block's tiles in ascending
            order of `dlo` (n_blocks, n_tiles), the directed entry bounds
            (3e38 past the reachable ones); nv: (n_blocks,) int32 the number
            of reachable tiles.
        face_tab: (n_tiles * SORTED_TILE_FACES, 16) the big variant's rows
            [e2, w2, -e1, -w1, -n, -k], zero rows as padding.

    Returns (t (R_pad,), sorted face (R_pad,) int32): t = 3e38 and face = -1
    on a miss, t = 0 and face = -1 on a dead lane. The smallest sorted index
    wins a tie, so on live rays the result is the dense big first hit over
    the sorted faces, as long as the bounds are conservative.
    """
    if not _on_card(o):
        t, idx, _ = sorted_walk_plain(o, d, alive, perm, dlo, nv, face_tab)
        return t, idx
    r_pad, dev = o.shape[0], o.device
    n_tiles = face_tab.shape[0] // SORTED_TILE_FACES
    nb = r_pad // SFH_LANES
    if r_pad % SFH_LANES or n_tiles == 0:
        raise ValueError(f"first_hit_sorted: {r_pad} rays are not whole blocks of {SFH_LANES}, or no tiles")
    _check("origins", o, (r_pad, 3), torch.float32, dev)
    _check("dirs", d, (r_pad, 3), torch.float32, dev)
    _check("alive", alive, (r_pad,), torch.int32, dev)
    _check("tile order", perm, (nb, n_tiles), torch.int32, dev)
    _check("tile bounds", dlo, (nb, n_tiles), torch.float32, dev)
    _check("reachable tiles", nv, (nb,), torch.int32, dev)
    _check("face table", face_tab, (n_tiles * SORTED_TILE_FACES, 16), torch.float32, dev)
    t = torch.empty(r_pad, dtype=torch.float32, device=dev)
    idx = torch.empty(r_pad, dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("sorted_first_hit", "first_hit_sorted", [vp, vp, vp, vp, vp, vp, vp, ci, ci, vp, vp, vp])
    launch_counts["first_hit_sorted"] += 1
    err = fn(_ptr(o), _ptr(d), _ptr(alive), _ptr(perm), _ptr(dlo), _ptr(nv), _ptr(face_tab), r_pad, n_tiles,
             _ptr(t), _ptr(idx), _stream(o))
    _raise_on(err, "first_hit_sorted")
    return t, idx


def pair_tile_plain(o, d, blk_tile, face_tab):
    """Plain PyTorch version of `first_hit_pair` (any device): each block of
    PFH_LANES lanes against its tile, vectorised over blocks."""
    n_lanes = o.shape[0]
    nb, n_tiles = n_lanes // PFH_LANES, face_tab.shape[0] // SORTED_TILE_FACES
    ray = _plucker(o.reshape(nb, PFH_LANES, 3), d.reshape(nb, PFH_LANES, 3))
    faces = face_tab.reshape(n_tiles, SORTED_TILE_FACES, 16)
    best_t = torch.full((nb, PFH_LANES), _BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((nb, PFH_LANES), _IDX_BIG, dtype=torch.int32, device=o.device)
    blocks = torch.nonzero((blk_tile >= 0) & (blk_tile < n_tiles)).flatten()
    per_chunk = max(1, _CHUNK_ELEMS // (PFH_LANES * SORTED_TILE_FACES))
    for b0 in range(0, blocks.numel(), per_chunk):
        b = blocks[b0 : b0 + per_chunk]
        tl = blk_tile[b].long()
        best_t[b], best_i[b] = _tile_fold(tuple(x[b] for x in ray), faces[tl], tl)
    t = best_t.reshape(-1)
    return t, torch.where(t >= _BIG, -1, best_i.reshape(-1))


def first_hit_pair(o, d, blk_tile, face_tab):
    """One round of the pair-walk first hit (K10): every lane against its
    block's tile.

    Arguments:
        o, d: (n_lanes, 3) centred ray origins and directions of the (ray,
            tile) pairs, laid out tile-aligned; n_lanes is a multiple of
            PFH_LANES; padding lanes carry zero rays.
        blk_tile: (n_lanes / PFH_LANES,) int32 the tile of each block of
            PFH_LANES lanes, -1 for a block that serves none.
        face_tab: (n_tiles * SORTED_TILE_FACES, 16) the big variant's rows.

    Returns (t (n_lanes,), sorted face (n_lanes,) int32): each lane's
    smallest (t, index) over its tile's faces, t = 3e38 and face = -1 on a
    miss or a block without a tile.
    """
    if not _on_card(o):
        return pair_tile_plain(o, d, blk_tile, face_tab)
    n_lanes, dev = o.shape[0], o.device
    n_tiles = face_tab.shape[0] // SORTED_TILE_FACES
    if n_lanes % PFH_LANES or n_tiles == 0:
        raise ValueError(f"first_hit_pair: {n_lanes} lanes are not whole blocks of {PFH_LANES}, or no tiles")
    _check("origins", o, (n_lanes, 3), torch.float32, dev)
    _check("dirs", d, (n_lanes, 3), torch.float32, dev)
    _check("block tiles", blk_tile, (n_lanes // PFH_LANES,), torch.int32, dev)
    _check("face table", face_tab, (n_tiles * SORTED_TILE_FACES, 16), torch.float32, dev)
    t = torch.empty(n_lanes, dtype=torch.float32, device=dev)
    idx = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _lib("pair_first_hit", "first_hit_pair", [vp, vp, vp, vp, ci, ci, vp, vp, vp])
    launch_counts["first_hit_pair"] += 1
    err = fn(_ptr(o), _ptr(d), _ptr(blk_tile), _ptr(face_tab), n_lanes, n_tiles, _ptr(t), _ptr(idx), _stream(o))
    _raise_on(err, "first_hit_pair")
    return t, idx
