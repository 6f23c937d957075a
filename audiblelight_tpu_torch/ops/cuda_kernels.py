"""The tracer's three kernels: wrappers for the CUDA kernels in `csrc/` and
their plain PyTorch versions.

Counterpart of audiblelight_tpu/ops/pallas_kernels.py:

- `ray_first_hit`       <- ray_first_hit_pallas (big and small variants)
- `segments_occluded`   <- segments_occluded_pallas
- `deposit_histogram`   <- deposit_histogram_pallas

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

launch_counts = {"first_hit_big": 0, "first_hit_small": 0, "any_hit": 0, "deposit_histogram": 0}


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


def _first_hit_big_plain(o, d, tab):
    """Plain version of _first_hit_big_kernel on centred origins `o`."""
    r, f = o.shape[0], tab.shape[0]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    odx = oy * dz - oz * dy
    ody = oz * dx - ox * dz
    odz = ox * dy - oy * dx
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    step = _face_chunk(r, f)
    for f0 in range(0, f, step):
        c = tab[f0 : f0 + step].T[:, None, :]  # (16, 1, Fc)
        u_num = (odx * c[0] + ody * c[1] + odz * c[2]) + (dx * c[3] + dy * c[4] + dz * c[5])
        v_num = (odx * c[6] + ody * c[7] + odz * c[8]) + (dx * c[9] + dy * c[10] + dz * c[11])
        a = dx * c[12] + dy * c[13] + dz * c[14]
        t_num = c[15] - (ox * c[12] + oy * c[13] + oz * c[14])
        inv = 1.0 / a
        u = u_num * inv
        v = v_num * inv
        t = t_num * inv
        hit = (u >= -_EPS) & (u <= 1.0 + _EPS) & (v >= -_EPS) & (u + v <= 1.0 + _EPS) & (t > _EPS)
        best_t, best_i = _fold_min(best_t, best_i, torch.where(hit, t, _BIG), f0)
    return best_t, best_i


def _mt_pair(o, d, c):
    """Classic Moller-Trumbore for rays (R, 1) x faces c = (9, 1, Fc):
    (valid_a, u, v, t), as the Pallas small and any-hit bodies write it."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = c
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
