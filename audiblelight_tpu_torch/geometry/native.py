"""ctypes bindings for the host BVH (csrc/host/geomlib.cpp).

Counterpart of audiblelight_tpu/geometry/native.py. The library is built at
first use with the reference's flags (`g++ -O3 -shared -fPIC`) into
`audiblelight_tpu_torch/_build/<hash>/`, keyed by a hash of the source and
the flags, and answers placement's small query batches on the host: point in
mesh, nearest-surface distance, first hit and segment occlusion. Bulk work
stays on the card. Where g++ is missing or the build fails, `native_available`
is False and callers take their torch queries instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from audiblelight_tpu_torch.utils import logger

SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "geomlib.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# The reference's flags exactly: no -march=native, so no contracted products
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_LIB = None
_LIB_FAILED = False


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / digest / "libgeom.so"


def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library; None when unavailable."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    so = lib_path()
    try:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"libgeom.{os.getpid()}.tmp.so")
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)], check=True, capture_output=True,
                           timeout=300)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
        logger.warning(f"Native geometry library unavailable ({e}); using device kernels only")
        _LIB_FAILED = True
        return None
    f32p, u8p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    lib.geom_build.argtypes = [f32p, ctypes.c_int32]
    lib.geom_build.restype = ctypes.c_int32
    lib.geom_free.argtypes = [ctypes.c_int32]
    lib.geom_contains.argtypes = [ctypes.c_int32, f32p, ctypes.c_int32, u8p]
    lib.geom_nearest.argtypes = [ctypes.c_int32, f32p, ctypes.c_int32, f32p]
    lib.geom_raycast.argtypes = [ctypes.c_int32, f32p, f32p, ctypes.c_int32, f32p, i32p]
    lib.geom_occluded.argtypes = [ctypes.c_int32, f32p, f32p, ctypes.c_int32, ctypes.c_float, u8p]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    """True when the library can be built and loaded."""
    return _load() is not None


def _f32(a) -> tuple:
    a = np.ascontiguousarray(np.atleast_2d(a), dtype=np.float32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _out(n: int, dtype, ctype) -> tuple:
    out = np.zeros(n, dtype=dtype)
    return out, out.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBVH:
    """A BVH over a triangle soup with batched host queries."""

    def __init__(self, triangles: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError("Native geometry library is unavailable")
        self._lib = lib
        tris, ptr = _f32(np.asarray(triangles).reshape(-1, 9))
        self._keepalive = tris
        self.n_tris = len(tris)
        self.handle = lib.geom_build(ptr, self.n_tris)
        if self.handle < 0:
            raise RuntimeError("BVH build failed")

    def contains(self, points: np.ndarray) -> np.ndarray:
        """(N,) bool: ray-parity inside test."""
        pts, ptr = _f32(points)
        out, optr = _out(len(pts), np.uint8, ctypes.c_uint8)
        self._lib.geom_contains(self.handle, ptr, len(pts), optr)
        return out.astype(bool)

    def nearest_surface_distance(self, points: np.ndarray) -> np.ndarray:
        """(N,) float32: distance to the nearest surface point."""
        pts, ptr = _f32(points)
        out, optr = _out(len(pts), np.float32, ctypes.c_float)
        self._lib.geom_nearest(self.handle, ptr, len(pts), optr)
        return out

    def ray_first_hit(self, origins: np.ndarray, dirs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(N,) t (inf = miss) and (N,) triangle ids (-1 = miss)."""
        o, optr = _f32(origins)
        d, dptr = _f32(dirs)
        t, tptr = _out(len(o), np.float32, ctypes.c_float)
        ids, iptr = _out(len(o), np.int32, ctypes.c_int32)
        self._lib.geom_raycast(self.handle, optr, dptr, len(o), tptr, iptr)
        return t, ids

    def segments_occluded(self, starts: np.ndarray, ends: np.ndarray, margin: float = 1e-4) -> np.ndarray:
        """(N,) bool: the open segment is blocked by the mesh."""
        s, sptr = _f32(starts)
        e, eptr = _f32(ends)
        out, optr = _out(len(s), np.uint8, ctypes.c_uint8)
        self._lib.geom_occluded(self.handle, sptr, eptr, len(s), ctypes.c_float(margin), optr)
        return out.astype(bool)

    def __del__(self):  # pragma: no cover - interpreter-shutdown safe
        try:
            self._lib.geom_free(self.handle)
        except Exception:
            pass
