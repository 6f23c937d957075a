"""Real-codec video IO: H.264 MP4 writing and any-format decoding, through a
thin C shim (csrc/host/h264mux.c) over the system FFmpeg libraries
(libavformat/libavcodec/libx264), bound with ctypes.

Counterpart of audiblelight_tpu/io/h264.py. The shim is built at first use
with `gcc -O2 -shared -fPIC ... -lavformat -lavcodec -lavutil` into
`audiblelight_tpu_torch/_build/<hash>/` (a hash of the source and the
flags), as geometry/native.py builds the host BVH. Where gcc, the FFmpeg
headers or libraries are missing, `h264_available()` is False (the build
error logged once) and the scene video's MP4 is MJPEG (io/mp4.py), as in
the reference: a codec choice, nothing to do with the card.

The reader decodes anything libavformat can open (H.264 MP4, the MJPEG
MP4/AVI of io/mp4.py and io/avi.py) back to RGB24 arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import weakref
from pathlib import Path
from typing import Iterable, Iterator, Optional, Tuple, Union

import numpy as np

from audiblelight_tpu_torch.utils import logger

SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "h264mux.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CC_FLAGS = ["-O2", "-shared", "-fPIC"]
LIBS = ["-lavformat", "-lavcodec", "-lavutil"]

_LIB = None
_LIB_FAILED = False


def lib_path() -> Path:
    """Where the shim of this source and these flags is built."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CC_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / digest / "libh264mux.so"


def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the shim; None when unavailable."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    so = lib_path()
    try:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"libh264mux.{os.getpid()}.tmp.so")
            subprocess.run(["gcc", *CC_FLAGS, "-o", str(tmp), str(SRC), *LIBS], check=True, capture_output=True,
                           timeout=300)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except subprocess.CalledProcessError as e:
        logger.warning(f"H.264 shim unavailable (the build failed: {e.stderr.decode(errors='replace')[-400:]}); "
                       f"MJPEG MP4 in use")
        _LIB_FAILED = True
        return None
    except (subprocess.TimeoutExpired, OSError) as e:
        logger.warning(f"H.264 shim unavailable ({e}); MJPEG MP4 in use")
        _LIB_FAILED = True
        return None
    lib.h264_writer_open.restype = ctypes.c_void_p
    lib.h264_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
    lib.h264_writer_write.restype = ctypes.c_int
    lib.h264_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.h264_writer_close.restype = ctypes.c_int
    lib.h264_writer_close.argtypes = [ctypes.c_void_p]
    lib.video_reader_open.restype = ctypes.c_void_p
    lib.video_reader_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_double)]
    lib.video_reader_next.restype = ctypes.c_int
    lib.video_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.video_reader_close.restype = None
    lib.video_reader_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def h264_available() -> bool:
    """True when the H.264 shim can be built and loaded."""
    return _load() is not None


def _as_rgb_array(frame) -> np.ndarray:
    if isinstance(frame, np.ndarray):
        arr = frame
    else:  # PIL Image
        if frame.mode != "RGB":
            frame = frame.convert("RGB")
        arr = np.asarray(frame)
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected HxWx3 RGB frame, got {arr.shape}")
    return arr


def write_h264_mp4(path: Union[str, Path], frames: Iterable, fps: int, crf: int = 20) -> Path:
    """Write RGB frames (PIL Images or HxWx3 uint8 arrays) as an H.264 MP4.

    Odd frame dimensions are padded by one edge-replicated row/column (4:2:0
    chroma needs even sizes). Raises RuntimeError when the shim is
    unavailable; the scene video then writes `write_mjpeg_mp4`.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("H.264 encoder shim unavailable")
    path = Path(path)
    wr = None
    w = h = None
    try:
        for frame in frames:
            arr = _as_rgb_array(frame)
            if arr.shape[0] % 2:
                arr = np.concatenate([arr, arr[-1:]], axis=0)
            if arr.shape[1] % 2:
                arr = np.concatenate([arr, arr[:, -1:]], axis=1)
            if wr is None:
                h, w = arr.shape[:2]
                wr = lib.h264_writer_open(str(path).encode(), w, h, int(fps), 1, int(crf))
                if not wr:
                    raise RuntimeError("h264_writer_open failed")
            elif arr.shape[:2] != (h, w):
                raise ValueError(f"Frame size {arr.shape[:2]} != first frame {(h, w)}")
            if lib.h264_writer_write(wr, arr.tobytes()) < 0:
                raise RuntimeError("h264_writer_write failed")
        if wr is None:
            raise ValueError("No frames to write")
    except Exception:
        if wr is not None:
            lib.h264_writer_close(wr)
        raise
    if lib.h264_writer_close(wr) < 0:
        raise RuntimeError("h264_writer_close failed")
    return path


def read_video_frames(path: Union[str, Path]) -> Tuple[Iterator[np.ndarray], int, int, float]:
    """Open a video and return (frame_iterator, width, height, fps): each frame
    an HxWx3 uint8 RGB array, decoded from any container/codec the system
    libavformat understands. The decoder closes when the iterator ends or is
    garbage-collected."""
    lib = _load()
    if lib is None:
        raise RuntimeError("video decoder shim unavailable")
    w, h, fps = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_double(0.0)
    rd = lib.video_reader_open(str(Path(path)).encode(), w, h, fps)
    if not rd:
        raise RuntimeError(f"could not open video {path}")
    width, height = int(w.value), int(h.value)
    closed = {"done": False}

    def _close():
        if not closed["done"]:
            closed["done"] = True
            lib.video_reader_close(rd)

    def _iter():
        buf = ctypes.create_string_buffer(width * height * 3)
        try:
            while True:
                ret = lib.video_reader_next(rd, buf)
                if ret == 0:
                    return
                if ret < 0:
                    raise RuntimeError(f"decode error {ret} in {path}")
                yield np.frombuffer(buf.raw, dtype=np.uint8).reshape(height, width, 3).copy()
        finally:
            _close()

    it = _iter()
    weakref.finalize(it, _close)
    return it, width, height, float(fps.value)


__all__ = ["h264_available", "write_h264_mp4", "read_video_frames"]
