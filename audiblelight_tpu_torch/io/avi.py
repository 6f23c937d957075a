"""Minimal RIFF AVI muxer (MJPEG): dependency-free video output.

Counterpart of audiblelight_tpu/io/avi.py, byte for byte its files: every
frame is a JPEG (PIL encodes), and the container is plain RIFF, the chunk
format of the WAV writer in io/audio.py. MJPEG-AVI opens in every
mainstream player and is trivially transcodable to MP4.

Layout written:
  RIFF('AVI ')
    LIST('hdrl') -> 'avih' + LIST('strl') -> 'strh' + 'strf'(BITMAPINFOHEADER)
    LIST('movi') -> '00dc' JPEG frames
    'idx1' index
"""

from __future__ import annotations

import io as _io
import struct
from pathlib import Path
from typing import Iterable, Union


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    data = fourcc + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        data += b"\x00"  # RIFF chunks are word-aligned
    return data


def _list(list_type: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", list_type + payload)


def write_mjpeg_avi(
    path: Union[str, Path],
    frames: Iterable,
    fps: int,
    quality: int = 85,
) -> Path:
    """Write RGB frames (PIL Images or HxWx3 uint8 arrays) as an MJPEG AVI.

    Returns the output path. All frames must share one size.
    """
    from PIL import Image

    jpegs: list[bytes] = []
    width = height = None
    for frame in frames:
        img = frame if isinstance(frame, Image.Image) else Image.fromarray(frame)
        if img.mode != "RGB":
            img = img.convert("RGB")
        if width is None:
            width, height = img.size
        elif img.size != (width, height):
            raise ValueError(f"Frame size {img.size} != first frame {(width, height)}")
        buf = _io.BytesIO()
        img.save(buf, format="JPEG", quality=quality)
        jpegs.append(buf.getvalue())
    if not jpegs:
        raise ValueError("No frames to write")

    n = len(jpegs)
    max_bytes = max(len(j) for j in jpegs)

    # 'avih' main header
    avih = struct.pack(
        "<14I",
        int(1_000_000 / fps),  # microseconds per frame
        max_bytes * fps,       # max bytes per second
        0,                     # padding granularity
        0x10,                  # flags: AVIF_HASINDEX
        n,                     # total frames
        0,                     # initial frames
        1,                     # streams
        max_bytes,             # suggested buffer size
        width,
        height,
        0, 0, 0, 0,            # reserved
    )

    # 'strh' stream header ('vids'/'MJPG')
    strh = (
        b"vids"
        + b"MJPG"
        + struct.pack(
            "<IHHIIIIIIIII",
            0, 0, 0,           # flags, priority, language
            0,                  # initial frames
            1, fps,             # scale, rate -> fps
            0, n,               # start, length
            max_bytes,          # suggested buffer size
            0xFFFFFFFF,         # quality (default)
            0, 0,               # sample size, rcFrame (packed as two zero dwords)
        )
        + struct.pack("<HH", width, height)
    )

    # 'strf' BITMAPINFOHEADER
    strf = struct.pack(
        "<IiiHH4sIiiII",
        40, width, height, 1, 24, b"MJPG", width * height * 3, 0, 0, 0, 0
    )

    hdrl = _list(
        b"hdrl",
        _chunk(b"avih", avih) + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)),
    )

    movi_payload = b"movi"
    idx_entries = []
    offset = 4  # offsets in idx1 count from the start of the 'movi' list payload
    for jpeg in jpegs:
        idx_entries.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(jpeg)))
        chunk = _chunk(b"00dc", jpeg)
        movi_payload += chunk
        offset += len(chunk)
    movi = _chunk(b"LIST", movi_payload)
    idx1 = _chunk(b"idx1", b"".join(idx_entries))

    riff_payload = b"AVI " + hdrl + movi + idx1
    path = Path(path)
    with open(path, "wb") as f:
        f.write(_chunk(b"RIFF", riff_payload))
    return path


def read_avi_frame_count(path: Union[str, Path]) -> int:
    """Total frame count from the 'avih' header (for round-trip checks)."""
    with open(path, "rb") as f:
        data = f.read(1024)
    i = data.index(b"avih")
    return struct.unpack("<I", data[i + 24 : i + 28])[0]
