"""Minimal ISO-BMFF (MP4) muxer for Motion-JPEG video: dependency-free.

Counterpart of audiblelight_tpu/io/mp4.py, byte for byte its files: every
frame is a JPEG (PIL encodes) and the file is a plain ISO base-media box
tree:

    ftyp
    mdat                      <- concatenated JPEG frames
    moov
      mvhd
      trak
        tkhd
        mdia
          mdhd, hdlr('vide')
          minf
            vmhd, dinf(dref('url '))
            stbl
              stsd('mp4v' + esds with objectTypeIndication 0x6C = JPEG)
              stts, stsc, stsz, stco

MJPEG rides the MPEG-4 Visual sample entry with the ISO/IEC 10918-1 (JPEG)
object type — the signalling ffmpeg/VLC produce and accept for JPEG-in-MP4.
Timescale is fixed at 1000 * fps so every frame has an integer duration.
"""

from __future__ import annotations

import io as _io
import struct
from pathlib import Path
from typing import Iterable, Union


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">I", (version << 24) | flags) + payload)


def _esds(avg_bitrate: int, max_frame: int) -> bytes:
    """ES descriptor declaring an ISO/IEC 10918-1 (JPEG) visual stream."""

    def desc(tag: int, payload: bytes) -> bytes:
        # Expandable size field, single byte is enough for these descriptors
        return bytes([tag, len(payload)]) + payload

    dec_conf = desc(
        0x04,
        struct.pack(
            ">BBBHII",
            0x6C,  # objectTypeIndication: ISO/IEC 10918-1 (JPEG)
            (0x04 << 2) | 1,  # streamType visual, upStream 0, reserved 1
            (max_frame >> 16) & 0xFF,
            max_frame & 0xFFFF,  # bufferSizeDB (24-bit, split)
            avg_bitrate,
            avg_bitrate,
        ),
    )
    sl_conf = desc(0x06, b"\x02")
    es = desc(0x03, struct.pack(">HB", 1, 0) + dec_conf + sl_conf)
    return _full(b"esds", 0, 0, es)


def write_mjpeg_mp4(
    path: Union[str, Path],
    frames: Iterable,
    fps: int,
    quality: int = 85,
) -> Path:
    """Write RGB frames (PIL Images or HxWx3 uint8 arrays) as an MJPEG MP4.

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
    timescale = 1000 * fps
    frame_dur = 1000
    duration = n * frame_dur
    total_bytes = sum(len(j) for j in jpegs)
    max_frame = max(len(j) for j in jpegs)
    avg_bitrate = max(1, int(total_bytes * 8 * fps / n))

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isommp41")
    mdat_payload = b"".join(jpegs)

    # Chunk offsets: one chunk holding all samples, starting right after the
    # mdat header, which itself follows ftyp.
    mdat_start = len(ftyp) + 8
    offsets = []
    off = mdat_start
    for j in jpegs:
        offsets.append(off)
        off += len(j)

    stsd = _full(
        b"stsd", 0, 0,
        struct.pack(">I", 1)
        + _box(
            b"mp4v",
            b"\x00" * 6
            + struct.pack(">H", 1)  # data_reference_index
            + b"\x00" * 16  # pre_defined/reserved
            + struct.pack(">HH", width, height)
            + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
            + struct.pack(">I", 0)
            + struct.pack(">H", 1)  # frame_count
            + b"\x00" * 32  # compressorname
            + struct.pack(">Hh", 24, -1)  # depth, pre_defined
            + _esds(avg_bitrate, max_frame),
        ),
    )
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, frame_dur))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full(
        b"stsz", 0, 0,
        struct.pack(">II", 0, n) + b"".join(struct.pack(">I", len(j)) for j in jpegs),
    )
    # Everything lives in ONE chunk; stco points at its start.
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, offsets[0]))
    # Single-chunk layout needs per-sample offsets only when samples_per_chunk
    # is 1; with all samples in one chunk the sizes in stsz walk the chunk.
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)

    dref = _full(b"dref", 0, 0, struct.pack(">I", 1) + _full(b"url ", 0, 1, b""))
    dinf = _box(b"dinf", dref)
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    minf = _box(b"minf", vmhd + dinf + stbl)

    mdhd = _full(
        b"mdhd", 0, 0,
        struct.pack(">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0),  # 'und'
    )
    hdlr = _full(
        b"hdlr", 0, 0,
        struct.pack(">I", 0) + b"vide" + b"\x00" * 12 + b"AudibleLight TPU video\x00",
    )
    mdia = _box(b"mdia", mdhd + hdlr + minf)

    tkhd = _full(
        b"tkhd", 0, 3,  # flags: enabled + in movie
        struct.pack(">IIIII", 0, 0, 1, 0, duration)
        + b"\x00" * 8
        + struct.pack(">HHHH", 0, 0, 0, 0)
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", width << 16, height << 16),
    )
    trak = _box(b"trak", tkhd + mdia)

    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, timescale, duration)
        + struct.pack(">IH", 0x00010000, 0x0100)  # rate, volume
        + b"\x00" * 10
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + b"\x00" * 24
        + struct.pack(">I", 2),  # next_track_ID
    )
    moov = _box(b"moov", mvhd + trak)

    out = Path(path)
    with open(out, "wb") as f:
        f.write(ftyp)
        f.write(_box(b"mdat", mdat_payload))
        f.write(moov)
    return out


__all__ = ["write_mjpeg_mp4"]
