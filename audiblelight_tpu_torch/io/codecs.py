"""Compressed-audio codecs: MP3 through the system libmpg123/libmp3lame, FLAC in Python.

The port's copy of audiblelight_tpu/io/codecs.py, with the same names and
results:

- MP3 decode binds the system `libmpg123` over ctypes (`mp3_read`,
  `mp3_duration`, `mp3_available`); encode binds `libmp3lame` the same way
  (`mp3_write`, `mp3_encode_available`). Where a library is absent the
  loaders raise the reference's error: a missing library is not a fallback.
- FLAC (`flac_read`, `flac_write`, `flac_duration`) is a self-contained
  implementation of the format (RFC 9639). The decoder returns the
  reference's samples bit for bit, but reads in numpy where the reference
  reads one field at a time: verbatim subframes and escaped residual
  partitions as one gather, the fixed predictors as repeated integer
  cumulative sums, and Rice residuals by walking the stream's one-bits
  (`bisect`) and extracting every quotient and remainder at once. The LPC
  predictor, whose floor shift makes it nonlinear, stays a sequential loop,
  over Python lists. `flac_write` writes the reference's bytes (verbatim
  subframes) by default; `method="fixed"` or `"lpc"` and a stereo
  decorrelation (`stereo=`) write Rice-coded frames, whose decode the
  verbatim files never reach.
"""

from __future__ import annotations

import ctypes
import operator
from bisect import bisect_left
from pathlib import Path
from typing import Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# MP3 decode: libmpg123 over ctypes
# ---------------------------------------------------------------------------

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_SIGNED_16 = 0xD0  # MPG123_ENC_16 | MPG123_ENC_SIGNED | 0x80

_mpg123 = None
_mpg123_failed = False


def _load_mpg123():
    global _mpg123, _mpg123_failed
    if _mpg123 is not None or _mpg123_failed:
        return _mpg123
    try:
        lib = ctypes.CDLL("libmpg123.so.0")
    except OSError:
        _mpg123_failed = True
        return None
    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_scan.argtypes = [ctypes.c_void_p]
    lib.mpg123_length.argtypes = [ctypes.c_void_p]
    lib.mpg123_length.restype = ctypes.c_long
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    _mpg123 = lib
    return lib


def mp3_available() -> bool:
    """True when the system libmpg123 can be loaded for MP3 decoding."""
    return _load_mpg123() is not None


def mp3_read(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Decode an MP3 file to float32. Returns ((channels, samples), sample_rate)."""
    lib = _load_mpg123()
    if lib is None:
        raise RuntimeError(
            "MP3 decoding requires the system libmpg123 shared library, which "
            "could not be loaded. Convert the file to WAV instead."
        )
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (code {err.value})")
    try:
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123 could not open {path}")
        rate, channels, enc = ctypes.c_long(0), ctypes.c_int(0), ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(enc)) != _MPG123_OK:
            raise RuntimeError(f"mpg123 could not read the format of {path}")
        # Decode in SIGNED_16 (forcing a format after open does not
        # renegotiate an open stream) and convert, as a 16-bit WAV would be
        if enc.value != _MPG123_ENC_SIGNED_16:
            lib.mpg123_format_none(h)
            lib.mpg123_format(h, rate.value, channels.value, _MPG123_ENC_SIGNED_16)

        chunks = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(buf.raw[: done.value], dtype=np.int16).copy())
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                # A changed rate or channel count mid-stream is refused, not
                # deinterleaved with the stale layout
                new_rate, new_ch, new_enc = ctypes.c_long(0), ctypes.c_int(0), ctypes.c_int(0)
                lib.mpg123_getformat(h, ctypes.byref(new_rate), ctypes.byref(new_ch), ctypes.byref(new_enc))
                if (new_rate.value, new_ch.value) != (rate.value, channels.value):
                    raise RuntimeError(
                        f"MP3 stream {path} changed format mid-stream "
                        f"({rate.value} Hz x {channels.value}ch -> "
                        f"{new_rate.value} Hz x {new_ch.value}ch); refusing to "
                        "decode a mixed-format stream."
                    )
                continue
            if rc != _MPG123_OK:
                raise RuntimeError(f"mpg123_read failed with code {rc} on {path}")
        flat = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int16)
        n = flat.size // channels.value
        audio = flat[: n * channels.value].reshape(n, channels.value).T
        return np.ascontiguousarray(audio).astype(np.float32) / 32768.0, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def mp3_duration(path: Union[str, Path]) -> float:
    """Duration of an MP3 file in seconds (frame scan, no full decode)."""
    lib = _load_mpg123()
    if lib is None:
        raise RuntimeError("MP3 support requires the system libmpg123 library.")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    try:
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123 could not open {path}")
        rate, channels, enc = ctypes.c_long(0), ctypes.c_int(0), ctypes.c_int(0)
        lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(enc))
        lib.mpg123_scan(h)
        n = lib.mpg123_length(h)
        if n < 0:
            raise RuntimeError(f"mpg123 could not determine the length of {path}")
        return float(n) / float(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


# ---------------------------------------------------------------------------
# MP3 encode: libmp3lame over ctypes
# ---------------------------------------------------------------------------

_lame = None
_lame_failed = False


def _load_lame():
    global _lame, _lame_failed
    if _lame is not None or _lame_failed:
        return _lame
    try:
        lib = ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        _lame_failed = True
        return None
    lib.lame_init.restype = ctypes.c_void_p
    for fn in ("lame_set_in_samplerate", "lame_set_num_channels", "lame_set_brate", "lame_set_quality"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lame_init_params.argtypes = [ctypes.c_void_p]
    lib.lame_encode_buffer_ieee_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.lame_close.argtypes = [ctypes.c_void_p]
    _lame = lib
    return lib


def mp3_encode_available() -> bool:
    """True when the system libmp3lame can be loaded for MP3 encoding."""
    return _load_lame() is not None


def mp3_write(path: Union[str, Path], audio: np.ndarray, sr: int, bitrate_kbps: int = 192) -> None:
    """Encode float32 audio ((channels, samples) or (samples,)) as MP3."""
    lib = _load_lame()
    if lib is None:
        raise RuntimeError("MP3 encoding requires the system libmp3lame library.")
    audio = np.atleast_2d(np.asarray(audio, dtype=np.float32))
    if audio.shape[0] > 2:
        raise ValueError(f"MP3 supports at most 2 channels, got {audio.shape[0]}")
    n = audio.shape[1]
    left = np.ascontiguousarray(audio[0])
    right = np.ascontiguousarray(audio[1] if audio.shape[0] == 2 else audio[0])

    h = lib.lame_init()
    try:
        lib.lame_set_in_samplerate(h, int(sr))
        lib.lame_set_num_channels(h, audio.shape[0])
        lib.lame_set_brate(h, int(bitrate_kbps))
        lib.lame_set_quality(h, 2)
        if lib.lame_init_params(h) < 0:
            raise RuntimeError(f"lame_init_params rejected sr={sr}")
        out = ctypes.create_string_buffer(int(1.25 * n) + 7200)
        written = lib.lame_encode_buffer_ieee_float(
            h, left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, out, len(out),
        )
        if written < 0:
            raise RuntimeError(f"lame encode failed with code {written}")
        tail = ctypes.create_string_buffer(7200)
        flushed = lib.lame_encode_flush(h, tail, len(tail))
        with open(path, "wb") as f:
            f.write(out.raw[:written])
            f.write(tail.raw[:flushed])
    finally:
        lib.lame_close(h)


# ---------------------------------------------------------------------------
# FLAC: decoder
# ---------------------------------------------------------------------------


class _BitReader:
    """MSB-first bit reader over a bytes object (the frame and subframe
    headers; the sample payloads are read in bulk from `words`)."""

    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8  # position in bits
        # The stream as uint8, padded so an 8-byte gather never runs off the end
        self.words = np.frombuffer(bytes(data) + bytes(8), dtype=np.uint8)
        self._ones = None  # (first bit, sorted one-bit positions) of the walk window

    def read(self, n: int) -> int:
        """Read n bits as an unsigned integer."""
        end = self.pos + n
        first, last = self.pos >> 3, (end + 7) >> 3
        chunk = int.from_bytes(self.data[first:last], "big")
        val = (chunk >> ((last << 3) - end)) & ((1 << n) - 1)
        self.pos = end
        return val

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count zero bits until the terminating 1."""
        count = 0
        while True:
            bit_in_byte = self.pos & 7
            rest = self.data[self.pos >> 3] & (0xFF >> bit_in_byte)
            if rest == 0:
                count += 8 - bit_in_byte
                self.pos += 8 - bit_in_byte
                continue
            zeros = (8 - bit_in_byte) - rest.bit_length()
            self.pos += zeros + 1
            return count + zeros

    def fields(self, pos: np.ndarray, width: int) -> np.ndarray:
        """The unsigned `width`-bit fields (width <= 57) at bit positions `pos`, as int64."""
        b = pos >> 3
        w = self.words
        word = np.zeros(pos.shape, dtype=np.uint64)
        for k in range(8):
            word = (word << np.uint64(8)) | w[b + k].astype(np.uint64)
        shift = (np.uint64(64 - width) - (pos & 7).astype(np.uint64))
        return ((word >> shift) & np.uint64((1 << width) - 1)).astype(np.int64)

    def read_signed_block(self, n: int, width: int) -> np.ndarray:
        """n consecutive signed `width`-bit fields, as int64."""
        if width == 0:
            return np.zeros(n, dtype=np.int64)
        v = self.fields(self.pos + width * np.arange(n, dtype=np.int64), width)
        self.pos += width * n
        return np.where(v >> (width - 1), v - (1 << width), v)

    def terminators(self, n: int, param: int) -> list:
        """Bit positions of the unary terminators of n Rice codes with
        parameter `param` starting here: each is the first one-bit at or
        after its code's start, the next code starting `param` bits after
        it. Leaves the reader after the last code."""
        out = []
        p = self.pos
        first, ones = self._ones if self._ones is not None else (0, [])
        j = 0
        for _ in range(n):
            while True:
                if p >= first:
                    j = bisect_left(ones, p, j)
                    if j < len(ones):
                        break
                first, ones = self._ones = self._window(p)
                if not ones:
                    raise ValueError("FLAC residual runs past the end of the stream")
                j = 0
            t = ones[j]
            out.append(t)
            p = t + 1 + param
        self.pos = p
        return out

    def _window(self, p: int) -> tuple:
        """(first bit, sorted one-bit positions) of a window from bit p,
        grown until it holds a one-bit (a unary code can be long)."""
        size = 1 << 18
        while True:
            b0 = p >> 3
            bits = np.unpackbits(self.words[b0 : b0 + (size >> 3)])
            ones = np.flatnonzero(bits) + (b0 << 3)
            ones = ones[ones >= p]
            if len(ones) or (b0 + (size >> 3)) >= len(self.words):
                return p, ones.tolist()
            size <<= 1

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3


def _read_utf8_coded_number(br: _BitReader) -> int:
    """FLAC frame-header sample/frame number (UTF-8-style variable length)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n_follow, mask = 0, 0x40
    while b0 & mask:
        n_follow += 1
        mask >>= 1
    val = b0 & (mask - 1)
    for _ in range(n_follow):
        val = (val << 6) | (br.read(8) & 0x3F)
    return val


_FLAC_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768,
}
_FLAC_BIT_DEPTHS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_residual(br: _BitReader, block_size: int, pred_order: int) -> np.ndarray:
    """Rice-coded residual partitions (both 4- and 5-bit parameter methods)."""
    method = br.read(2)
    if method > 1:
        raise ValueError(f"Reserved FLAC residual coding method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = br.read(4)
    out = np.empty(block_size - pred_order, dtype=np.int64)
    idx = 0
    for p in range(1 << part_order):
        n = (block_size >> part_order) - (pred_order if p == 0 else 0)
        param = br.read(param_bits)
        if param == escape:
            out[idx : idx + n] = br.read_signed_block(n, br.read(5))
        elif n:
            start = br.pos
            t = np.asarray(br.terminators(n, param), dtype=np.int64)
            begin = np.empty_like(t)
            begin[0] = start
            begin[1:] = t[:-1] + 1 + param
            v = (t - begin) << param
            if param:
                v |= br.fields(t + 1, param)
            out[idx : idx + n] = (v >> 1) ^ -(v & 1)  # zigzag
        idx += n
    return out


def _integrate(warm: list, resid: np.ndarray, order: int) -> np.ndarray:
    """The fixed predictor of `order` undone: the residual is the signal's
    order-th difference, so `order` cumulative sums, each started from the
    warm-up samples' difference of that rank, rebuild it exactly."""
    d = np.asarray(warm, dtype=np.int64)
    starts = []
    for _ in range(order):
        starts.append(d[-1])
        d = np.diff(d)
    x = resid
    for s in reversed(starts):
        x = s + np.cumsum(x)
    return np.concatenate([np.asarray(warm, dtype=np.int64), x])


def _lpc(warm: list, coeffs: list, shift: int, resid: np.ndarray) -> np.ndarray:
    """The LPC predictor undone, in order (its floor shift is not linear)."""
    order = len(warm)
    s = list(warm) + resid.tolist()
    rev = coeffs[::-1]  # rev[j] multiplies s[i - order + j]
    mul = operator.mul
    for i in range(order, len(s)):
        s[i] += sum(map(mul, rev, s[i - order : i])) >> shift
    return np.asarray(s, dtype=np.int64)


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("Invalid FLAC subframe sync bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        samples = np.full(block_size, br.read_signed(bps), dtype=np.int64)
    elif sf_type == 1:  # VERBATIM
        samples = br.read_signed_block(block_size, bps)
    elif 8 <= sf_type <= 12:  # FIXED, order 0-4
        order = sf_type - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        samples = _integrate(warm, _decode_residual(br, block_size, order), order)
    elif sf_type >= 32:  # LPC, order 1-32
        order = sf_type - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("Invalid FLAC LPC precision")
        shift = br.read_signed(5)
        coeffs = [br.read_signed(precision) for _ in range(order)]
        samples = _lpc(warm, coeffs, shift, _decode_residual(br, block_size, order))
    else:
        raise ValueError(f"Reserved FLAC subframe type {sf_type}")

    if wasted:
        samples <<= wasted
    return samples


def _streaminfo(data: bytes, path) -> tuple:
    """(STREAMINFO bytes, offset of the first frame) of a FLAC file."""
    if data[:4] != b"fLaC":
        raise ValueError(f"{path} is not a FLAC file")
    pos, streaminfo = 4, None
    while True:
        header = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        if header & 0x7F == 0:
            streaminfo = data[pos + 4 : pos + 4 + length]
        pos += 4 + length
        if header & 0x80:
            break
    if streaminfo is None:
        raise ValueError("FLAC file has no STREAMINFO block")
    return streaminfo, pos


def flac_read(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file to float32. Returns ((channels, samples), sample_rate).

    Metadata blocks, frame headers, constant/verbatim/fixed/LPC subframes,
    Rice residuals and stereo decorrelation; CRCs are not verified (files
    are trusted local assets), as in the reference.
    """
    data = Path(path).read_bytes()
    streaminfo, pos = _streaminfo(data, path)
    si = _BitReader(streaminfo)
    si.read(16 + 16 + 24 + 24)  # block and frame size bounds
    sample_rate = si.read(20)
    n_channels = si.read(3) + 1
    bps_si = si.read(5) + 1
    total_samples = si.read(36)

    channels = [[] for _ in range(n_channels)]
    br = _BitReader(data, pos)
    n_bytes = len(data)
    decoded = 0
    while br.byte_pos() < n_bytes - 2 and (total_samples == 0 or decoded < total_samples):
        if br.read(14) != 0x3FFE:
            raise ValueError(f"Lost FLAC frame sync at byte {br.byte_pos()}")
        br.read(2)  # reserved, blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        bd_code = br.read(3)
        br.read(1)  # reserved
        _read_utf8_coded_number(br)
        if bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = _FLAC_BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        bps = _FLAC_BIT_DEPTHS.get(bd_code, bps_si)
        br.read(8)  # header CRC-8 (unverified)

        if ch_code < 8:
            if ch_code + 1 != n_channels:
                raise ValueError("FLAC frame channel count mismatch")
            subs = [_decode_subframe(br, block_size, bps) for _ in range(n_channels)]
        elif ch_code == 8:  # left/side
            left = _decode_subframe(br, block_size, bps)
            side = _decode_subframe(br, block_size, bps + 1)
            subs = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _decode_subframe(br, block_size, bps + 1)
            right = _decode_subframe(br, block_size, bps)
            subs = [right + side, right]
        elif ch_code == 10:  # mid/side
            mid = _decode_subframe(br, block_size, bps)
            side = _decode_subframe(br, block_size, bps + 1)
            left = ((mid << 1) | (side & 1)) + side
            subs = [left >> 1, (left - (side << 1)) >> 1]
        else:
            raise ValueError(f"Reserved FLAC channel assignment {ch_code}")

        br.align()
        br.read(16)  # frame CRC-16 (unverified)
        for c, s in enumerate(subs):
            channels[c].append(s)
        decoded += block_size

    arrs = [np.concatenate(c) if c else np.zeros(0, dtype=np.int64) for c in channels]
    if total_samples:
        arrs = [a[:total_samples] for a in arrs]
    audio = np.stack(arrs).astype(np.float32) / float(1 << (bps_si - 1))
    return audio, int(sample_rate)


def flac_duration(path: Union[str, Path]) -> float:
    """Duration of a FLAC file in seconds, from STREAMINFO only."""
    with open(path, "rb") as f:
        if f.read(4) != b"fLaC":
            raise ValueError(f"{path} is not a FLAC file")
        length = int.from_bytes(f.read(4)[1:4], "big")
        si = _BitReader(f.read(length))
    si.read(16 + 16 + 24 + 24)
    sample_rate = si.read(20)
    si.read(3)
    si.read(5)
    total = si.read(36)
    if sample_rate == 0:
        raise ValueError(f"FLAC STREAMINFO of {path} has no sample rate")
    return total / sample_rate


# ---------------------------------------------------------------------------
# FLAC: encoder
# ---------------------------------------------------------------------------


def _crc_table(poly: int, width: int, in_bits: int) -> list:
    """CRC of every `in_bits`-bit input (in_bits <= width) fed into a zero
    register, MSB first."""
    top, mask = 1 << (width - 1), (1 << width) - 1
    crc = np.arange(1 << in_bits, dtype=np.int64) << (width - in_bits)
    for _ in range(in_bits):
        crc = np.where(crc & top, ((crc << 1) ^ poly) & mask, (crc << 1) & mask)
    return crc.tolist()


_CRC8 = _crc_table(0x07, 8, 8)
_CRC16_WORD = None  # CRC-16 of each 16-bit word, built on first use


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC8[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    """FLAC's CRC-16 (poly 0x8005, MSB first), two bytes a step."""
    global _CRC16_WORD
    if _CRC16_WORD is None:
        _CRC16_WORD = _crc_table(0x8005, 16, 16)
    table, crc = _CRC16_WORD, 0
    for w in np.frombuffer(data[: len(data) & ~1], dtype=">u2").tolist():
        crc = table[crc ^ w]
    if len(data) & 1:  # the odd last byte: eight shifts
        crc ^= data[-1] << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


class _BitWriter:
    """MSB-first bit writer: scalar fields, and runs of bits appended as a
    0/1 uint8 array (packed once, at the end)."""

    def __init__(self):
        self.parts: list = []

    def write(self, value: int, n: int) -> None:
        if n:
            self.parts.append(((int(value) & ((1 << n) - 1)) >> np.arange(n - 1, -1, -1)) & 1)

    def write_block(self, values: np.ndarray, n: int) -> None:
        """Each of `values` as an n-bit two's-complement field."""
        v = np.asarray(values, dtype=np.int64) & ((1 << n) - 1)
        self.parts.append(((v[:, None] >> np.arange(n - 1, -1, -1)) & 1).ravel())

    def write_bits(self, bits: np.ndarray) -> None:
        self.parts.append(np.asarray(bits, dtype=np.int64))

    def align(self) -> None:
        n = sum(len(p) for p in self.parts)
        if n & 7:
            self.write(0, 8 - (n & 7))

    def bytes(self) -> bytes:
        bits = np.concatenate(self.parts) if self.parts else np.zeros(0, dtype=np.int64)
        assert len(bits) % 8 == 0
        return np.packbits(bits.astype(np.uint8)).tobytes()


def _rice_bits(resid: np.ndarray, param: int) -> np.ndarray:
    """The Rice codes of `resid` (zigzag-mapped) as a 0/1 array."""
    u = np.where(resid >= 0, resid << 1, ((-resid) << 1) - 1)
    q = u >> param
    lengths = q + 1 + param
    ends = np.cumsum(lengths)
    bits = np.zeros(int(ends[-1]) if len(ends) else 0, dtype=np.int64)
    starts = ends - lengths
    bits[starts + q] = 1  # the unary terminators
    if param:
        r = u & ((1 << param) - 1)
        pos = (starts + q + 1)[:, None] + np.arange(param)
        bits[pos.ravel()] = ((r[:, None] >> np.arange(param - 1, -1, -1)) & 1).ravel()
    return bits


def _write_residual(bw: _BitWriter, resid: np.ndarray, block: int, order: int) -> None:
    """Rice partitions (4-bit parameters), partition order 2 where the block
    allows; a partition whose raw two's-complement fields are shorter than
    its Rice codes (a silent one, or one with outliers) is escaped."""
    part_order = 2 if block % 4 == 0 and block // 4 > order else 0
    bw.write(0, 2)
    bw.write(part_order, 4)
    n_part = block >> part_order
    idx = 0
    for p in range(1 << part_order):
        n = n_part - (order if p == 0 else 0)
        r = resid[idx : idx + n]
        idx += n
        mean = float(np.mean(np.abs(r))) if n else 0.0
        param = int(min(14, max(0, np.floor(np.log2(mean)) if mean >= 1 else 0)))
        bits = _rice_bits(r, param) if n else np.zeros(0, dtype=np.int64)
        peak = int(np.max(np.abs(r))) if n else 0
        raw = 0 if peak == 0 else peak.bit_length() + 1
        if n and raw <= 31 and 5 + raw * n < len(bits):
            bw.write(15, 4)  # escape: raw fields follow
            bw.write(raw, 5)
            if raw:
                bw.write_block(r, raw)
            continue
        bw.write(param, 4)
        if n:
            bw.write_bits(bits)


def _lpc_coeffs(x: np.ndarray, order: int, precision: int) -> tuple:
    """Quantised least-squares predictor of `x`: (coefficients, shift)."""
    if len(x) <= 2 * order or not np.any(x):
        return [0] * order, 0
    rows = np.stack([x[order - 1 - k : len(x) - 1 - k] for k in range(order)], axis=1).astype(np.float64)
    a, *_ = np.linalg.lstsq(rows, x[order:].astype(np.float64), rcond=None)
    peak = float(np.max(np.abs(a)))
    shift = 0 if peak == 0 else int(np.clip(precision - 2 - np.ceil(np.log2(peak + 1e-12)), 0, 15))
    lim = (1 << (precision - 1)) - 1
    return np.clip(np.round(a * (1 << shift)), -lim, lim).astype(np.int64).tolist(), shift


def _write_subframe(bw: _BitWriter, x: np.ndarray, bps: int, method: str) -> None:
    """One subframe of the int64 samples `x` at `bps` bits."""
    bw.write(0, 1)
    n = len(x)
    if method == "verbatim" or n <= 4:
        bw.write(1, 6)
        bw.write(0, 1)
        bw.write_block(x, bps)
        return
    if method == "fixed":
        order = 2
        bw.write(8 + order, 6)
        bw.write(0, 1)
        bw.write_block(x[:order], bps)
        _write_residual(bw, np.diff(x, n=order), n, order)
        return
    order, precision = 4, 12
    coeffs, shift = _lpc_coeffs(x, order, precision)
    pred = sum(c * x[order - 1 - k : n - 1 - k] for k, c in enumerate(coeffs))
    resid = x[order:] - (pred >> shift)
    bw.write(31 + order, 6)
    bw.write(0, 1)
    bw.write_block(x[:order], bps)
    bw.write(precision - 1, 4)
    bw.write(shift, 5)
    bw.write_block(np.asarray(coeffs), precision)
    _write_residual(bw, resid, n, order)


_STEREO = {"independent": None, "left_side": 8, "right_side": 9, "mid_side": 10}


def flac_write(path: Union[str, Path], audio: np.ndarray, sr: int, bps: int = 16,
               method: str = "verbatim", stereo: str = "independent") -> None:
    """Write float32 audio ((channels, samples) or (samples,)) as a FLAC file.

    The default writes verbatim subframes, the reference's bytes (a valid
    container with correct CRCs and a zero MD5). `method="fixed"` (order-2
    fixed predictor) or `"lpc"` (order-4 quantised least-squares
    predictor) writes Rice-coded residuals; for two channels `stereo`
    ("left_side", "right_side", "mid_side") decorrelates them. Every method
    is lossless.
    """
    audio = np.atleast_2d(np.asarray(audio))
    n_ch, n = audio.shape
    if not 1 <= n_ch <= 8:
        raise ValueError(f"FLAC supports 1-8 channels, got {n_ch}")
    if method not in ("verbatim", "fixed", "lpc") or stereo not in _STEREO:
        raise ValueError(f"Unknown FLAC method {method!r} or stereo mode {stereo!r}")
    if _STEREO[stereo] is not None and n_ch != 2:
        raise ValueError(f"stereo={stereo!r} needs two channels, got {n_ch}")
    q = np.clip(np.round(audio * (1 << (bps - 1))), -(1 << (bps - 1)), (1 << (bps - 1)) - 1).astype(np.int64)

    block = 4096
    out = bytearray(b"fLaC")
    si = _BitWriter()
    for value, bits in ((block, 16), (block, 16), (0, 24), (0, 24), (sr, 20), (n_ch - 1, 3), (bps - 1, 5), (n, 36)):
        si.write(value, bits)
    streaminfo = si.bytes() + bytes(16)  # zero MD5 (unset)
    out += bytes([0x80]) + len(streaminfo).to_bytes(3, "big") + streaminfo

    for fi, start in enumerate(range(0, n, block)):
        bs = min(block, n - start)
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)  # fixed block size
        bw.write(7, 4)  # 16-bit block size follows
        bw.write(0, 4)  # sample rate: from STREAMINFO
        bw.write(n_ch - 1 if _STEREO[stereo] is None else _STEREO[stereo], 4)
        bw.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps], 3)
        bw.write(0, 1)
        if fi < 0x80:  # frame number, UTF-8 coded
            bw.write(fi, 8)
        elif fi < 0x800:
            bw.write(0xC0 | (fi >> 6), 8)
            bw.write(0x80 | (fi & 0x3F), 8)
        else:
            bw.write(0xE0 | (fi >> 12), 8)
            bw.write(0x80 | ((fi >> 6) & 0x3F), 8)
            bw.write(0x80 | (fi & 0x3F), 8)
        bw.write(bs - 1, 16)
        bw.align()
        header = bw.bytes()
        header += bytes([_crc8(header)])

        x = q[:, start : start + bs]
        if stereo == "left_side":
            subs = [(x[0], bps), (x[0] - x[1], bps + 1)]
        elif stereo == "right_side":
            subs = [(x[0] - x[1], bps + 1), (x[1], bps)]
        elif stereo == "mid_side":
            subs = [((x[0] + x[1]) >> 1, bps), (x[0] - x[1], bps + 1)]
        else:
            subs = [(x[c], bps) for c in range(n_ch)]
        body = _BitWriter()
        for s, b in subs:
            _write_subframe(body, s, b, method)
        body.align()
        frame = header + body.bytes()
        frame += _crc16(frame).to_bytes(2, "big")
        out += frame

    Path(path).write_bytes(bytes(out))
