"""WAV audio I/O and decode-time processing (mono mix, offset/duration, resample).

Counterpart of audiblelight_tpu/io/audio.py: WAV files (PCM 8/16/24/32-bit
and IEEE float 32/64 read, int16 and float32 written, a slice read without
decoding the rest), MP3 through the system libmpg123 and FLAC through the
port's own decoder (`io/codecs.py`, both decoded whole, then sliced), with
the same slicing and the same scipy polyphase resampler.
"""

from __future__ import annotations

import struct
from math import gcd
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
from scipy.signal import resample_poly

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _check_format(path) -> str:
    """The lower-case suffix of a supported audio file (wav, mp3, flac)."""
    suffix = Path(path).suffix.lower()
    if suffix not in (".wav", ".mp3", ".flac"):
        raise ValueError(
            f"Unsupported audio format '{suffix}' (wav/mp3/flac are supported). "
            f"Convert other formats to WAV."
        )
    return suffix


def _read_header(path) -> tuple[int, int, int, int, int, int]:
    """(fmt_tag, channels, sample rate, bits, data offset, data size) of a WAV file."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError("Not a RIFF/WAVE file")
        fmt = data = None
        while fmt is None or data is None:
            chunk = f.read(8)
            if len(chunk) < 8:
                raise ValueError(f"Missing fmt/data chunk in WAV file {path}")
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            offset = f.tell()
            if cid == b"fmt ":
                raw = f.read(size)
                tag, channels, sr = struct.unpack_from("<HHI", raw, 0)
                bits = struct.unpack_from("<H", raw, 14)[0]
                if tag == _WAVE_FORMAT_EXTENSIBLE and len(raw) >= 40:
                    tag = struct.unpack_from("<H", raw, 24)[0]
                fmt = (tag, channels, sr, bits)
            elif cid == b"data":
                data = (offset, size)
            f.seek(offset + size + (size & 1))  # chunks are word-aligned
    return (*fmt, *data)


def _decode(raw: bytes, fmt_tag: int, bits: int) -> np.ndarray:
    """Interleaved sample bytes -> float32 in [-1, 1]."""
    if fmt_tag == _WAVE_FORMAT_IEEE_FLOAT:
        return np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    if fmt_tag != _WAVE_FORMAT_PCM:
        raise ValueError(f"Unsupported WAV format tag: {fmt_tag}")
    if bits == 16:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if bits == 32:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    if bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        as_int = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        as_int = np.where(as_int & 0x800000, as_int - 0x1000000, as_int)
        return as_int.astype(np.float32) / 8388608.0
    if bits == 8:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    raise ValueError(f"Unsupported PCM bit depth: {bits}")


def wav_read(path: Union[str, Path], offset: float = 0.0,
             duration: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """Read a WAV file, or its [offset, offset + duration] slice, without
    decoding the rest. Returns ((channels, samples) float32, sample rate)."""
    fmt_tag, channels, sr, bits, data_offset, data_size = _read_header(path)
    frame = channels * (bits // 8)
    total = data_size // frame
    start = min(int(round(offset * sr)), total)
    n = total - start if duration is None else min(int(round(duration * sr)), total - start)
    with open(path, "rb") as f:
        f.seek(data_offset + start * frame)
        raw = f.read(n * frame)
    samples = _decode(raw, fmt_tag, bits)
    n_full = (len(samples) // channels) * channels
    return np.ascontiguousarray(samples[:n_full].reshape(-1, channels).T), sr


def wav_write(path: Union[str, Path], audio, sample_rate: int, subtype: str = "int16") -> None:
    """Write (channels, samples) or (samples,) audio as a WAV file.

    "int16": int16 samples are the exact payload (e.g. quantize_mix_wav's);
    floats are clipped to [-1, 1], scaled by 32767 and truncated.
    "float32": IEEE float samples.
    """
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    interleaved = np.ascontiguousarray(audio.T)
    if subtype == "int16":
        fmt_tag, bits = _WAVE_FORMAT_PCM, 16
        if interleaved.dtype == np.int16:
            payload = interleaved.astype("<i2", copy=False)
        else:
            payload = (np.clip(interleaved, -1.0, 1.0) * 32767.0).astype("<i2")
    elif subtype == "float32":
        fmt_tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        payload = np.asarray(interleaved, dtype="<f4")
    else:
        raise ValueError(f"Unsupported subtype: {subtype}")
    channels = audio.shape[0]
    with open(path, "wb") as f:
        data_size = payload.nbytes
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_size + (data_size & 1)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_tag, channels, sample_rate,
                            sample_rate * channels * bits // 8, channels * bits // 8, bits))
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        payload.tofile(f)
        if data_size & 1:
            f.write(b"\x00")


def get_duration(path: Union[str, Path]) -> float:
    """Duration of an audio file in seconds, without decoding it: a WAV's
    header, an MP3's frame scan (libmpg123), a FLAC's STREAMINFO."""
    suffix = _check_format(path)
    if suffix == ".mp3":
        from audiblelight_tpu_torch.io.codecs import mp3_duration

        return mp3_duration(path)
    if suffix == ".flac":
        from audiblelight_tpu_torch.io.codecs import flac_duration

        return flac_duration(path)
    _, channels, sr, bits, _, data_size = _read_header(path)
    return data_size / (channels * (bits // 8)) / sr


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis (scipy's kaiser-windowed filter)."""
    if orig_sr == target_sr:
        return audio
    g = gcd(int(orig_sr), int(target_sr))
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(audio.dtype)


def load_audio(path: Union[str, Path], sr: Optional[int] = None, mono: bool = True,
               offset: float = 0.0, duration: Optional[float] = None,
               dtype=np.float32) -> Tuple[np.ndarray, int]:
    """Load (a slice of) an audio file, mix to mono (mean of channels) and
    resample to `sr`. Returns (audio, sr): (samples,) mono, else (channels,
    samples). A WAV reads only its slice; MP3 and FLAC decode whole, then
    slice from round(offset * sr) for round(duration * sr) samples."""
    suffix = _check_format(path)
    if suffix in (".mp3", ".flac"):
        from audiblelight_tpu_torch.io.codecs import flac_read, mp3_read

        audio, file_sr = (mp3_read if suffix == ".mp3" else flac_read)(path)
        start = round(offset * file_sr)
        stop = None if duration is None else start + round(duration * file_sr)
        audio = audio[:, start:stop]
    else:
        audio, file_sr = wav_read(path, offset=offset, duration=duration)
    if mono:
        audio = np.mean(audio, axis=0)
    if sr is not None and sr != file_sr:
        audio = resample(audio, file_sr, int(sr))
        file_sr = int(sr)
    return audio.astype(dtype), file_sr


def valid_audio(audio: np.ndarray) -> bool:
    """Raise unless `audio` is a finite floating-point array of at least one dimension."""
    if not isinstance(audio, np.ndarray):
        raise TypeError(f"Audio data must be a numpy array, got {type(audio)}")
    if not np.issubdtype(audio.dtype, np.floating):
        raise TypeError(f"Audio data must be floating-point, got dtype {audio.dtype}")
    if audio.ndim == 0:
        raise ValueError("Audio data must be at least one-dimensional")
    if not np.isfinite(audio).all():
        raise ValueError("Audio buffer is not finite everywhere")
    return True
