"""WAV writing (counterpart of audiblelight_tpu/io/audio.py:wav_write, for
the int16 PCM payloads the render produces)."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

import numpy as np

_WAVE_FORMAT_PCM = 1


def wav_write(path: Union[str, Path], audio, sample_rate: int) -> None:
    """Write a (channels, samples) or (samples,) int16 array as a 16-bit PCM
    WAV file; the samples are the exact payload (e.g. quantize_mix_wav's)."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        raise TypeError(f"expected int16 samples, got {audio.dtype}")
    if audio.ndim == 1:
        audio = audio[None, :]
    payload = np.ascontiguousarray(audio.T).astype("<i2", copy=False)
    channels, bits = audio.shape[0], 16
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        data_size = payload.nbytes
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_size + (data_size & 1)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, _WAVE_FORMAT_PCM, channels, sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        payload.tofile(f)
        if data_size & 1:
            f.write(b"\x00")
