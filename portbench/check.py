"""The output check: a sample of the window's scenes, drawn from the seed,
held to the plain reference (`reference.<backend>`), which works each
scene out again from the benchmark's inputs.

The number compared is each sampled scene's widest payload gap: the largest
difference, in int16 steps, between the program's WAV samples and the
reference's. Its limit is the configuration's `check.payload_gap_lsb`.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


class Sampler:
    """A reservoir sample of `size` completed scenes (Algorithm R), its draws
    from the run's seed: every completed scene is equally likely to be kept.
    A kept scene's payload is copied; the rest are not touched."""

    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.rng = np.random.default_rng([seed, 3])
        self.kept: list = []
        self.seen = 0

    def __call__(self, rec: dict, audio: np.ndarray) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((dict(rec), np.array(audio)))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.kept[j] = (dict(rec), np.array(audio))


def payload_int16(audio: np.ndarray) -> np.ndarray:
    """The int16 samples a WAV of `audio` holds: int16 as they are, floats
    clipped to [-1, 1], scaled by 32767 and truncated."""
    if audio.dtype == np.int16:
        return audio
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


def reference_payloads(config: dict, specs: dict, clips: list, kept: list, device, lowp=None) -> list:
    """The reference's payload of each kept scene, in order."""
    from portbench.reference import audio

    ref = importlib.import_module(f"portbench.reference.{config['backend']}")
    out = []
    for rec, _ in kept:
        spec = specs[rec["index"]]
        out.append(ref.render(config, spec, clips, spec["bed_seed"], device, lowp or audio.exact))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def compare(config: dict, specs: dict, clips: list, kept: list, device, lowp=None) -> dict:
    """{"payload_gap_lsb": the widest gap over the sample, "checked": count}."""
    from portbench.reference.audio import payload_gap

    refs = reference_payloads(config, specs, clips, kept, device, lowp)
    gaps = [payload_gap(payload_int16(audio), r) for (_, audio), r in zip(kept, refs)]
    return dict(payload_gap_lsb=max(gaps) if gaps else None, checked=len(gaps))
