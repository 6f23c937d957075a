"""The output check: a sample of the window's scenes, drawn from the seed,
held to the plain reference (`reference.<backend>`), which works each
scene out again from the benchmark's inputs.

The numbers compared come from the backend's reference: its
`numbers(program_int16, reference_int16) -> {name: value}` where it has
one, else the one number `payload_gap_lsb`, each scene's widest payload
gap (the largest difference, in int16 steps, between the program's WAV
samples and the reference's). Lower is better for each; over the sample
the worst counts. The configuration's `check` gives each number's limit
(and `sample`, the scenes drawn): a run is correct when it checked a scene
and every limited number is reported and at or under its limit.
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


def numbers_of(config: dict):
    """The backend's `numbers(program_int16, reference_int16)`."""
    from portbench.reference.audio import payload_gap

    ref = importlib.import_module(f"portbench.reference.{config['backend']}")
    return getattr(ref, "numbers", lambda program, reference: dict(payload_gap_lsb=payload_gap(program, reference)))


def compare(config: dict, specs: dict, clips: list, kept: list, device, lowp=None) -> dict:
    """{each number: its worst value over the sample, "checked": the scenes compared}."""
    refs = reference_payloads(config, specs, clips, kept, device, lowp)
    numbers = numbers_of(config)
    worst: dict = {}
    for (_, audio), r in zip(kept, refs):
        for name, value in numbers(payload_int16(audio), r).items():
            worst[name] = value if name not in worst else max(worst[name], value)
    return dict(worst, checked=len(refs))


def judge(limits: dict, numbers: dict) -> tuple:
    """(correct, {each limited number and "scenes_checked": {"value", "limit"}})
    of `compare`'s numbers against the configuration's `check` (whose
    `sample` is no limit). A limited number that was not reported reads
    None, and incorrect."""
    table = {name: dict(value=numbers.get(name), limit=limit) for name, limit in limits.items() if name != "sample"}
    table["scenes_checked"] = dict(value=numbers["checked"], limit=1)
    correct = numbers["checked"] >= 1 and all(c["value"] is not None and c["value"] <= c["limit"]
                                              for name, c in table.items() if name != "scenes_checked")
    return correct, table
