"""The system under test, driven as the SELD CLI drives it: scenes made
through the port's public Scene API from the benchmark's descriptions, and
rendered by the CLI's dispatch-ahead loop
(`pipeline.render_scenes_pipelined`) with the CLI's settings.

Everything here is the program's side; it hands the port only the
benchmark's inputs (clip files, room, positions, onsets, lengths, levels,
classes and seeds) and reads back what a dataset user gets: each scene's
audio, and its DCASE metadata written through the port's writers.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import struct
import time
from collections import deque
from pathlib import Path

import numpy as np

WAV_FLOAT = 3  # the WAV format tag of IEEE float samples


def write_clip(path: Path, audio: np.ndarray, sr: int) -> None:
    """A mono float32 WAV (IEEE float), read back sample for sample."""
    data = np.ascontiguousarray(audio, dtype="<f4").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, WAV_FLOAT, 1, sr, sr * 4, 4, 32))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def build_scene(config: dict, spec: dict, clip_paths: list):
    """One port Scene from its description, through the public API, as the
    SELD CLI's `build_scene` makes it (the backend's settings, the rig, each
    event with explicit position or trajectory, onset, length, SNR and
    class, the ambience)."""
    from audiblelight_tpu_torch.core import Scene

    backend = importlib.import_module(f"portbench.backends.{config['backend']}")
    scene = Scene(duration=spec["duration"], sample_rate=spec["sample_rate"], backend=config["backend"],
                  backend_kwargs=backend.backend_kwargs(config, spec), max_overlap=config["max_overlap"],
                  ref_db=spec["ref_db"], class_mapping=config["class_mapping"], device=config["device"])
    scene.add_microphone(microphone_type=config["rig"]["microphone_type"], position=spec["mic"]["position"])
    for ev in spec["events"]:
        common = dict(filepath=clip_paths[ev["clip"]], scene_start=ev["scene_start"], event_start=0.0,
                      duration=ev["duration"], snr=ev["snr"], class_id=ev["class_id"])
        if ev["moving"]:
            scene.add_event(event_type="predefined", trajectory=np.asarray(ev["trajectory"]), **common)
        else:
            scene.add_event(event_type="static", position=ev["position"], **common)
    scene.add_ambience(noise=config["ambience"])
    return scene


class Window:
    """The dispatch-ahead loop over new scenes: `warm` of them in set-up,
    then as many as `seconds` after the window's start allow, drained.

    Scene i is the traffic's i-th description; the first `len(ring)` were
    built in set-up, any later one is built when the loop asks for it. No
    scene is yielded twice, so no cache of the program is served a scene
    it has seen. Before each yield numpy's global stream is seeded from the
    description, as the CLI seeds each scene, so that the host bed it draws
    is fixed by the run's seed.

    A record per yield: (index, yield time, time the loop asked for the
    next scene, completion time, time inside `complete`)."""

    def __init__(self, config: dict, mix: dict, seed: int, clip_paths: list, ring: list, out_dir: Path, keep):
        self.config, self.mix, self.seed, self.clip_paths = config, mix, seed, clip_paths
        self.ring = ring  # [(spec, scene)] built in set-up
        self.specs: dict = {}
        self.records: list = []
        self._pending: deque = deque()
        self._next = 0
        self.keep = keep  # keep(record, audio): the output check's sampler
        self.slots = [(out_dir / f"slot{i}" / "audio", out_dir / f"slot{i}" / "meta") for i in range(2)]
        for audio_path, _ in self.slots:
            audio_path.parent.mkdir(parents=True, exist_ok=True)
        self.start = self.deadline = self.end = None
        self._done = 0

    def _scene(self, i: int):
        if i < len(self.ring):
            spec, scene = self.ring[i]
            self.ring[i] = None
            return spec, scene
        from portbench import traffic

        spec = traffic.scene(self.config, self.mix, self.seed, i)
        return spec, build_scene(self.config, spec, self.clip_paths)

    def factory(self, more):
        """New scenes for as long as `more()` holds before each."""
        while more():
            i = self._next
            self._next += 1
            t0 = time.perf_counter()
            spec, scene = self._scene(i)
            self.specs[i] = spec
            np.random.seed(spec["bed_seed"])
            rec = dict(index=i, t_yield=time.perf_counter(), build_s=time.perf_counter() - t0)
            self.records.append(rec)
            self._pending.append(rec)
            yield scene
            rec["t_next"] = time.perf_counter()

    def complete(self, scene, audio) -> None:
        """The CLI's writes: each microphone's WAV through the port's writer
        (to the null device: a window renders hundreds of 11.5 MB scenes),
        the metadata JSON and the DCASE CSV through the port's writers into
        a fixed pair of slots."""
        from audiblelight_tpu_torch.core import write_outputs
        from audiblelight_tpu_torch.io.audio import wav_write

        rec = self._pending.popleft()
        t0 = time.perf_counter()
        scene.audio = audio
        for mic_audio in audio.values():
            wav_write(os.devnull, mic_audio, int(scene.sample_rate), subtype="int16")
        self._done += 1
        audio_path, meta_path = self.slots[self._done % 2]
        write_outputs(scene, audio_path, meta_path, audio=False)
        t1 = time.perf_counter()
        rec["complete_s"] = t1 - t0
        rec["t_done"] = t1
        self.keep(rec, next(iter(audio.values())))

    def run(self, seconds: float, warm: int = 0, around=None) -> None:
        """`warm` scenes through the loop first (set-up), then the window,
        inside the context manager `around` (the profiler of a traced run)."""
        from audiblelight_tpu_torch.pipeline import render_scenes_pipelined

        p = self.config["pipeline"]
        kwargs = dict(max_in_flight=p["max_in_flight"], plan_kwargs=p["plan_kwargs"],
                      fused_batch=p["fused_batch"], device_mix=p["device_mix"])
        if warm:
            keep, self.keep = self.keep, (lambda rec, audio: None)
            render_scenes_pipelined(self.factory(lambda: self._next < warm), self.complete, **kwargs)
            self.keep = keep
            self.records.clear()
        with around if around is not None else contextlib.nullcontext():
            self.start = time.perf_counter()
            self.deadline = self.start + seconds
            render_scenes_pipelined(self.factory(lambda: time.perf_counter() < self.deadline), self.complete,
                                    **kwargs)
            self.end = time.perf_counter()

    def inside(self) -> list:
        """The records of the scenes completed before the window closed."""
        return [r for r in self.records if r.get("t_done", np.inf) <= self.deadline]
