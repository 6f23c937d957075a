"""Multiprocess scene preparation: the pooled SELD driver's host half.

Counterpart of audiblelight_tpu/prep.py. A dataset scene's host work
(placement rejection sampling on the host BVH, event audio loading, the
DCASE metadata and scene JSON, the packed fused-render inputs and the
per-face rain table) fans out over worker PROCESSES, so that a multi-core
host feeds the card at the card's rate; the main process keeps what touches
the card (the batched renders) and the file writes of bytes that are final.

Workers are `spawn`ed with the card hidden (`CUDA_VISIBLE_DEVICES=""`), so
none can open a CUDA context; they build their scenes with `device="cpu"`
and compute the rain table through K2's plain version. A scene crosses the
pipe as numpy and strings only (`PreppedScene`); Scene objects never pickle.
`workers=0` runs the builder inline, in the main process.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

__all__ = ["CompletionThread", "PreppedScene", "ScenePrepPool", "prep_scene", "pull_async",
           "render_prepped_scenes"]


@dataclass
class PreppedScene:
    """What the card and the writer need of one scene: numpy and strings
    only (picklable, no Scene, world state or tensor)."""

    index: int
    inputs: tuple  # (trace seed, sources (S, 3), listener points (C, 3), s_idx (es,), m_idx (em, j)) numpy
    mic_pts: np.ndarray  # the rain table's query points (1 or C, 3)
    plan: dict  # host plan: build_scene_plan(..., device=False)
    amb: tuple  # (on, beta, ref_db) of the device ambience bed
    n_scene_samples: int
    mic_alias: str
    csv_texts: dict  # {mic alias: DCASE CSV text}
    scene_json: str
    bucket_sources: int = 0  # padded source count the inputs were packed for
    # The worker's (P, F') per-face rain table (numpy bool), or None: the
    # main process computes it on the card where its shape does not match
    # the renderer's acoustic mesh
    face_occ: Optional[np.ndarray] = None


def prep_scene(scene, index: int, plan_kwargs: dict) -> PreppedScene:
    """Pack one placed Scene into its PreppedScene (host work; on a CPU
    world state the rain table runs K2's plain version). The traced sources
    are padded to their own next power of two, so that a run with varying
    event layouts groups into a few source buckets, one renderer each; the
    event buckets (es, em, j, S) are the plan's (`plan_kwargs` pins them)."""
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer, _plan_buckets, fused_inputs_host
    from audiblelight_tpu_torch.render import _bucket, build_scene_plan
    from audiblelight_tpu_torch.synthesize import dcase_csv_text, generate_dcase2024_metadata

    ws = scene.state
    bucket_sources = _bucket(len(ws._emitter_positions()))
    plan = build_scene_plan(scene, device=False, **plan_kwargs)
    inputs, mic_pts = fused_inputs_host(scene, _plan_buckets(plan), bucket_sources)
    # Deferred-context scenes fill the emitters' relative coordinates at
    # trace time; the metadata needs them now
    if hasattr(ws, "_update"):
        ws._update()
    face_occ = None
    st = getattr(ws, "device_state", None)
    if st is not None and not st.convex and ws._rain_mode() == "face":
        face_occ = st.rain_occlusion_for(mic_pts).cpu().numpy()
    return PreppedScene(
        index=index,
        inputs=inputs,
        mic_pts=mic_pts,
        plan=plan,
        amb=FusedSceneRenderer.mix_args(scene),
        n_scene_samples=int(plan["n_scene_samples"]),
        mic_alias=next(iter(ws.microphones)),
        csv_texts={alias: dcase_csv_text(rows) for alias, rows in generate_dcase2024_metadata(scene).items()},
        scene_json=json.dumps(scene.to_dict(), indent=4, ensure_ascii=False),
        bucket_sources=bucket_sources,
        face_occ=face_occ,
    )


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------

_WORKER_PREP = None


def _worker_init(builder_spec: str, builder_kwargs: dict) -> None:
    """Per-process initialiser: resolve "module:callable" and build the prep
    closure once (mesh load, BVH, folder scan: amortised over the worker's
    life)."""
    global _WORKER_PREP
    import importlib

    mod_name, fn_name = builder_spec.rsplit(":", 1)
    _WORKER_PREP = getattr(importlib.import_module(mod_name), fn_name)(**builder_kwargs)


def _worker_task(args):
    index, seed = args
    return _WORKER_PREP(index, seed)


# The workers' environment: no card, so no CUDA context
WORKER_ENV = {"CUDA_VISIBLE_DEVICES": ""}


def _worker_env(workers: int) -> dict:
    """WORKER_ENV, and the host's cores shared among the workers' torch threads."""
    return dict(WORKER_ENV, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // workers)))


class ScenePrepPool:
    """Ordered multiprocess map (index, seed) -> PreppedScene.

    builder_spec: "module:callable", called once per worker with
    **builder_kwargs; it returns `prep(index, seed) -> PreppedScene or None`.
    With workers=0 the builder runs in this process and no pool is made.
    """

    def __init__(self, builder_spec: str, builder_kwargs: dict, workers: int = 0):
        self.workers = int(workers)
        self._pool = None
        if self.workers <= 0:
            _worker_init(builder_spec, builder_kwargs)
            return
        import multiprocessing as mp

        env = _worker_env(self.workers)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:  # spawn: a fork would copy this process's CUDA state
            self._pool = mp.get_context("spawn").Pool(self.workers, initializer=_worker_init,
                                                      initargs=(builder_spec, builder_kwargs))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def imap(self, tasks) -> Iterator:
        """PreppedScenes (or None) in task order; tasks = iterable of (index, seed)."""
        if self._pool is None:
            for t in tasks:
                yield _worker_task(t)
            return
        # chunksize=1: a scene is coarse (~0.1-1 s), so latency matters more than pickling
        yield from self._pool.imap(_worker_task, tasks, chunksize=1)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Main process
# ---------------------------------------------------------------------------


def pull_async(x: torch.Tensor) -> Callable[[], np.ndarray]:
    """The counterpart of the reference's `copy_to_host_async`: a
    non-blocking copy of `x` into pinned host memory, recorded by its own
    CUDA event, so that the calling thread never synchronises. Returns a
    function that waits for that event alone and gives the numpy array."""
    if x.device.type != "cuda":
        return x.numpy
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(x.device))

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return wait


class CompletionThread:
    """The completion half of a dispatch-ahead loop: `finish(item)` runs on
    one worker thread for each item `put`, in order, while the caller goes
    on dispatching; at most `max_in_flight` items wait. An exception raised
    by `finish` is raised again on the caller's thread, at its next `put` or
    at `join`. Use it as a context manager: leaving it stops the thread."""

    def __init__(self, finish: Callable, max_in_flight: int):
        self._finish = finish
        self._errors: list = []
        self._work: queue.Queue = queue.Queue(maxsize=max_in_flight)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            try:
                self._finish(item)
            except Exception as exc:  # raised on the caller's thread
                self._errors.append(exc)
            finally:
                self._work.task_done()

    def _raise(self) -> None:
        if self._errors:
            raise self._errors[0]

    def put(self, item) -> None:
        self._work.put(item)
        self._raise()

    def join(self) -> None:
        """Wait until every item put is finished."""
        self._work.join()
        self._raise()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._work.put(None)
        self._thread.join()


def render_prepped_scenes(renderer_for: Callable, prepped_iter, complete: Callable, fused_batch: int = 4,
                          max_in_flight: int = 8, stats: Optional[dict] = None, mesh=None,
                          mesh_axis: str = "scene") -> int:
    """Render a stream of PreppedScenes (a `ScenePrepPool.imap`) through the
    fused renderer, `fused_batch` scenes a batch (`render_mix_batch`: one
    bounce loop for the batch), and call `complete(prepped, (C, T) int16)`
    in order on a completion thread (the writes; every byte is final).

    `renderer_for(bucket)` gives the FusedSceneRenderer of a source bucket;
    scenes group by their `bucket_sources`. A worker's rain table is used
    where its shape matches the renderer's acoustic mesh; otherwise the
    main process computes it on the card. Up to `max_in_flight` batches wait for
    the completion thread.

    With `mesh` (`parallel.make_mesh`; every rank of it runs this over the
    same stream), a group whose size the mesh's `mesh_axis` divides renders
    sharded (`render_mix_batch_sharded`): each rank renders, and completes,
    its own slice of the group. Any other group (a trailing partial one)
    renders whole on each rank, and each rank completes all of it.

    `stats` (optional) gets the host-clock decomposition, in place:
    prep_wait_s (the dispatch thread waiting for the pool), dispatch_s
    (inputs, upload and the render's launches), pull_s (the completion
    thread waiting for each batch's copy to the host), complete_s (writes),
    n_scenes. The stages overlap (three threads), so they do not add up to
    the wall time. Returns the number of scenes completed.
    """
    done = 0
    _stats = {"prep_wait_s": 0.0, "dispatch_s": 0.0, "pull_s": 0.0, "complete_s": 0.0, "n_scenes": 0}

    def _finish(item) -> None:
        nonlocal done
        group, wait = item
        t0 = time.perf_counter()
        wavs = wait()  # one pull for the group
        _stats["pull_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for prepped, wav in zip(group, wavs):
            complete(prepped, wav)
            done += 1
        _stats["complete_s"] += time.perf_counter() - t0

    def _emit(group: list, bucket: int) -> None:
        t0 = time.perf_counter()
        r = renderer_for(bucket)
        n_faces = int(r.state.acoustic_tris.shape[0])
        inputs = []
        for p in group:
            seed, src, caps, s_idx, m_idx = p.inputs
            if r.state.convex:
                occ = None
            elif p.face_occ is not None and p.face_occ.shape[-1] == n_faces:
                occ = p.face_occ  # the worker's table rides the group's one upload
            else:
                occ = r.state.rain_occlusion_for(p.mic_pts)
            inputs.append((seed, src, caps, occ, s_idx, m_idx))
        plans, extras = [p.plan for p in group], [p.amb for p in group]
        if mesh is not None and len(group) % int(mesh.shape[mesh.mesh_dim_names.index(mesh_axis)]) == 0:
            q = r.render_mix_batch_sharded(inputs, plans, extras, mesh, mesh_axis)
            group = group[r.batch_shard(len(group), mesh, mesh_axis)]
        else:
            q = r.render_mix_batch(inputs, plans, extras)
        wait = pull_async(q)
        _stats["dispatch_s"] += time.perf_counter() - t0
        completion.put((group, wait))

    group: list = []
    group_bucket = None
    try:
        with CompletionThread(_finish, max_in_flight) as completion:
            it = iter(prepped_iter)
            while True:
                t0 = time.perf_counter()
                prepped = next(it, None)
                _stats["prep_wait_s"] += time.perf_counter() - t0
                if prepped is None:
                    break
                _stats["n_scenes"] += 1
                if group and prepped.bucket_sources != group_bucket:
                    _emit(group, group_bucket)
                    group = []
                group_bucket = prepped.bucket_sources
                group.append(prepped)
                if len(group) == fused_batch:
                    _emit(group, group_bucket)
                    group = []
            if group:  # the trailing partial group
                _emit(group, group_bucket)
            completion.join()
    finally:
        if stats is not None:
            stats.update(_stats)
    return done
