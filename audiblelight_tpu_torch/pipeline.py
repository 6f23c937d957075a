"""The fused scene render: a placed Scene -> int16 WAV payload on the card.

Counterpart of audiblelight_tpu/pipeline.py's FusedSceneRenderer and its
SELD dataset loop: trace the RIRs of every padded source, gather them per
event, render the stems, place them in the scene timeline, add the ambience
bed and quantise to int16. The reference compiles this into one XLA program;
here it runs eagerly, one kernel or PyTorch op after another, with the JAX
key replaced by a `torch.Generator` seeded from the world state's trace walk.

`render_scenes_pipelined` is the dataset loop, dispatch-ahead as the
reference's: one renderer per (room, rig, event buckets, source bucket) in a
module-wide LRU of 4, `fused_batch` scenes per batched render
(`FusedSceneRenderer.render_mix_batch`: one bounce loop for the batch), the
payloads pulled and written on a completion thread while the main thread
places and dispatches the next scenes. A scene the fused renderer refuses (a
shoebox or SOFA room, the exact rain mode in a nonconvex room, several
microphones, an ambience the card's bed does not draw, or
`device_mix=False`) takes the plan path instead, in order: the world state
computes its IR banks (`trace_irs_device`, or the shoebox's image sources),
`stems_from_plan` renders and quantises the stems on the device, and
`mix_plan_host` places them and adds the host ambience bed. `render_scene_audio_compiled` is that path for one scene
(`Scene.generate(compiled=True)`). The pooled driver behind the SELD CLI's
--placement-workers is `prep.render_prepped_scenes`. Every rank of a
`parallel.make_mesh` mesh renders its slice of a batch through
`render_mix_batch_sharded` / `render_batch_sharded`.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from audiblelight_tpu_torch import utils
from audiblelight_tpu_torch.geometry.mesh import TriMesh
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.render import (
    ScenePlan,
    _bucket,
    ambience_bed_device,
    build_scene_plan,
    mix_stems_host,
    place_stems_device,
    quantize_mix_wav,
    quantize_stems,
    render_event_stems_arrays,
)
from audiblelight_tpu_torch.rir.hrtf import HRTFSet
from audiblelight_tpu_torch.rir.sh import encoding_channels
from audiblelight_tpu_torch.worldstate.mesh_backend import LAYOUT_ENCODINGS, MeshDeviceState, rain_mode

# Tracer encoding of each rig layout this port renders
ENCODINGS = {"mic": "omni", **LAYOUT_ENCODINGS}


def fused_inputs_host(scene, buckets: tuple, bucket_sources: int):
    """Host half of `FusedSceneRenderer.scene_inputs`: ((trace seed, padded
    sources (S, 3), listener points, s_idx (es,), m_idx (em, j)) as numpy,
    the rain table's query points). Advances the world state's trace walk."""
    ws = scene.state
    mic = next(iter(ws.microphones.values()))
    src = ws._emitter_positions().astype(np.float32)
    n_src = len(src)
    if n_src > bucket_sources:
        raise ValueError(f"scene has {n_src} emitters; this renderer buckets {bucket_sources}")
    if n_src < bucket_sources:  # padding repeats the first (interior) source
        src = np.concatenate([src, np.tile(src[:1], (bucket_sources - n_src, 1))])

    caps_abs = np.atleast_2d(np.asarray(utils.coerce2d(mic.coordinates_absolute), np.float64))
    if mic.channel_layout_type == "mic":
        caps = caps_abs
    else:
        caps = np.atleast_2d(np.asarray(utils.coerce2d(mic.coordinates_center), np.float64))

    es, em, j, _ = buckets
    s_idx = np.full(es, -1, dtype=np.int64)
    m_idx = np.full((em, j), -1, dtype=np.int64)
    si = mi = counter = 0
    for event in scene.events.values():
        n_em = len(event)
        if event.is_moving:
            if mi < em:
                n_j = min(n_em, j)
                m_idx[mi, :n_j] = np.arange(counter, counter + n_j)
            mi += 1
        else:
            if si < es:
                s_idx[si] = counter
            si += 1
        counter += n_em

    # Rain-table query points: the mean of the physical capsules (shared
    # visibility), else every listener point
    mic_pts = caps_abs.mean(axis=0, keepdims=True) if bool(ws.cfg["shared_visibility"]) else caps
    return (ws.split_key(), src, caps.astype(np.float32), s_idx, m_idx), mic_pts


def mic_channel_spans(scene) -> list:
    """Per-mic (alias, start, end) spans into a plan's stacked channel axis,
    in microphone registration order."""
    spans, off = [], 0
    for alias, mic in scene.state.microphones.items():
        spans.append((alias, off, off + int(mic.n_channels)))
        off += int(mic.n_channels)
    return spans


def stems_from_plan(plan: ScenePlan):
    """One plan's stems on its device, quantised: (int16 stems (E, C, S),
    float32 per-stem scales (E,))."""
    stems = render_event_stems_arrays(
        plan.static_audio, plan.static_irs, plan.static_mask, plan.static_snr, plan.static_len,
        plan.static_place_len, plan.moving_audio, plan.moving_irs, plan.moving_w, plan.moving_mask,
        plan.moving_snr, plan.moving_len, plan.moving_place_len, plan.ref_db,
    )
    return quantize_stems(stems)


def mix_plan_host(plan: ScenePlan, q, scales) -> np.ndarray:
    """The (C, T) float32 scene mix on the host: the quantised stems placed
    at their offsets, plus the plan's host ambience bed."""
    starts = torch.cat([plan.static_start, plan.moving_start]).cpu().numpy()
    return mix_stems_host(q.cpu().numpy(), scales.cpu().numpy(), starts, plan.n_scene_samples,
                          ambience=plan.ambience)


def render_scene_audio_compiled(scene, plan: Optional[ScenePlan] = None,
                                plan_kwargs: Optional[dict] = None) -> "OrderedDict[str, np.ndarray]":
    """A Scene's per-mic (C, T) float32 audio through the plan path: traced
    IR banks, device stems, host mix with the host ambience bed."""
    if plan is None:
        plan = build_scene_plan(scene, plan_path=True, **(plan_kwargs or {}))
    mixed = mix_plan_host(plan, *stems_from_plan(plan))
    return OrderedDict((alias, mixed[a:b]) for alias, a, b in mic_channel_spans(scene))


# A host plan's fields that stay on the host
_HOST_FIELDS = ("ambience", "n_scene_samples")


def _plan_buckets(plan) -> tuple:
    """(es, em, j, S) of a ScenePlan or a host plan."""
    get = plan.get if isinstance(plan, dict) else plan.__getattribute__
    return (int(get("static_audio").shape[0]), int(get("moving_audio").shape[0]),
            int(get("moving_w").shape[2]), int(get("static_audio").shape[1]))


class FusedSceneRenderer:
    """Render whole scenes of one room, mic rig and bucket shape to WAV payloads.

    Arguments:
        state: the room's device state (mesh, materials, engine config).
        n_capsules: listener points of the rig (4 for an AmbeoVR, 1 for FOA).
        buckets: (es, em, j, S) padded static/moving event counts, trajectory
            points and event samples of the scene plans it renders.
        n_sources: padded source count of the trace.
        t_scene: scene length in samples.
        layout: the rig's channel layout: "mic" (one channel per capsule),
            "foa", "hoa2", "hoa3" (ambisonics at one point) or "binaural".
        hrtf: the measured HRTF set (`rir.hrtf.HRTFSet`) of a binaural rig
            with `hrtf_sofa`, passed to every trace; None for the analytic head.
    """

    def __init__(self, state: MeshDeviceState, n_capsules: int, buckets: tuple,
                 n_sources: int, t_scene: int, layout: str = "mic", hrtf=None):
        if not state.convex and rain_mode(state.cfg) != "face":
            raise ValueError(
                "the fused renderer on a nonconvex mesh needs per-face rain visibility "
                '(rain_visibility="face", or "auto" with mesh_simplification on)'
            )
        if layout not in ENCODINGS:
            raise ValueError(f"unknown channel layout {layout!r}")
        self.state = state
        self.device = state.device
        self.layout = layout
        self.encoding = ENCODINGS[layout]
        self.n_capsules = int(n_capsules)
        self.n_channels = encoding_channels(self.encoding, self.n_capsules)
        self.buckets = tuple(int(b) for b in buckets)
        self.n_sources = int(n_sources)
        self.t_scene = int(t_scene)
        self.hrtf = hrtf if self.encoding == "binaural" else None
        self._identity = None  # the template scene's, set by from_scene

    @classmethod
    def from_mesh(cls, mesh: TriMesh, cfg: dict, capsules, buckets: tuple, n_sources: int,
                  t_scene: int, material: Optional[str] = None, device=None) -> "FusedSceneRenderer":
        """A renderer for `mesh` under engine config `cfg`, for the microphone
        rig whose capsules are `capsules` (C, 3)."""
        state = MeshDeviceState.from_mesh(mesh, cfg, material=material, device=device)
        return cls(state, len(np.atleast_2d(capsules)), buckets, n_sources, t_scene)

    @staticmethod
    def _scene_identity(scene) -> tuple:
        """What a renderer bakes in besides the buckets: the room's device
        state (mesh, engine config, material, device), the rig (a binaural
        head's HRTF file too) and the scene's length."""
        ws = scene.state
        mic = next(iter(ws.microphones.values()))
        return (id(ws.device_state), mic.channel_layout_type, int(mic.n_capsules), int(mic.n_channels),
                str(getattr(mic, "hrtf_sofa", None)), int(round(float(scene.duration) * ws.sample_rate)))

    @classmethod
    def from_scene(cls, scene, plan: ScenePlan, bucket_sources: Optional[int] = None) -> "FusedSceneRenderer":
        """A renderer for scenes like `scene`: its room, rig, scene length and
        the plan's buckets; `bucket_sources` padded sources (default: the
        next power of two of the scene's emitters)."""
        ws = scene.state
        if len(ws.microphones) != 1 or not hasattr(ws, "device_state"):
            raise ValueError("the fused renderer needs a single-microphone RLR scene")
        mic = next(iter(ws.microphones.values()))
        bucket = _bucket(len(ws._emitter_positions())) if bucket_sources is None else int(bucket_sources)
        hrtf = None
        if mic.channel_layout_type == "binaural" and getattr(mic, "hrtf_sofa", None):
            hrtf = mic.load_hrtf(ws.sample_rate, ws.device)
        r = cls(ws.device_state, mic.n_listeners, _plan_buckets(plan), bucket,
                round(float(scene.duration) * ws.sample_rate), layout=mic.channel_layout_type, hrtf=hrtf)
        r._identity = cls._scene_identity(scene)
        return r

    def compatible(self, scene, plan: ScenePlan) -> bool:
        """Can `scene` render through this renderer? The same room state, rig
        and scene length as its template, the same buckets, and an event
        layout and source count within them."""
        ws = scene.state
        if len(ws.microphones) != 1 or not hasattr(ws, "device_state"):
            return False
        es, em, j, _ = self.buckets
        events = list(scene.events.values())
        n_static = sum(1 for e in events if not e.is_moving)
        n_moving = sum(1 for e in events if e.is_moving)
        max_j = max((len(e) for e in events if e.is_moving), default=0)
        return (
            n_static <= es and n_moving <= em and max_j <= j
            and _plan_buckets(plan) == self.buckets
            and len(ws._emitter_positions()) <= self.n_sources
            and self._scene_identity(scene) == self._identity
        )

    def scene_inputs(self, scene, device: bool = True) -> tuple:
        """Per-scene tracer inputs on the renderer's device: (generator,
        padded sources, listener points, rain table or None, s_idx, m_idx).
        Advances the world state's trace walk. `device=False` gives them as
        host arrays, the trace seed in place of the generator (the rain
        table is the state's cached one on its device): a batch stacks a
        group's inputs and uploads them in one copy."""
        (seed, src, caps, s_idx, m_idx), mic_pts = fused_inputs_host(scene, self.buckets, self.n_sources)
        dev = self.device
        face_occ = None if self.state.convex else self.state.rain_occlusion_for(mic_pts)
        if not device:
            return (seed, src, caps, face_occ, s_idx, m_idx)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return (gen, torch.as_tensor(src, device=dev), torch.as_tensor(caps, device=dev), face_occ,
                torch.as_tensor(s_idx, device=dev), torch.as_tensor(m_idx, device=dev))

    @staticmethod
    def mix_eligible(scene) -> bool:
        """Does the scene's ambience fit the device bed: at most one noise
        ambience with the rig's channel count?"""
        ambs = list(scene.ambience.values())
        if len(ambs) > 1:
            return False
        if ambs:
            mic = next(iter(scene.state.microphones.values()))
            return ambs[0].beta is not None and int(ambs[0].channels) == int(mic.n_channels)
        return True

    @staticmethod
    def mix_args(scene) -> tuple:
        """The ambience scalars (on, beta, ref_db) of the device bed:
        "gaussian" is white (beta 0)."""
        ambs = list(scene.ambience.values())
        if not ambs:
            return (0.0, 0.0, -65.0)
        amb = ambs[0]
        return (1.0, 0.0 if amb.beta == "gaussian" else float(amb.beta), float(amb.ref_db))

    def render_scene(self, scene, plan: ScenePlan) -> torch.Tensor:
        """One placed scene to its (C, T) int16 WAV payload on the card."""
        return self.render_mix(*self.scene_inputs(scene), plan, *self.mix_args(scene))

    def rain_table(self, capsules) -> Optional[torch.Tensor]:
        """The (1, F') per-face rain table toward the centroid of the listener
        points (the reference's shared visibility), or None in a convex room."""
        if self.state.convex:
            return None
        centroid = np.atleast_2d(np.asarray(capsules, dtype=np.float64)).mean(axis=0, keepdims=True)
        return self.state.rain_occlusion_for(centroid)

    def trace(self, gen: torch.Generator, sources: torch.Tensor, listeners: torch.Tensor,
              face_occ: Optional[torch.Tensor]) -> torch.Tensor:
        """(C_out, n_sources, L) RIRs of the padded sources at the listener.
        The reference's fused renderer passes the full mesh's tile layout
        where the mesh is not simplified; here `trace_rirs` passes K7's face
        tree of it (a nonconvex room's exact rain mode takes the plan path,
        whose trace passes it the same way)."""
        rain = dict(face_occlusion=None if self.state.convex else face_occ)
        return self.state.trace_rirs(gen, sources, listeners, self.encoding, rain, self.hrtf)

    def stems(self, gen, sources, listeners, face_occ, s_idx, m_idx, plan: ScenePlan) -> torch.Tensor:
        """(es + em, C_out, S) float stems: trace, per-event IR gather, render."""
        return self._event_stems(self.trace(gen, sources, listeners, face_occ), s_idx, m_idx, plan)

    def _event_stems(self, irs, s_idx, m_idx, plan: ScenePlan) -> torch.Tensor:
        """(es + em, C_out, S) float stems from a scene's (C, bucket, L) RIRs."""
        es, em, j, _ = self.buckets
        c, ir_len = irs.shape[0], irs.shape[-1]
        # -1 marks an empty slot (padded events, trajectory tails): a clamped
        # gather, then zeroed
        s_irs = irs[:, s_idx.clamp_min(0)] * (s_idx >= 0)[None, :, None]
        m_irs = irs[:, m_idx.clamp_min(0).reshape(-1)].reshape(c, em, j, ir_len)
        m_irs = m_irs * (m_idx >= 0)[None, :, :, None]
        return render_event_stems_arrays(
            plan.static_audio, s_irs.transpose(0, 1), plan.static_mask, plan.static_snr,
            plan.static_len, plan.static_place_len,
            plan.moving_audio, m_irs.transpose(0, 1), plan.moving_w, plan.moving_mask,
            plan.moving_snr, plan.moving_len, plan.moving_place_len, plan.ref_db,
        )

    def render_mix(self, gen: torch.Generator, sources, listeners, face_occ, s_idx, m_idx,
                   plan: ScenePlan, amb_on: float, amb_beta: float, amb_db: float) -> torch.Tensor:
        """One scene to its (C_out, T) int16 WAV payload on the renderer's device.

        Arguments:
            gen: the scene's generator (trace, noise carriers, ambience).
            sources: (n_sources, 3) padded source positions; listeners:
                (n_capsules, 3) listener points; face_occ: `rain_table(listeners)`.
            s_idx (es,), m_idx (em, j): event -> source maps, -1 = empty.
            plan: the scene's audio, weights, levels and start offsets.
            amb_on, amb_beta, amb_db: ambience on (1) or off (0), its
                power-law exponent (0 = white) and level.
        """
        if tuple(sources.shape) != (self.n_sources, 3):
            raise ValueError(f"sources must be ({self.n_sources}, 3), got {tuple(sources.shape)}")
        if tuple(listeners.shape) != (self.n_capsules, 3):
            raise ValueError(f"listeners must be ({self.n_capsules}, 3), got {tuple(listeners.shape)}")
        stems = self.stems(gen, sources, listeners, face_occ, s_idx, m_idx, plan)
        return self._payload(gen, stems, plan, amb_on, amb_beta, amb_db)

    def _payload(self, gen, stems, plan: ScenePlan, amb_on, amb_beta, amb_db) -> torch.Tensor:
        """A scene's stems placed, its ambience bed drawn from `gen` and
        added, quantised: (C_out, T) int16."""
        starts = torch.cat([plan.static_start, plan.moving_start])
        mix = place_stems_device(stems, starts, self.t_scene)
        if float(amb_on) != 0.0:
            bed = ambience_bed_device(gen, float(amb_beta), float(amb_db), self.n_channels,
                                      self.t_scene, device=self.device)
            mix = mix + float(amb_on) * bed
        return quantize_mix_wav(mix)

    def _batch(self, inputs: list, plans: list) -> tuple:
        """A group's inputs on the card: (generators, sources (B, S, 3),
        listeners (B, C, 3), rain tables (B, P, F') or None, s_idx, m_idx,
        ScenePlans). Every host array of the group (`scene_inputs(...,
        device=False)`, host plans from `build_scene_plan(..., device=False)`)
        goes up in one copy; tensors already on the card are stacked there."""
        if len(inputs) != len(plans) or not inputs:
            raise ValueError("one plan per scene required")
        seeds, src, caps, occ, s_idx, m_idx = zip(*inputs)
        host, put = [], []

        def later(x, dtype) -> int:
            """Queue a host array for the upload; returns its slot."""
            host.append(np.array(x, dtype=dtype, order="C"))
            return len(host) - 1

        slots = [later(np.stack(src), np.float32), later(np.stack(caps), np.float32),
                 later(np.stack(s_idx), np.int64), later(np.stack(m_idx), np.int64)]
        if self.state.convex:
            occ = None
        elif all(isinstance(o, np.ndarray) for o in occ):
            occ = later(np.stack(occ), bool)
        else:
            occ = torch.stack([torch.as_tensor(o, device=self.device) for o in occ])
        for plan in plans:  # a host plan's tensor fields as ScenePlan.from_numpy types them
            put.append(plan if isinstance(plan, ScenePlan) else {
                k: later(v, np.int64 if np.issubdtype(np.asarray(v).dtype, np.integer) else np.float32)
                for k, v in plan.items() if k not in _HOST_FIELDS})
        dev = upload(host, self.device)
        plans_d = [p if isinstance(p, ScenePlan) else
                   ScenePlan(**{k: dev[i] for k, i in p.items()}, **{k: plan[k] for k in _HOST_FIELDS})
                   for p, plan in zip(put, plans)]
        if isinstance(occ, int):
            occ = dev[occ]
        gens = [torch.Generator(device=self.device).manual_seed(int(seed)) for seed in seeds]
        src, caps, s_idx, m_idx = (dev[k] for k in slots)
        if tuple(src.shape[1:]) != (self.n_sources, 3) or tuple(caps.shape[1:]) != (self.n_capsules, 3):
            raise ValueError(f"sources must be (B, {self.n_sources}, 3) and listeners (B, {self.n_capsules}, 3), "
                             f"got {tuple(src.shape)} and {tuple(caps.shape)}")
        return gens, src, caps, occ, s_idx, m_idx, plans_d

    def _batch_stems(self, inputs: list, plans: list) -> tuple:
        """(generators, per-scene float stems, ScenePlans) of a group: one
        bounce loop for the group's traces, then each scene's stems."""
        gens, src, caps, occ, s_idx, m_idx, plans_d = self._batch(inputs, plans)
        irs = self.state.trace_rirs_batch(gens, src, caps, self.encoding, occ, self.hrtf)
        stems = [self._event_stems(irs[b], s_idx[b], m_idx[b], plans_d[b]) for b in range(len(irs))]
        return gens, stems, plans_d

    def render_mix_batch(self, inputs: list, plans: list, extras: list) -> torch.Tensor:
        """B scenes to their (B, C_out, T) int16 WAV payloads: the
        counterpart of the reference's vmapped render_mix_batch. `inputs`
        are each scene's `scene_inputs(scene, device=False)`, `plans` their
        ScenePlans or host plans (`build_scene_plan(..., device=False)`),
        `extras` their `mix_args`. The B traces run in one bounce loop
        (each kernel launched once per bounce for the batch, K3 and K4
        reading each scene's listener points); the stems, the placement,
        the ambience bed and the quantisation run scene by scene. Scene b's
        payload equals `render_mix` of that scene with the same seed."""
        if len(extras) != len(inputs):
            raise ValueError("one extras tuple per scene required")
        gens, stems, plans_d = self._batch_stems(inputs, plans)
        return torch.stack([self._payload(g, st, p, *e) for g, st, p, e in zip(gens, stems, plans_d, extras)])

    def render_batch(self, inputs: list, plans: list) -> tuple:
        """B scenes to their quantised stems: (int16 (B, E, C_out, S), float32
        scales (B, E)), the counterpart of the reference's render_batch (see
        `render_mix_batch` for the inputs)."""
        q, scales = zip(*(quantize_stems(st) for st in self._batch_stems(inputs, plans)[1]))
        return torch.stack(q), torch.stack(scales)

    @staticmethod
    def batch_shard(b: int, mesh, axis: str) -> slice:
        """This rank's contiguous slice of B scenes on the mesh's `axis`."""
        n_dev = int(mesh.shape[mesh.mesh_dim_names.index(axis)])
        if b % n_dev != 0:
            raise ValueError(f"batch size {b} must divide by mesh '{axis}' size {n_dev}")
        per = b // n_dev
        i = int(mesh.get_local_rank(axis))
        return slice(i * per, (i + 1) * per)

    def render_mix_batch_sharded(self, inputs: list, plans: list, extras: list, mesh,
                                 axis: str = "scene") -> torch.Tensor:
        """B scenes to int16 WAV payloads with the batch sharded over a
        `parallel.make_mesh` mesh: every rank passes the same B scenes and
        renders its contiguous slice of them on its own card through
        `render_mix_batch` (the reference's shard_map of the vmapped
        program). The geometry is each rank's own device state and no
        collective runs. Returns this rank's (B / n, C_out, T) shard, n the
        `axis` size, which B must divide."""
        if not (len(inputs) == len(plans) == len(extras)):
            raise ValueError("one plan + extras tuple per scene required")
        sl = self.batch_shard(len(inputs), mesh, axis)
        return self.render_mix_batch(inputs[sl], plans[sl], extras[sl])

    def render_batch_sharded(self, inputs: list, plans: list, mesh, axis: str = "scene") -> tuple:
        """B scenes' quantised stems with the batch sharded over the mesh (see
        `render_mix_batch_sharded`): this rank's (int16 (B / n, E, C_out, S),
        float32 scales (B / n, E)) shard of `render_batch`."""
        if len(inputs) != len(plans):
            raise ValueError("one plan per scene required")
        sl = self.batch_shard(len(inputs), mesh, axis)
        return self.render_batch(inputs[sl], plans[sl])


def renderer_from_numpy(world: dict, cfg: dict, plan: dict, scene_inputs: tuple,
                        t_scene: int, device=None, layout: str = "mic", hrtf=None):
    """Carry a world state and one scene's inputs, built elsewhere as numpy
    arrays, over to this package.

    Arguments:
        world: "tris" (F, 3, 3), "acoustic_tris" (F', 3, 3),
            "acoustic_normals" (F', 3), "absorption" (F', B),
            "scattering" (F',), "convex" (bool) and
            "diffraction_graph_tris" (F'', 3, 3) or None.
        cfg: engine config.
        plan: the ScenePlan fields (see render.ScenePlan).
        scene_inputs: (sources (n_sources, 3), capsules (C, 3), rain table
            (P, F') or None, s_idx (es,), m_idx (em, j)).
        t_scene: scene length in samples.
        layout: the rig's channel layout (see FusedSceneRenderer).
        hrtf: a binaural rig's measured set as host arrays (dirs (M, 3),
            hrirs (M, 2, N), sr), e.g. the JAX package's HRTFSet's, or None.

    Returns (renderer, (sources, listeners, face_occ, s_idx, m_idx, plan)) on
    `device`: pass a generator, these, and the ambience scalars to
    `renderer.render_mix`.
    """
    state = MeshDeviceState(
        world["tris"], world["acoustic_tris"], world["acoustic_normals"],
        world["absorption"], world["scattering"], convex=world["convex"],
        diffraction_graph_tris=world["diffraction_graph_tris"], cfg=cfg, device=device,
    )
    sources, capsules, rain, s_idx, m_idx = scene_inputs
    dev = state.device
    splan = ScenePlan.from_numpy(plan, dev)
    hrtf_set = None if hrtf is None else HRTFSet.from_numpy(*hrtf, device=dev)
    renderer = FusedSceneRenderer(
        state, len(capsules), (splan.static_audio.shape[0], splan.moving_audio.shape[0],
                               splan.moving_w.shape[2], splan.static_audio.shape[1]),
        len(sources), t_scene, layout=layout, hrtf=hrtf_set,
    )
    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)  # noqa: E731
    i64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)  # noqa: E731
    face_occ = None if rain is None else torch.as_tensor(np.array(rain, dtype=bool), device=dev)
    return renderer, (f32(sources), f32(capsules), face_occ, i64(s_idx), i64(m_idx), splan)


def upload(arrays: list, device) -> list:
    """Host arrays to `device` in one copy: packed, each on a 16-byte
    boundary, into one byte buffer (pinned where the device is a card), sent
    with one non-blocking copy and viewed back as tensors of their dtypes
    and shapes."""
    device = torch.device(device)
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // 16) * 16
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=device.type == "cuda")
    view = buf.numpy()
    for a, off in zip(arrays, offsets):
        view[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = buf.to(device, non_blocking=True)
    return [buf[off : off + a.nbytes].view(torch.from_numpy(np.empty(0, a.dtype)).dtype).reshape(a.shape)
            for a, off in zip(arrays, offsets)]


# The module-wide renderer LRU of render_scenes_pipelined: each renderer pins
# its room's device state (triangles, trees, rain tables), so the cache is
# bounded; it outlives a call on purpose, since dataset loops call the
# pipeline in chunks over the same rooms. Every scene re-passes
# `compatible` before it renders through a cached renderer.
_PIPELINE_RENDERERS: "OrderedDict" = OrderedDict()
MAX_RENDERERS = 4


def _event_counts(scene) -> dict:
    """The scene's (max_static, max_moving, max_traj) needs."""
    events = list(scene.events.values())
    return dict(max_static=sum(1 for e in events if not e.is_moving),
                max_moving=sum(1 for e in events if e.is_moving),
                max_traj=max((len(e) for e in events if e.is_moving), default=0))


def _renderer_for(scene, plan: ScenePlan) -> Optional[FusedSceneRenderer]:
    """The cached renderer for `scene` at its source bucket, built from it
    (and cached, evicting the least recently used) where none is; a cached
    one that no longer fits (the room's engine config or material changed)
    is replaced."""
    ws = scene.state
    mic = next(iter(ws.microphones.values()))
    n_sources = _bucket(len(ws._emitter_positions()))
    key = (id(ws.device_state), mic.channel_layout_type, int(mic.n_capsules), _plan_buckets(plan),
           int(ws.sample_rate), str(getattr(mic, "hrtf_sofa", None)), n_sources)
    renderer = _PIPELINE_RENDERERS.get(key)
    if renderer is not None:
        _PIPELINE_RENDERERS.move_to_end(key)
        if renderer.compatible(scene, plan):
            return renderer
    try:
        renderer = FusedSceneRenderer.from_scene(scene, plan, n_sources)
    except ValueError:
        return None
    _PIPELINE_RENDERERS[key] = renderer
    while len(_PIPELINE_RENDERERS) > MAX_RENDERERS:
        _PIPELINE_RENDERERS.popitem(last=False)
    return renderer


def render_scenes_pipelined(scene_factory: Iterable, complete: Callable, max_in_flight: int = 4,
                            plan_kwargs: Optional[dict] = None, fused_batch: int = 1, device_mix: bool = True) -> int:
    """The dispatch-ahead dataset loop: `complete(scene, {mic alias: (C, T)
    numpy audio})` gets every scene of `scene_factory` in order, an int16
    payload from the fused renderer or a float32 mix from the plan path.
    Returns the number of scenes completed.

    `scene_factory` yields placed Scenes (placement runs in the iterator, on
    the host). With `device_mix`, a scene whose ambience the card's bed
    draws, in a room the fused renderer takes (a convex room, or the
    per-face rain mode), renders through the cached renderer of its room,
    rig, buckets and source bucket: `fused_batch` consecutive scenes of one
    renderer go through `render_mix_batch` (one bounce loop for the batch);
    a group cut short by another renderer or a plan-path scene, and the
    trailing partial group, render scene by scene. Every other scene, every
    scene without `device_mix` (the reference's `fused=False` too), and a
    scene whose events overflow `plan_kwargs`' pinned buckets (max_static /
    max_moving / max_traj / pad_audio_seconds) render through the plan path
    (traced IR banks, device stems, host mix), its buckets auto-sized where
    the pinned ones would drop an event; so does a scene with several
    microphones, whose mix is split per microphone.

    The completion half (the pull of each payload, the plan path's host mix,
    `complete`) runs on one worker thread (`prep.CompletionThread`) while
    this thread places and dispatches the next scenes, up to `max_in_flight`
    items ahead; a payload's copy to the host is non-blocking into pinned
    memory (`prep.pull_async`), so dispatching never waits for it.
    """
    from audiblelight_tpu_torch.prep import CompletionThread, pull_async

    done = 0

    def _finish(item):
        nonlocal done
        kind, scenes, data = item
        if kind == "mix":
            wavs = data()
            for i, scene in enumerate(scenes):
                complete(scene, OrderedDict([(next(iter(scene.state.microphones)), wavs[i])]))
                done += 1
            return
        scene, plan, q, scales = scenes[0], *data
        mixed = mix_plan_host(plan, q, scales)
        complete(scene, OrderedDict((alias, mixed[a:b]) for alias, a, b in mic_channel_spans(scene)))
        done += 1

    def _render_group(renderer, group):
        if len(group) == fused_batch > 1:
            scenes = [s for s, _ in group]
            q = renderer.render_mix_batch([renderer.scene_inputs(s, device=False) for s in scenes],
                                          [p for _, p in group], [renderer.mix_args(s) for s in scenes])
            completion.put(("mix", scenes, pull_async(q)))
        else:
            for s, p in group:
                completion.put(("mix", [s], pull_async(renderer.render_scene(s, p)[None])))
        group.clear()

    group: list = []
    group_renderer = None
    with CompletionThread(_finish, max_in_flight) as completion:
        for scene in scene_factory:
            pk = dict(plan_kwargs or {})
            overflow = False
            for k, n in _event_counts(scene).items():
                if pk.get(k) is not None and n > pk[k]:
                    pk.pop(k)
                    overflow = True
            st = getattr(scene.state, "device_state", None)
            renderer = None
            if (device_mix and not overflow and st is not None and len(scene.state.microphones) == 1
                    and FusedSceneRenderer.mix_eligible(scene) and (st.convex or rain_mode(st.cfg) == "face")):
                plan = build_scene_plan(scene, **pk)
                renderer = _renderer_for(scene, plan)
            if renderer is None:  # the plan path, in order after the group
                _render_group(group_renderer, group)
                plan = build_scene_plan(scene, plan_path=True, **pk)
                completion.put(("plan", [scene], (plan, *stems_from_plan(plan))))
                continue
            if group and renderer is not group_renderer:
                _render_group(group_renderer, group)
            group_renderer = renderer
            group.append((scene, plan))
            if len(group) == fused_batch:
                _render_group(renderer, group)
        _render_group(group_renderer, group)
        completion.join()
    return done


def write_wav(path, payload: torch.Tensor, sample_rate: int) -> Path:
    """Write a (C, T) int16 payload from `render_mix` as a PCM WAV file."""
    path = Path(path)
    wav_write(path, payload.cpu().numpy(), int(sample_rate))
    return path
