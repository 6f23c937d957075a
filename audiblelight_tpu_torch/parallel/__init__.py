"""Multi-device rendering on torch.distributed: device meshes and sharded
scene batches.

Counterpart of audiblelight_tpu/parallel/__init__.py, with its names. There a
"device" of the mesh is a TPU chip inside one SPMD program; here it is one
rank of a `torch.distributed` process group: one process driving one card
(or, in the tests, one CPU process). Every rank runs the same Python with the
same arguments, renders its own slice of the batch and takes part in the
collectives, where the reference's shard_map inserts them. A rank never
drives more than its one card: the bounce loop reads the host once a bounce,
so one thread driving several cards would run them one after another.

`init_distributed` joins the group (NCCL between cards, gloo on the CPU),
`make_mesh` lays its ranks out as a ("scene", "chan") `DeviceMesh`. The
rendering functions take the same batch on every rank and return this
rank's shard of the reference's global result (`shard_render`,
`shard_trace_rirs`) or, where the reference returns a replicated array, the
whole of it (`shard_convolve_time`).

The collectives run on the tensors' own device. NCCL takes only CUDA tensors.
gloo takes CPU tensors, and CUDA tensors for all_reduce, all_gather and
broadcast, which it stages through pinned host memory (a copy to the host
before the exchange and one back after), so two gloo ranks can share one card
where NCCL refuses two ranks on a card.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from audiblelight_tpu_torch.render import ScenePlan, render_scene_arrays

_PLAN_FIELDS = [
    "static_audio",
    "static_irs",
    "static_mask",
    "static_snr",
    "static_start",
    "static_len",
    "static_place_len",
    "moving_audio",
    "moving_irs",
    "moving_w",
    "moving_mask",
    "moving_snr",
    "moving_start",
    "moving_len",
    "moving_place_len",
    "ambience",
    "ref_db",
]

# Seconds a rank waits for the others, at the rendezvous and in a collective,
# before the call fails
TIMEOUT_S = 300.0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    backend: Optional[str] = None,
    timeout: float = TIMEOUT_S,
) -> int:
    """Join the process group of a multi-process run (the reference's
    `jax.distributed.initialize`). Returns the world size.

    Arguments:
        coordinator_address: "host:port" of rank 0's rendezvous (tcp), or an
            init URL ("file:///path", "tcp://host:port"); None reads the
            launcher's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
            RANK: torchrun's `env://`).
        num_processes, process_id: the world size and this process's rank
            (None: from the environment).
        local_device_ids: the card this rank drives, `cuda:{ids[0]}`;
            without it `cuda:{rank % torch.cuda.device_count()}`.
        backend: "nccl" or "gloo"; None takes NCCL where a card is present,
            gloo otherwise. A gloo rank binds a card only where
            `local_device_ids` names one.
        timeout: seconds a rank waits for the others at the rendezvous and
            in a collective before its call fails, so that a rank that never
            arrives does not hang the rest.

    A call in a process whose group is up already does nothing.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    rank = int(os.environ.get("RANK", 0)) if process_id is None else int(process_id)
    if local_device_ids:
        card = int(local_device_ids[0])
    elif backend == "nccl":
        card = rank % torch.cuda.device_count()
    else:
        card = None
    if card is not None:  # before any other CUDA call of this process
        torch.cuda.set_device(card)
        torch.cuda.init()
    kw = dict(world_size=int(num_processes), rank=rank) if num_processes is not None else {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", card)
    dist.init_process_group(backend, init_method=init_method, timeout=datetime.timedelta(seconds=timeout), **kw)
    return dist.get_world_size()


def rank_device() -> torch.device:
    """The device this rank's collectives and renders run on: its card
    under NCCL, the CPU under gloo (where a gloo rank binds a card, pass
    tensors on it instead)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_scene: Optional[int] = None, n_chan: int = 1):
    """A ("scene", "chan") `DeviceMesh` of every rank of the group, scene-
    major; by default every rank on the "scene" axis. Every rank calls it.
    Raises where n_scene * n_chan is not the world size. (The reference's
    `devices` argument has no counterpart: a rank drives its own card.)"""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_scene is None:
        n_scene = world // n_chan
    if n_scene * n_chan != world:
        raise ValueError(f"a ({n_scene}, {n_chan}) mesh needs {n_scene * n_chan} ranks; the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_scene, n_chan), mesh_dim_names=("scene", "chan"))


def _axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def _flat_index(mesh) -> int:
    """This rank's index in the mesh flattened scene-major, as P(("scene",
    "chan")) orders the shards."""
    index = 0
    for i, axis in enumerate(mesh.mesh_dim_names):
        index = index * int(mesh.shape[i]) + int(mesh.get_local_rank(axis))
    return index


def pad_plans(plans: Sequence[ScenePlan]) -> list[ScenePlan]:
    """Zero-pad ragged ScenePlans to shared bucket shapes so they batch.

    Pads every raggable axis (static/moving event slots, event samples, IR
    length, trajectory points, STFT frames, scene samples) up to the batch
    maximum. The padding is exact: extra event slots carry mask 0 and length
    1 (as `build_scene_plan` fills them, so the level chain never divides by zero),
    extra audio, IR and weight samples are zeros, and a longer scene only
    appends silence (callers trim to each scene's own length). A plan without
    an ambience bed gets a silent one. Channel counts must match.
    """
    from audiblelight_tpu_torch.ops.stft import n_stft_frames

    c = plans[0].static_irs.shape[1]
    for p in plans[1:]:
        if p.static_irs.shape[1] != c:
            raise ValueError(
                f"Cannot batch plans with different channel counts "
                f"({p.static_irs.shape[1]} vs {c}); use equal mic configurations."
            )

    es = max(p.static_audio.shape[0] for p in plans)
    em = max(p.moving_audio.shape[0] for p in plans)
    s = max(max(p.static_audio.shape[1], p.moving_audio.shape[1]) for p in plans)
    l = max(max(p.static_irs.shape[2], p.moving_irs.shape[3]) for p in plans)  # noqa: E741
    j = max(p.moving_irs.shape[2] for p in plans)
    fr = n_stft_frames(s)
    t = max(p.n_scene_samples for p in plans)

    targets = dict(
        static_audio=(es, s), static_irs=(es, c, l), static_mask=(es,), static_snr=(es,), static_start=(es,),
        static_len=(es,), static_place_len=(es,),
        moving_audio=(em, s), moving_irs=(em, c, j, l), moving_w=(em, fr, j), moving_mask=(em,),
        moving_snr=(em,), moving_start=(em,), moving_len=(em,), moving_place_len=(em,),
        ambience=(c, t), ref_db=(),
    )
    pad_value = dict(static_len=1, moving_len=1)

    out = []
    for p in plans:
        kwargs = {}
        for f, tgt in targets.items():
            arr = getattr(p, f)
            if f == "ambience":
                arr = np.zeros((c, p.n_scene_samples), np.float32) if arr is None else arr
                if isinstance(arr, np.ndarray):
                    kwargs[f] = np.pad(arr, [(0, want - have) for have, want in zip(arr.shape, tgt)])
                    continue
            if tuple(arr.shape) == tgt:
                kwargs[f] = arr
                continue
            padded = torch.full(tgt, pad_value.get(f, 0), dtype=arr.dtype, device=arr.device)
            padded[tuple(slice(0, n) for n in arr.shape)] = arr
            kwargs[f] = padded
        kwargs["n_scene_samples"] = t
        out.append(ScenePlan(**kwargs))
    return out


def bucket_plans(plans: Sequence[ScenePlan], max_overhead: float = 0.3) -> list[list[int]]:
    """Group ragged plans into buckets with bounded padding.

    Within each bucket the padded volume exceeds the true volume by at most
    `max_overhead` (cost proxy: scene samples + event-slot samples, the two
    axes the stems and the mix scale with); channel counts partition the
    buckets outright. Returns the buckets as lists of indices into `plans`;
    feed each through stack_plans(pad=True) -> shard_render / render_batch.
    """

    def cost(p: ScenePlan) -> float:
        s = max(p.static_audio.shape[1], p.moving_audio.shape[1])
        slots = p.static_audio.shape[0] + p.moving_audio.shape[0]
        return float(p.n_scene_samples + slots * s)

    by_chan: dict[int, list[int]] = {}
    for i, p in enumerate(plans):
        by_chan.setdefault(int(p.static_irs.shape[1]), []).append(i)

    buckets: list[list[int]] = []
    for idxs in by_chan.values():
        idxs = sorted(idxs, key=lambda i: cost(plans[i]))
        cur: list[int] = []
        cur_sum = 0.0
        for i in idxs:
            c = cost(plans[i])
            if cur:
                # every member pads to the bucket max = c (sorted ascending)
                padded = c * (len(cur) + 1)
                if padded > (1.0 + max_overhead) * (cur_sum + c):
                    buckets.append(cur)
                    cur, cur_sum = [], 0.0
            cur.append(i)
            cur_sum += c
        if cur:
            buckets.append(cur)
    return buckets


def stack_plans(plans: Sequence[ScenePlan], pad: bool = False) -> dict:
    """Stack ScenePlans into batched tensors (leading scene axis) on the
    first plan's device; a missing ambience bed stacks as silence.

    With `pad=True`, ragged plans are first padded to shared bucket shapes via
    pad_plans; otherwise shapes must already match exactly.
    """
    if pad:
        plans = pad_plans(plans)

    def field(p, f):
        v = getattr(p, f)
        if f == "ambience" and v is None:
            return np.zeros((p.static_irs.shape[1], p.n_scene_samples), np.float32)
        return v

    shapes = {f: tuple(field(plans[0], f).shape) for f in _PLAN_FIELDS}
    for p in plans[1:]:
        for f in _PLAN_FIELDS:
            if tuple(field(p, f).shape) != shapes[f]:
                raise ValueError(
                    f"Plan field {f} has mismatched shape {tuple(field(p, f).shape)} vs {shapes[f]}; "
                    f"build plans with identical bucket sizes (or pass pad=True) to batch them."
                )
        if p.n_scene_samples != plans[0].n_scene_samples:
            raise ValueError(
                f"Plan n_scene_samples mismatch ({p.n_scene_samples} vs "
                f"{plans[0].n_scene_samples}); pass pad=True to batch ragged scenes."
            )
    device = plans[0].static_audio.device
    batched = {f: torch.stack([torch.as_tensor(field(p, f), device=device) for p in plans]) for f in _PLAN_FIELDS}
    batched["ambience"] = batched["ambience"].to(torch.float32)
    batched["n_scene_samples"] = plans[0].n_scene_samples
    return batched


def render_batch(batched: dict) -> torch.Tensor:
    """Render a stacked batch of plans: (B, C, T). Each scene renders on its
    own (`render.render_scene_arrays`), so its bits do not depend on the
    batch or the shard it rides in."""
    n_t = batched["n_scene_samples"]
    b = batched["static_audio"].shape[0]
    return torch.stack([render_scene_arrays(*(batched[f][i] for f in _PLAN_FIELDS), n_scene_samples=n_t)
                        for i in range(b)])


def shard_render(batched: dict, mesh, normalize: bool = False) -> torch.Tensor:
    """Render a batch with its scenes sharded over the whole mesh.

    Every rank passes the same batch; the rank whose index in the mesh
    flattened scene-major is r renders scenes [r B / W, (r + 1) B / W)
    through `render_batch` (W ranks in all), as P(("scene", "chan")) shards
    them. With `normalize=True` the whole batch is divided by its global
    peak: the local peaks' max over both mesh axes (`all_reduce` MAX over
    each axis's group, the reference's `pmax`).

    Returns this rank's (B / W, C, T) shard of the reference's (B, C, T).
    """
    n_t = batched["n_scene_samples"]
    total = 1
    for n in mesh.shape:
        total *= int(n)
    b = batched["static_audio"].shape[0]
    if b % total != 0:
        raise ValueError(f"Batch size {b} must be divisible by mesh size {total}")
    per = b // total
    r = _flat_index(mesh)
    local = {f: batched[f][r * per : (r + 1) * per] for f in _PLAN_FIELDS}
    local["n_scene_samples"] = n_t
    out = render_batch(local)
    if normalize:
        peak = out.abs().amax() if out.numel() else torch.zeros((), device=out.device)
        for axis in mesh.mesh_dim_names:
            dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
        out = out / torch.clamp_min(peak, 1e-9)
    return out


def shard_generator(seed_or_generator, index: int, device) -> torch.Generator:
    """The generator of shard `index`: seeded with the first 64-bit word of
    numpy's SeedSequence([seed, index]) (the counterpart of
    jax.random.fold_in(key, index)), where `seed` is the caller's int or its
    generator's `initial_seed()`. Deterministic for a fixed (seed, mesh)."""
    seed = (seed_or_generator.initial_seed() if isinstance(seed_or_generator, torch.Generator)
            else int(seed_or_generator))
    word = np.random.SeedSequence([seed % 2**64, int(index)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word) % 2**63)


def shard_trace_rirs(
    mesh,
    seed_or_generator,
    tris,
    face_absorption,
    face_scattering,
    source_positions,
    listener_pos,
    n_samples: int,
    **trace_kwargs,
) -> torch.Tensor:
    """RIR tracing with the SOURCE axis sharded over the mesh's "scene" axis.

    Each rank traces its contiguous slice of the E sources
    (`rir.raytracer.trace_rirs_multi`) against the full geometry, with no
    collective. Its generator is `shard_generator(seed_or_generator,
    scene index)`: the numpy SeedSequence of (seed, the rank's index on
    "scene"), the counterpart of the reference's fold_in of its axis index,
    so the result is deterministic for a fixed (seed, mesh) and each shard
    equals `trace_rirs_multi` of its slice with that generator. Ranks that
    share a "scene" index (a "chan" axis > 1) trace the same slice.

    source_positions: (E, 3) with E divisible by the "scene" axis size.
    Returns this rank's (C_out, E / n, n_samples) shard.
    """
    from audiblelight_tpu_torch.rir.raytracer import trace_rirs_multi

    n_shards = _axis_size(mesh, "scene")
    e = source_positions.shape[0]
    if e % n_shards != 0:
        raise ValueError(f"Source count {e} must be divisible by mesh 'scene' size {n_shards}")
    i = int(mesh.get_local_rank("scene"))
    per = e // n_shards
    gen = shard_generator(seed_or_generator, i, tris.device)
    return trace_rirs_multi(gen, tris, face_absorption, face_scattering, source_positions[i * per : (i + 1) * per],
                            listener_pos, n_samples=n_samples, **trace_kwargs)


def shard_convolve_time(audio: torch.Tensor, irs: torch.Tensor, mesh, axis: str = "scene") -> torch.Tensor:
    """Time-axis-sharded convolution, the reference's context-parallel analog.

    Every rank passes the whole dry signal; rank i of the axis's n convolves
    its span [i T / n, (i + 1) T / n) after receiving the (ir_len - 1)-sample
    halo of its left neighbour (an `all_gather` of every rank's last samples:
    gloo stages CUDA tensors through the host for it, and takes none for
    send / recv), keeps exactly its span of the full linear convolution, and
    the last rank's tail past T is shared by an `all_reduce` SUM of the
    tails masked to it (the reference's psum). The spans are gathered, so
    every rank returns the whole result, as the reference's replicated
    output.

    Arguments:
        audio: (n_samples,) dry signal; n_samples must divide by the axis size.
        irs: (n_channels, ir_len) IR bank applied to the whole signal.
        mesh: device mesh; `axis` names the mesh axis to shard time over.

    Returns:
        (n_channels, n_samples + ir_len - 1): full linear convolution, with the
        tail (ir_len - 1 samples past the last block) included.
    """
    from audiblelight_tpu_torch.ops.convolve import fft_convolve

    n = _axis_size(mesh, axis)
    t = audio.shape[-1]
    if t % n:
        raise ValueError(f"n_samples {t} must divide the '{axis}' axis size {n}")
    ir_len = irs.shape[-1]
    halo = ir_len - 1
    if t // n < halo:
        raise ValueError(
            f"time blocks of {t // n} samples are shorter than the "
            f"{halo}-sample halo; use fewer devices or longer audio"
        )
    group = mesh.get_group(axis)
    i = int(mesh.get_local_rank(axis))
    blk = t // n
    x = audio[i * blk : (i + 1) * blk].contiguous()
    left = x.new_zeros(halo)
    if halo:
        halos = [torch.empty_like(x[:halo]) for _ in range(n)]
        dist.all_gather(halos, x[blk - halo :].contiguous(), group=group)
        if i > 0:
            left = halos[i - 1]
    y = fft_convolve(torch.cat([left, x]), irs)  # (C, halo + blk + ir_len - 1)
    keep = y[:, halo : halo + blk].contiguous()
    tail = y[:, halo + blk :].contiguous() if i == n - 1 else torch.zeros_like(y[:, halo + blk :])
    dist.all_reduce(tail, op=dist.ReduceOp.SUM, group=group)
    spans = [torch.empty_like(keep) for _ in range(n)]
    dist.all_gather(spans, keep, group=group)
    return torch.cat(spans + [tail], dim=-1)


__all__ = ["init_distributed", "make_mesh", "pad_plans", "bucket_plans", "stack_plans", "render_batch",
           "shard_render", "shard_trace_rirs", "shard_convolve_time"]
