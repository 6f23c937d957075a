"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the tracer's CUDA kernels from audiblelight_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card at the flagship
shapes (K1 big and K1 small, the face-tree walks, bit for bit against the
dense walk and its own plain walk, visit counts included, with each face
tree's build time; K2 and K6, the any-hit tree walks, against their plain walk, visit
counts included, and the dense any-hit, boolean for boolean, on the rain
table, 640k random legs, the direct segments, the flagship trace's own
diffraction legs, 80k hit points toward the centroid and a capsule and the
exact CLI scene's bounces), then drives the port's two main paths:

- three 60 s flagship SELD scenes through the fused renderer (110,592-face
  scanned room, 4,071-face acoustic LOD, per-face rain visibility, order-10
  diffraction, 5,000 rays x 60 bounces with wavefront decimation, 16 padded
  sources, AmbeoVR, 24 kHz), written as int16 WAVs under smoke_out/, with
  their direct-path arrivals checked, timed and profiled, and K3 held
  against its plain version and itself (a second launch bit-identical),
  timed and set beside one `index_add_` of its plain fold on one trace's
  own bounces (first and last of each decimation phase);
- the port's SELD dataset CLI (`audiblelight_tpu_torch.seld.main`) in the
  same room, written as an OBJ, with the repo's WAVs as foreground audio:
  two scenes each in the MIC (AmbeoVR) and FOA formats at the flagship
  width, their WAVs, CSVs and JSONs checked; then one FOA scene traced
  again, K4 held against its plain version and itself on that trace's own
  bounces and timed as K3 is, its direct paths checked for arrival time and
  direction, and the FOA scene timed and profiled;
- the exact rain mode (the default engine config: the full 110,592-face
  mesh, one star any-hit query per bounce): one flagship-width scene
  through `Scene.generate(compiled=True)` (the plan path), one MIC scene of the CLI with
  `--no-mesh-simplification`, and K6 held against its plain version and the
  dense any-hit, and K3 as above, on that scene's own bounces;
- the HOA3 and binaural rigs: one flagship scene each through the fused
  renderer (the unfused deposit chain folded by K5), written as int16 WAVs
  of 16 and 2 channels, their direct paths checked for direction (HOA3)
  and for the Woodworth ITD and the ILD's sign (binaural), and K5 held
  against its plain version and timed beside `index_add_` on the HOA3
  trace's own bounces (first and last of each decimation phase);
- the tracer's two optional first-hit routes, each a per-ray walk of its
  own face tree in one launch (`csrc/first_hit_walk.cuh`): the first
  flagship scene with config.USE_MXU_FIRST_HIT (K8 on the acoustic LOD)
  beside the default scene of the same inputs (time, idle share and launches
  per bounce in turns), their IRs held to 5 % in per-channel energy and
  per-band T30, K8 held against its plain walk (visit counts included), its
  dense plain version and K1 on that trace's own bounces; and the exact-mode
  scene again with config.USE_TILED_FIRST_HIT (K7 on the full mesh's tree),
  its IRs held to 1 % and 2 % against the K1 scene's, K7 held against its
  plain walk, the dense classic Moller-Trumbore first hit and K1 on that
  trace's own bounces, 80k of its bounce rays and 80k interior rays; the
  trees' build times;
- K1 big on the full mesh against its plain versions on the exact scene's
  second and third bounces, 80k interior rays and the exact trace's
  wavefront with the most dead rays;
- the cone-sorted (K9, a per-ray walk of the sorted faces' tree in one
  launch) and pair-walk (K10, each ray's rounds of nearest tiles in one
  launch, a live tile tested by a walk of its own subtree) first hits,
  which neither package wires into its tracer, through their own entry
  points (`build_sorted_tiles`, `build_sorted_tree`, `sorted_first_hit`,
  `pair_first_hit`) on the exact scene's 80k surface rays and 80k interior
  rays on the full mesh, the fused trace's first bounce on the LOD, and the
  surface rays with 45 % of them dead: each kernel held against its plain
  walk (K9's visit counts and K10's per-ray rounds, tiles, box tests and
  leaves included), K10 against the reference-shaped rounds, each op
  against K1 big over the Morton-sorted faces, bit for bit, one launch per
  call, both timed beside K1 big on the same rays;
- the rlr main path in a room of <= 512 faces (the 432-face
  `scanned_like_room(subdivision_levels=1)`): one fused MIC scene at the
  flagship settings, where K1 small (the walk of the room's any-hit tree,
  staged in shared memory) takes every bounce, its launches counted, the
  scene timed and profiled, and K1 small held against its dense plain
  version (0 ulp) and its plain walk (visit counts included) on that
  trace's own bounces, timed beside the same walk reading the tree through
  L1 (K7's kernel on it).
- the Eigenmike em32 and em64 rigs (32 and 64 omni capsules): the first
  flagship scene through the fused renderer with each, written as 32- and
  64-channel int16 WAVs, launches counted as for the MIC scene, timed and
  profiled, K3 held against its plain version and itself on each trace's
  own bounces, and every (source, capsule) pair's direct arrival checked;
- the shoebox backend, the SELD CLI's default (no kernel: the image-source
  engine is plain PyTorch): the engine on the card against the same
  function on the CPU (within 1e-5 of peak), the direct paths of its
  order-12, 1 s IRs (omni, FOA direction, binaural ITD and ILD), the CLI at
  its defaults in MIC and FOA (two scenes each, checked as the rlr CLI's,
  the engine's time, peak device memory, terms and bound per scene, its
  device idle share, no tracer kernel launched) and one MonoCapsule scene
  through `Scene.generate(compiled=True)`;
- the port's HDF5 reader on the committed h5py-written fixtures
  (tests/resources/torch_sofa/: every dataset's sha256 and every
  attribute's value as digests.json recorded them, the unlimited datasets
  refused by name), then the SOFA backend through the SELD CLI (`--backend
  sofa --sofa`) on two measured rooms the size of converted TAU-SRIR rooms,
  written with the port's own HDF5 writer (MIC: 2,160 positions x 4
  capsules x 7,200 samples at 24 kHz; FOA: 720 x 4 x 14,400 at 48 kHz,
  resampled): two 60 s scenes each, outputs checked as the CLI's, every
  emitter on the measured grid with its IR's spike at d/c, each static
  event's DCASE rows at its grid point, the host time per scene split into
  the file's reads, get_irs, the render and the writes, peak device memory;
- measured HRTFs (a SimpleFreeFieldHRIR set of 1,250 directions x 200 taps
  at 44.1 kHz written with the port's `write_hrtf_sofa`): band powers and
  interpolation on the card against the CPU; the first flagship scene with
  `Binaural`'s measured set through the fused renderer (K5 folding the
  measured band powers, held against its plain version on the trace's own
  bounces; the direct paths at each ear's HRIR onset plus d/c), timed in
  turns with the analytic head and profiled, the per-bounce gather timed;
  the image-source engine with the set on the card against the CPU, and a
  60 s order-6 shoebox scene with `Binaural(hrtf_sofa=...)` through
  `Scene.generate(compiled=True)`, its engine's time, peak memory and bytes
  per term;
- the classic per-event render, `Scene.generate()`'s default: a scene at
  the first flagship scene's settings (the room, engine config and rig, 4
  static and 1 moving event) through `generate()` and
  `generate(compiled=True)` in turns on the same IR banks (WAVs within 5e-3
  of peak, every event's spatial audio not silent), its trace's launches
  counted, one event's dry stem at its direct path, the card's classic
  render against the CPU's on the same banks (1e-5 of peak); one rlr CLI
  scene with `--pipeline classic --channel-layout foa` (K4);
- the SSSEG dataset entry (`audiblelight_tpu_torch.ssseg`) at its defaults:
  two 10 s FOA scenes at 32 kHz with float32 dry stems, each stem's first
  arrival checked, the scene time split into engine, classic render and
  writes;
- the 27 event augmentations on a 5 s event on the card, the torch FX
  (biquads, compressor and limiter, time stretch, pitch shift) against
  themselves on the CPU and the host FX, timed beside the host versions;
  the shoebox CLI with `--augmentations` beside the same CLI without;
- the pooled SELD driver (`pooled_phase`): the host BVH (built, or the run
  fails; its booleans equal to the card's queries and its distances within
  1e-5 m on 10,000 points and 1,000 segments of the flagship room, timed
  per call beside them); `render_mix_batch` of 4 flagship scenes against
  `render_mix` of each (MIC, then FOA: within 1 LSB), K3 and K4 with a
  scene axis on the batched trace's own bounces against 4 one-scene
  launches (bit for bit) and their plain versions, the batch's launches per
  bounce beside one scene's, scene time per scene and idle share; the
  serial rlr CLI (4 MIC scenes) with its host time split by stage, one
  render each with the host BVH and without it, and in one batch of 4
  (`--fused-batch 4`, the CLI's default) with it, each in a process of its
  own (`--cli-breakdown`), the batch's files against the single renders'
  (CSVs byte-identical, JSONs byte-identical but for the creation time,
  WAVs within 1 LSB) and its launches read from its own run; and the pooled
  CLI, 8 MIC scenes with 1 worker in single renders and with 4 workers in
  batches of 4: the same file checks, throughput and the stats breakdown;
- multi-device rendering (`parallel_phase`; the host has one card): the
  pooled CLI as rank 0 of a world of one (`--coordinator`, NCCL), its files
  equal to the pooled 1-worker run's first scenes (0 LSB), its scene time
  beside that run's; `--mesh-devices 2` exits with the reference's message;
  a world of one NCCL rank in this process (`init_distributed` timed, the
  collectives per call, `shard_render` normalised against `render_batch`,
  `shard_render` and `render_mix_batch_sharded` timed in turns beside
  `render_batch` and `render_mix_batch`); two gloo ranks sharing the card
  (`--gloo-rank`, subprocesses): `shard_render`, `shard_convolve_time` and
  `shard_trace_rirs` against their unsharded runs, the collectives per call;
  and a 60 s scene with an AmbeoVR and a FOA listener in the small room
  through `render_scenes_pipelined` (the plan path), each microphone's
  direct path at d/c;
- real datasets' assets (`assets_phase`): whether libmpg123 and libmp3lame
  load (the repo's MP3 decoded where the first does); a 60 s stereo 48 kHz
  FLAC read back bit for bit and Rice-coded FLACs (fixed and LPC
  predictors), each decode timed beside the reference's per-field loop on
  the same file; the flagship room as a GLB (`Haymarket.glb`): its load,
  `repair` and `fix_winding` timed, a tenth of its faces flipped and mended;
  the rlr SELD CLI with `--assets 9A --scapes-per-room 1` at the flagship
  width (the GLB room: K1 big, K2, K3; 8 stand-in rooms: K1 small, K2, K3)
  through the pooled driver with 1 and 2 prep workers, its 27 files under
  the reference's names and equal between the runs (0 LSB), each scene's
  seconds; a plan-path MIC scene with a WAV bed (the bed equal to its host
  load, the mix before the first event the bed at its level); a fused
  scene with an 11-point predefined trajectory (its emitters the
  trajectory, K1 big 60 times, the trajectory's direct paths at d/c); an
  FOA CLI scene whose foreground holds a FLAC (and the MP3 where it
  decodes), each file an event; a flagship scene with transmission on and
  off timed in turns; a 24-face room divided by a wall at 5,000 rays x 60
  bounces (energy only with transmission on, under 0.2 of the open
  room's; tau = 0 equal to off bit for bit; K1 small, K2 and K3 once a
  bounce, each held to its plain version on that trace's first and last
  bounce);
- the last modules (`media_phase`): whether PIL imports and the H.264 shim
  builds; the stage timers (a synced stage's cost, the flagship MIC scene's
  peak device memory through `device_memory_stats`, one flagship
  `render_mix` in an `annotate` region under the trace capture, whose
  Chrome-trace file must name the region and K1, K2 and K3's kernels); a 60 s
  flagship MIC scene through `generate_acoustic_image` at the defaults (484
  pixels, 9 bands, 600 frames), the visibilities, batched eigh, APGD chain
  (CUDA events, idle share), labels and HDF write timed, the image held
  against the port's CPU solve of the same visibilities (1e-4 of peak), its
  HDF and JSON read back; the imaging CLI (two 10 s shoebox Eigenmike32
  scenes) and MUSIC DOA (8 azimuths) at their defaults; the flagship room's
  640 x 320 panorama from the microphone (one K1 big launch of 204,800 rays
  on the 110,592 faces, held against K1's plain versions bit for bit, timed
  with its bound) and, where PIL imports, a 10 s scene with an event image
  through `generate(compiled=True, video=True)` (MP4, AVI and GIF of 100
  frames, the MP4 decoded where the shim loads); `random_events`,
  `dcase_format` and `scene_timing`.

Each path's kernel launches are counted from zero just before it and read
just after; a kernel of the path that did not launch fails the run, and so
does a fused scene that launched K1 big (K1 small in the small room) other
than 60 times, any path
that launched another first-hit kernel than its own, a main path that built
an any-hit tree, or an exact scene that built more trees than it has
meshes. It
prints one JSON line of kernel results; the last line is
{"ok": true, "device": {...}}.

Exits non-zero without printing a result when no CUDA card is present or the
port's package is not beside this file.
"""

from __future__ import annotations

import csv
import json
import logging
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
OUT = REPO / "smoke_out"

SR = 24000
SCENE_SECONDS = 60.0
EVENT_SECONDS = 5.0
N_STATIC, N_TRAJ = 4, 11
BUCKETS = (4, 1, 16, int(EVENT_SECONDS * SR))  # (es, em, j, S) as bench.py pins them
N_SOURCES = 16
MIC_CENTRE = (3.5, 2.5, 1.5)
ENGINE = dict(
    sample_rate=SR, indirect_ray_count=5000, indirect_ray_depth=60, max_ir_length=1.0,
    mesh_simplification=True, rain_visibility="auto", ray_decimation=True,
    diffraction=True, max_diffraction_order=10,
)
REF_DB = -65.0
# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per (ray, face) pair, counted from the kernel bodies
FLOPS_BIG_PAIR = 38  # Pluecker-form first hit: 3 dots of 6, 2 of 3, 1 div, 3 mul, 1 add
FLOPS_MT_PAIR = 46  # Moller-Trumbore: 2 crosses, 4 dots, 3 subs, 1 div, 3 mul, 1 add
FLOPS_DEPOSIT = 33  # per (ray, capsule): geometry ~25, 4 band multiply-adds
FLOPS_DEPOSIT_FOA = 60  # per ray: geometry and gains ~28, 4 bands x 4 channels multiply-adds
FLOPS_MXU_PAIR = 38  # bilinear first hit: dots of 6, 6, 3 and 3 + 1 terms, 1 div, 3 mul, 1 add
BIN_DT = 0.002  # the IR checks' energy bins (s)
FLOPS_ISM_TERM = 30  # per image-source term: the int32 phase (7), the float phase (3), a sincos (~12), 8 more
ISM_ORDER = 12  # the SELD CLI's --ism-order
# The SELD CLI runs: the repo's WAVs of four DCASE2023 classes, the flagship
# width, 4 static and 1 moving event per scene, two scenes per format
CLI_CLASSES = {"femaleSpeech": 0, "maleSpeech": 1, "telephone": 3, "musicInstrument": 9}
CLI_FLAGS = ["--backend", "rlr", "--n-scenes", "2", "--duration", "60", "--rays", "5000",
             "--ray-depth", "60", "--ray-decimation", "--ir-seconds", "1.0",
             "--min-events-static", "4", "--max-events-static", "4",
             "--min-events-moving", "1", "--max-events-moving", "1", "--seed", "7"]
KERNELS = ("first_hit_big", "first_hit_small", "first_hit_tiled", "first_hit_mxu", "first_hit_sorted",
           "first_hit_pair", "star_any_hit", "any_hit", "deposit_histogram_foa", "deposit_histogram", "bin_histogram")
# The SELD CLI on its default backend (shoebox: order 12, 1.0 s IRs,
# absorption 0.3, the compiled plan path), two 60 s scenes per format
SHOEBOX_FLAGS = ["--n-scenes", "2", "--duration", "60", "--min-events-static", "4", "--max-events-static", "4",
                 "--min-events-moving", "1", "--max-events-moving", "1", "--seed", "7"]
# The SELD CLI on the SOFA backend: measured rooms written with the port's
# own writer, two 60 s scenes per file, 4 static and 1 moving event each. A
# SOFA room takes linear and semicircular paths only, and as in the
# reference script a moving event whose drawn shape is another is dropped:
# --seed 4 draws placeable shapes for both scenes
SOFA_FLAGS = ["--backend", "sofa", "--n-scenes", "2", "--duration", "60", "--min-events-static", "4",
              "--max-events-static", "4", "--min-events-moving", "1", "--max-events-moving", "1", "--seed", "4"]
SOFA_LISTENER = (2.5, 2.5, 1.5)  # the measured rooms' listener
# The measured HRIR set: CIPIC's 1,250 directions (50 azimuths x 25
# elevations), 200 taps at 44.1 kHz, each onset HRIR_DELAY samples in plus
# the analytic head's Woodworth offset
HRIR_SR, HRIR_TAPS, HRIR_DELAY = 44100, 200, 30.0
# examples/03_sofa_measured.py part 2 at full size: the shoebox scene with
# a measured head
HRTF_SHOEBOX = dict(dimensions=[5.0, 4.0, 3.0], max_order=6, max_ir_length=1.0, seed=1)
MIC_PATH = ("first_hit_big", "any_hit", "deposit_histogram")
FOA_PATH = ("first_hit_big", "any_hit", "deposit_histogram_foa")
EXACT_PATH = ("first_hit_big", "any_hit", "deposit_histogram", "star_any_hit")
RIG_PATH = ("first_hit_big", "any_hit", "bin_histogram")
MXU_PATH = ("first_hit_mxu", "any_hit", "deposit_histogram")
TILED_PATH = ("first_hit_tiled", "any_hit", "deposit_histogram", "star_any_hit")
SMALL_PATH = ("first_hit_small", "any_hit", "deposit_histogram")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warm: bool = True) -> float:
    """Median milliseconds of `fn()` on the card, by CUDA events, after a
    warm-up call unless `warm` is False (the caller has just run it)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 20, tries: int = 4) -> float:
    """Device time per call of the kernels `fn` launches, from the profiler
    over `reps` calls after a warm-up: `time_ms` without the host's time
    before each launch. The profiler now and then records none of a
    session's kernels; such a session is run again, up to `tries` in all,
    and nan (printed "nan": not measured) is returned if every one came
    back empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
                    for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
        if total > 0:
            return total / reps / 1e3
    return float("nan")


def elapsed(t_start: float, label: str) -> None:
    print(f"[{time.time() - t_start:.1f} s] {label}", flush=True)


def is_kernel(key: str, name: str) -> bool:
    """Is the profiler's event `key` ("(anonymous namespace)::any_hit_kernel(
    float const*, ...)", or its mangled form) the kernel `name`? Not a
    longer name that ends in it: "any_hit" is not "star_any_hit"."""
    return re.search(rf"(^|[^A-Za-z_]){name}_kernel", key) is not None


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(least time in ms, what bounds it) for `flops` fp32 operations and `nbytes` moved."""
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(torch.int64)).abs()


def face_boxes(tris: torch.Tensor, slop: float = 0.0) -> tuple:
    """(lo, hi) (F, 3) of each face's box: its triangle's, or with `slop` the
    box of the triangle A + s e1 + t e2, s, t >= -slop, s + t <= 1 + slop,
    which holds the region K8's window accepts (a slightly larger one)."""
    a, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    corners = ((-slop, -slop), (1 + 2 * slop, -slop), (-slop, 1 + 2 * slop))
    pts = torch.stack([a + s * e1 + t * e2 for s, t in corners], dim=1) if slop else tris
    return pts.amin(1), pts.amax(1)


def segment_enters(o, inv, t_end, lo, hi) -> torch.Tensor:
    """Does the segment o + s d, 0 <= s <= t_end, enter the box [lo, hi]?
    (slab test; `inv` = 1 / d; shapes broadcast, the last axis is x, y, z)"""
    ta, tb = (lo - o) * inv, (hi - o) * inv
    t_in = torch.clamp_min(torch.minimum(ta, tb).amax(-1), 0.0)
    return (t_in <= torch.maximum(ta, tb).amin(-1)) & (t_in <= t_end)


BOX_PAD = 1e-5  # m, on face boxes and t_hit, so that rounding drops no face


def first_hit_pairs(o, d, t_hit, face, boxes: tuple, order=None, group: int = 256, pad: float = BOX_PAD) -> tuple:
    """(pairs, in_groups): the (ray, face) pairs a first hit needs on this
    data. A ray needs each face whose box (`boxes`, from face_boxes, padded
    by `pad`) its segment [0, t_hit] enters: a face whose box the segment
    misses cannot be its hit. A ray's own hit `face` is counted even where
    rounding left it out, and those rays are printed. Two levels: the faces
    in groups of `group` in `order` ((G * group,) face indices, -1 for none;
    by default sorted by an 8^3 grid of box centres), each group's box tested
    first; `in_groups` counts every face of the groups entered. The count is
    exact whatever the grouping."""
    lo, hi = boxes
    if order is None:
        c = 0.5 * (lo + hi)
        cell = ((c - c.amin(0)) / (c.amax(0) - c.amin(0)).clamp_min(1e-9) * 7.999).long()
        order = torch.argsort(cell[:, 0] * 64 + cell[:, 1] * 8 + cell[:, 2])
        order = torch.nn.functional.pad(order, (0, -order.numel() % group), value=-1)
    order = order.long()
    real = (order >= 0).view(-1, group)
    safe = order.clamp_min(0)
    f_lo, f_hi = (lo[safe] - pad).view(-1, group, 3), (hi[safe] + pad).view(-1, group, 3)
    g_lo = torch.where(real[..., None], f_lo, float("inf")).amin(1)
    g_hi = torch.where(real[..., None], f_hi, float("-inf")).amax(1)
    inv = 1.0 / torch.where(d.abs() < 1e-30, 1e-30, d)
    t_end = t_hit + pad
    own = face.clamp_min(0).long()
    left_out = (face >= 0) & ~segment_enters(o, inv, t_end, lo[own] - pad, hi[own] + pad)
    if bool(left_out.any()):
        print(f"  {int(left_out.sum())} rays' own hit faces lie outside their padded boxes; counted all the same")
    pairs, in_groups = int(left_out.sum()), 0
    for r0 in range(0, o.shape[0], 4096):
        sl = slice(r0, r0 + 4096)
        ent = segment_enters(o[sl, None], inv[sl, None], t_end[sl, None], g_lo[None], g_hi[None])  # (rays, G)
        in_groups += int((ent * real.sum(1)[None]).sum())
        ray, grp = torch.nonzero(ent, as_tuple=True)
        ray = ray + r0
        for p0 in range(0, ray.numel(), 16384):
            rr, gg = ray[p0 : p0 + 16384], grp[p0 : p0 + 16384]
            hit = segment_enters(o[rr, None], inv[rr, None], t_end[rr, None], f_lo[gg], f_hi[gg]) & real[gg]
            pairs += int(hit.sum())
    return pairs, in_groups


def any_hit_pairs(o, d, length, blocked, tris) -> int:
    """(segment, face) pairs an any-hit needs on this data, by one rule for
    K2 and K6 and any implementation: a blocked segment its one blocking
    face; a free one each face whose unpadded box its segment [0, length]
    enters (a face whose box the segment misses cannot block it); a segment
    whose window 1e-4 < t < length - 1e-4 is empty, none."""
    free = ~blocked & (length - 1e-4 > 1e-4)
    none = torch.full((int(free.sum()),), -1, dtype=torch.int32, device=o.device)
    pairs, _ = first_hit_pairs(o[free], d[free], length[free], none, face_boxes(tris), pad=0.0)
    return pairs + int(blocked.sum())


def check_cli_outputs(out: Path, layout: str, t_scene: int, n_scenes: int = 2) -> None:
    """The CLI's DCASE layout for `n_scenes` train scenes: a 4-channel 24 kHz
    int16 WAV each, not silent; a CSV each with frames in 0-600 and the four
    classes' ids; a JSON each."""
    from audiblelight_tpu_torch.io.audio import _read_header, wav_read

    stems = [f"dev-train-alight/fold1_scene1_{i:03d}" for i in range(n_scenes)]
    want = sorted([f"{layout}_dev/{s}_mic000.wav" for s in stems] + [f"metadata_dev/{s}.json" for s in stems]
                  + [f"metadata_dev/{s}_mic000.csv" for s in stems])
    got = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    if got != want:
        fail(f"{layout} CLI wrote {got}, expected {want}")
    for s in stems:
        wav = out / f"{layout}_dev/{s}_mic000.wav"
        fmt_tag, channels, sr, bits, _, _ = _read_header(wav)
        data, _ = wav_read(wav)
        peak = float(np.abs(data).max())
        rows = [[int(v) for v in row] for row in csv.reader((out / f"metadata_dev/{s}_mic000.csv").open())]
        json.loads((out / f"metadata_dev/{s}.json").read_text())
        frames = [r[0] for r in rows]
        print(f"{layout} {s}: WAV {channels} x {data.shape[1]} at {sr} Hz, {bits}-bit PCM, peak "
              f"{peak * 32768:.0f}; CSV {len(rows)} rows, frames {min(frames)}-{max(frames)}, classes "
              f"{sorted({r[1] for r in rows})}")
        if (fmt_tag, channels, sr, bits, data.shape[1]) != (1, 4, SR, 16, t_scene) or peak * 32768 < 100:
            fail(f"{wav}: not a 4-channel {SR} Hz int16 WAV of {t_scene} frames with sound")
        if not rows or any(len(r) != 6 or not 0 <= r[0] <= 600 or r[1] not in CLI_CLASSES.values() for r in rows):
            fail(f"{s}: bad DCASE CSV")


def t30(energy: np.ndarray) -> float:
    """T30 (s) of a BIN_DT bin-energy decay from its Schroeder integral: the
    -5 to -35 dB slope, extrapolated to 60 dB (nan when it never falls 35 dB)."""
    sch = np.cumsum(energy[::-1])[::-1]
    db = 10 * np.log10(np.maximum(sch / sch[0], 1e-30))
    sel = (db <= -5) & (db >= -35)
    if sel.sum() < 2 or db.min() > -35:
        return float("nan")
    return float(-60.0 / np.polyfit(np.arange(len(db))[sel] * BIN_DT, db[sel], 1)[0])


def band_energy(irs: torch.Tensor) -> np.ndarray:
    """(4 bands, E, bins) energy of IRs (C, E, L) in BIN_DT bins, summed over
    channels; each band cut from the spectrum by the square roots of the
    tracer's log-frequency band weights (they sum to 1 in energy)."""
    from audiblelight_tpu_torch.rir.raytracer import _band_centers, _log_band_weights

    _, e, n = irs.shape
    spec = torch.fft.rfft(irs.double(), dim=-1)
    freqs = torch.arange(spec.shape[-1], device=irs.device, dtype=torch.float32) * (SR / n)
    w = torch.sqrt(_log_band_weights(freqs, _band_centers(4, irs.device))).double()
    energy = (torch.fft.irfft(spec[None] * w[:, None, None], n=n, dim=-1) ** 2).sum(1)  # (B, E, n)
    hop = int(round(BIN_DT * SR))
    k = n // hop
    return energy[..., : k * hop].reshape(4, e, k, hop).sum(-1).cpu().numpy()


def compare_irs(label: str, got: torch.Tensor, want: torch.Tensor, e_tol: float, t_tol: float) -> None:
    """Hold IRs `got` (C, E, L) to `want`: per-channel energy (over sources
    and time) within e_tol, per-band T30 of the sources' IRs pooled within
    t_tol; the per-source T30 spread and the max |difference| over the peak
    printed."""
    e_got, e_want = (got.double() ** 2).sum((1, 2)), (want.double() ** 2).sum((1, 2))
    e_rel = float(((e_got / e_want) - 1).abs().max())
    b_got, b_want = band_energy(got), band_energy(want)
    t_got = [t30(b_got[b].sum(0)) for b in range(4)]
    t_want = [t30(b_want[b].sum(0)) for b in range(4)]
    t_rel = max(abs(g / w - 1) for g, w in zip(t_got, t_want))
    per_src = [abs(t30(b_got[b, e]) / t30(b_want[b, e]) - 1) for b in range(4) for e in range(got.shape[1])]
    diff = float((got - want).abs().max() / want.abs().max())
    print(f"{label}: per-channel energy within {e_rel:.4%}; per-band T30 (s) {[round(x, 4) for x in t_got]} "
          f"against {[round(x, 4) for x in t_want]}, within {t_rel:.4%}; per (band, source) T30 within "
          f"{np.nanmax(per_src):.4%}; max |difference| / peak {diff:.4e}", flush=True)
    if not (e_rel <= e_tol and t_rel <= t_tol):
        fail(f"{label}: energy {e_rel:.4%} (limit {e_tol:.0%}) or T30 {t_rel:.4%} (limit {t_tol:.0%})")


def keep_first_last(kept: dict, key: int, item) -> None:
    """Keep `item` as the first or, replacing the last, the latest under `key`."""
    items = kept.setdefault(key, [])
    items[min(len(items), 1):] = [item]


def check_binaural(irs: torch.Tensor, direct: torch.Tensor, src: np.ndarray, free: np.ndarray, win: int,
                   centre=MIC_CENTRE, label: str = "binaural", delay0: float = 0.0) -> None:
    """The binaural rig's direct paths against the Woodworth head at
    `centre`, for each unoccluded source: on the IRs `irs` (2, E, L), the
    near ear peaks within 2 samples of d/c plus its Woodworth offset (plus
    `delay0` samples: a measured set's HRIR onset); on
    their direct component `direct` (2, E, L), both ears do, and the near
    ear is the louder for a source clearly to one side. Where the IRs'
    far-ear peak is off its arrival, or their ILD over the direct windows
    has the wrong sign, the rest of the IR (tail, reflections and
    diffraction, `irs - direct`) must outweigh the shadowed direct path
    there."""
    from audiblelight_tpu_torch.rir.sh import woodworth_itd

    irs, direct = irs.cpu().numpy(), direct.cpu().numpy()
    rest = irs - direct
    near_off, direct_off, far_off, ild_wrong, ild_wrong_direct, unexplained = [], [], [], [], 0, []
    for e in np.flatnonzero(free):
        vec = src[e] - np.array(centre)
        dist_e = np.linalg.norm(vec)
        u = torch.as_tensor(vec / dist_e, dtype=torch.float32)[None]
        ear_s = dist_e / 343.0 * SR + woodworth_itd(u).numpy()[0] * SR + delay0  # (2,) per-ear arrivals
        near = int(np.argmin(ear_s))
        lo = [max(int(ear_s[k]) - win, 0) for k in range(2)]
        peak_t = [lo[k] + int(np.argmax(np.abs(irs[k, e, lo[k] : int(ear_s[k]) + win]))) for k in range(2)]
        peak_d = [lo[k] + int(np.argmax(np.abs(direct[k, e, lo[k] : int(ear_s[k]) + win]))) for k in range(2)]
        near_off.append(abs(peak_t[near] - ear_s[near]))
        direct_off.append(max(abs(peak_d[k] - ear_s[k]) for k in range(2)))
        far = 1 - near
        if abs(peak_t[far] - ear_s[far]) > 2.0:
            ratio = abs(rest[far, e, peak_t[far]]) / max(abs(direct[far, e, peak_t[far]]), 1e-30)
            far_off.append(f"source {e}: {peak_t[far] - ear_s[far]:+.2f} samples, |rest / direct| there {ratio:.3g}")
            if ratio <= 1.0:
                unexplained.append(f"source {e}: far-ear peak {peak_t[far] - ear_s[far]:+.2f} samples off")
        if abs(float(u[0, 1])) <= 0.2:  # not clearly to one side
            continue

        def energy(x, k):
            a = max(int(round(ear_s[k])) - 24, 0)
            return float(np.sum(x[k, e, a : a + 48] ** 2))

        side = np.sign(float(u[0, 1]))  # ear 0 (left, +y) is near for side > 0
        ild_wrong_direct += np.sign(energy(direct, 0) - energy(direct, 1)) != side
        if np.sign(energy(irs, 0) - energy(irs, 1)) != side:
            ild_wrong.append(int(e))
            k_far = 1 if side > 0 else 0
            if energy(rest, k_far) <= energy(direct, k_far):
                unexplained.append(f"source {e}: traced ILD sign wrong")
    n_lat = sum(abs(src[e][1] - centre[1]) / np.linalg.norm(src[e] - np.array(centre)) > 0.2
                for e in np.flatnonzero(free))
    print(f"{label} direct paths: {len(near_off)} of {len(src)} sources unoccluded; traced IRs: max |near-ear "
          f"peak - (d/c + Woodworth ITD + {delay0:.3f})| {max(near_off, default=float('nan')):.2f} samples, far-ear "
          f"peak more than 2 "
          f"samples off: {far_off}, ILD sign over the direct windows wrong for {len(ild_wrong)} of "
          f"{n_lat} lateral sources {ild_wrong}, each held by the tail and diffraction outweighing the shadowed "
          f"direct path: {not unexplained}; direct component: max |ear peak - (d/c + Woodworth ITD)| "
          f"{max(direct_off, default=float('nan')):.2f} samples, ILD sign wrong for {ild_wrong_direct} of {n_lat}")
    if not near_off or max(near_off) > 2.0 or max(direct_off) > 2.0 or ild_wrong_direct or unexplained:
        fail(f"{label} direct paths off the Woodworth ITD or the ILD's sign {unexplained}")


def flagship_inputs(mesh_tris: torch.Tensor, rng: np.random.Generator, dev):
    """One scene's inputs in the bench recipe: 4 static events and one moving
    event with an 11-point linear trajectory, tones + noise at 24 kHz, an
    AmbeoVR at MIC_CENTRE, sources inside the room and 1 m or more from it,
    padded to 16 sources with the first one. Returns (sources, s_idx, m_idx,
    plan fields, (amb_on, beta, dB))."""
    from audiblelight_tpu_torch.geometry.queries import points_inside_mesh
    from audiblelight_tpu_torch.ops.convolve import interpolation_matrix
    from audiblelight_tpu_torch.ops.stft import n_stft_frames

    es, em, j, s = BUCKETS
    lo, hi = np.array([0.3, 0.3, 0.3]), np.array([6.7, 4.7, 2.2])

    def inside(pts):
        ok = points_inside_mesh(torch.as_tensor(pts, dtype=torch.float32, device=dev), mesh_tris)
        return ok.cpu().numpy() & (np.linalg.norm(pts - np.array(MIC_CENTRE), axis=1) >= 1.0)

    cand = rng.uniform(lo, hi, (256, 3))
    statics = cand[inside(cand)][:N_STATIC]
    while True:
        a = rng.uniform(lo, hi)
        step = rng.standard_normal(3) * np.array([1.0, 1.0, 0.1])
        traj = a + np.linspace(0.0, 2.0, N_TRAJ)[:, None] * step / np.linalg.norm(step)
        if inside(traj).all():
            break
    src = np.concatenate([statics, traj])
    src = np.concatenate([src, np.tile(src[:1], (N_SOURCES - len(src), 1))]).astype(np.float32)
    s_idx = np.arange(N_STATIC)
    m_idx = np.full((em, j), -1)
    m_idx[0, :N_TRAJ] = np.arange(N_STATIC, N_STATIC + N_TRAJ)

    t = np.arange(s) / SR
    audio = np.stack([
        0.5 * np.sin(2 * np.pi * 200.0 * (i + 1) * t) * np.exp(-t * 0.4) + 0.05 * rng.standard_normal(s)
        for i in range(es + em)
    ]).astype(np.float32)
    audio /= np.abs(audio).max(axis=1, keepdims=True)
    fr = n_stft_frames(s)
    w = np.zeros((em, fr, j), np.float32)
    w[0, :, :N_TRAJ] = interpolation_matrix(np.linspace(0, EVENT_SECONDS, N_TRAJ), SR, 128, fr)
    t_scene = int(SCENE_SECONDS * SR)
    starts = rng.integers(0, t_scene - s, es + em)
    plan = dict(
        static_audio=audio[:es], static_irs=np.zeros((es, 4, 0), np.float32),
        static_mask=np.ones(es, np.float32), static_snr=rng.uniform(5, 30, es).astype(np.float32),
        static_start=starts[:es], static_len=np.full(es, s), static_place_len=np.full(es, s),
        moving_audio=audio[es:], moving_irs=np.zeros((em, 4, j, 0), np.float32), moving_w=w,
        moving_mask=np.ones(em, np.float32), moving_snr=rng.uniform(5, 30, em).astype(np.float32),
        moving_start=starts[es:], moving_len=np.full(em, s), moving_place_len=np.full(em, s),
        ambience=None, ref_db=np.float32(REF_DB), n_scene_samples=t_scene,
    )
    return src, s_idx, m_idx, plan, (1.0, 0.0, REF_DB)


def profiled(fn, label: str) -> tuple:
    """(profiler averages, device busy ms) of one run of `fn`, with the
    busiest device ops and host ops printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    # Device-side events only: a CPU op's device time repeats its kernels'
    self_dev = [(getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0)) / 1e3,
                 ev.count, ev.key) for ev in avgs if ev.device_type == DeviceType.CUDA]
    busy = sum(t for t, _, _ in self_dev)
    count = {k: sum(ev.count for ev in avgs if ev.key == k)
             for k in ("aten::_local_scalar_dense", "cudaStreamSynchronize", "cudaLaunchKernel")}
    host = sum(ev.self_cpu_time_total for ev in avgs if ev.device_type == DeviceType.CPU) / 1e3
    print(f"{label}: device busy {busy:.3f} ms; host {host:.3f} ms in profiled ops; calls {count}")
    for t, n, key in sorted(self_dev, reverse=True)[:12]:
        if t > 0:
            print(f"{label}:   {t:9.3f} ms {n:5d}x  {key[:90]}")
    host_ops = sorted(((ev.self_cpu_time_total / 1e3, ev.count, ev.key) for ev in avgs
                       if ev.device_type == DeviceType.CPU), reverse=True)
    for t, n, key in host_ops[:8]:
        print(f"{label}:   host {t:9.3f} ms {n:5d}x  {key[:80]}")
    return avgs, busy


def kernel_times(avgs, names, label: str) -> dict:
    """{name: (device ms, launches)} of the kernels `names` in the profiler
    averages `avgs`, each printed after `label`."""
    out = {}
    for ev in avgs:
        t_dev = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0)) / 1e3
        for name in names:
            if is_kernel(ev.key, name) and t_dev > 0:
                out[name] = (t_dev, ev.count)
                print(f"{label}: {name} {t_dev:.3f} ms over {ev.count} launches ({t_dev / ev.count:.4f} ms a launch)")
    return out


def mxu_phase(renderer, inputs: tuple, t_scene: int, results: dict) -> dict:
    """The acoustic LOD through the bilinear first hit (K8): the first
    flagship scene with config.USE_MXU_FIRST_HIT, beside the default scene
    of the same inputs and generator (K1's launches there less its bounces
    must be K8's scene's); their IRs traced again with one seed, held to 5 %
    in per-channel energy and per-band T30; the scenes' time, idle share and
    kernel launches per bounce in turns; the tables' build time (once per
    mesh). K8 (`check_walk`) held against its plain walk (bit for bit, visit
    counts included) and its dense plain version (the dense selection with
    the plane re-evaluation), and against K1 (faces agreeing on at least the
    0.78 of the reference's own test, t within its 5e-4 + 5e-4 |t| there) on
    the K8 trace's own bounces, the first and the last of each decimation
    phase. `inputs` = (sources, listeners, rain table, s_idx, m_idx, plan,
    ambience). Returns the K8 scene's launch counts."""
    from audiblelight_tpu_torch import config
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.ops import mxu_first_hit as mxu
    from audiblelight_tpu_torch.rir import raytracer

    src_t, listeners, face_occ, s_idx_t, m_idx_t, splan, amb = inputs
    dev, st = src_t.device, renderer.state

    def mxu_scene(on: bool):
        config.USE_MXU_FIRST_HIT = on
        try:
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            wav = renderer.render_mix(torch.Generator(device=dev).manual_seed(1000), src_t, listeners, face_occ,
                                      s_idx_t, m_idx_t, splan, *amb)
            torch.cuda.synchronize()
            return time.time() - t0, dict(ck.launch_counts), wav
        finally:
            config.USE_MXU_FIRST_HIT = False

    k1_s, k1_n, _ = mxu_scene(False)
    mxu_s, mxu_n, mxu_wav = mxu_scene(True)
    bounces_k1 = k1_n["deposit_histogram"]
    print(f"K8 scene: {mxu_s:.3f} s (host clock, after the default scene's {k1_s:.3f} s); launches {mxu_n}; "
          f"the default scene's {k1_n}", flush=True)
    for name in MXU_PATH:
        if mxu_n[name] <= 0:
            fail(f"the K8 scene never launched {name}")
    if mxu_n["first_hit_mxu"] != mxu_n["deposit_histogram"] or mxu_n["first_hit_mxu"] != bounces_k1:
        fail("the K8 scene did not take K8 once per bounce")
    def dense(n):  # K1 launches, either variant
        return n["first_hit_big"] + n["first_hit_small"]

    if dense(mxu_n) != dense(k1_n) - bounces_k1 or mxu_n["any_hit"] != k1_n["any_hit"]:
        fail("the K8 scene's K1 and K2 launches are not the default scene's less its bounces")
    if mxu_wav.dtype != torch.int16 or tuple(mxu_wav.shape) != (4, t_scene) or int(mxu_wav.abs().max()) < 100:
        fail("the K8 scene's payload is misshapen or silent")
    # Timed in turns (default, K8, ...; the runs above warmed both up), then
    # each profiled once
    turns = {False: [], True: []}
    for on in (False, True) * 3:
        turns[on].append(time_ms(lambda: mxu_scene(on), reps=1, warm=False))
    k1_ms, mxu_ms = float(np.median(turns[False])), float(np.median(turns[True]))
    busy = {on: profiled(lambda: mxu_scene(on), f"{'K8' if on else 'default'} scene profile") for on in (False, True)}
    per_bounce = {on: launch_calls(avgs) / bounces_k1 for on, (avgs, _) in busy.items()}
    print(f"K8 scene time (CUDA events, median of 3 in turns): {mxu_ms:.3f} ms, device busy {busy[True][1]:.3f} ms, "
          f"idle share {1 - busy[True][1] / mxu_ms:.1%}; the default scene's {k1_ms:.3f} ms, busy "
          f"{busy[False][1]:.3f} ms, idle share {1 - busy[False][1] / k1_ms:.1%}; kernel launches per bounce "
          f"{per_bounce[True]:.2f} (the default scene's {per_bounce[False]:.2f}, {bounces_k1} bounces)", flush=True)
    for on, (avgs, _) in busy.items():
        kernel_times(avgs, ("first_hit_mxu", "first_hit_big"), f"{'K8' if on else 'default'} scene")
    config.USE_MXU_FIRST_HIT = True
    try:
        tables_ms = build_ms(lambda: mxu.build_mxu_face_tables(st.acoustic_tris))
        cached = st.mxu_tables(st.acoustic_tris)
    finally:
        config.USE_MXU_FIRST_HIT = False
    print(f"K8 tables and face tree of the LOD ({cached}): built once per mesh, {tables_ms:.3f} ms (host clock, "
          f"synchronised)", flush=True)

    kept_mxu = {}

    def keep_mxu(tables, o, d, prev):
        keep_first_last(kept_mxu, o.shape[0], (tables, o.clone(), d.clone(), prev.clone()))
        return mxu.mxu_first_hit(tables, o, d, prev)

    irs_k1 = renderer.trace(torch.Generator(device=dev).manual_seed(7), src_t, listeners, face_occ)
    config.USE_MXU_FIRST_HIT = True
    raytracer.mxu_first_hit = keep_mxu
    try:
        irs_k8 = renderer.trace(torch.Generator(device=dev).manual_seed(7), src_t, listeners, face_occ)
    finally:
        raytracer.mxu_first_hit = mxu.mxu_first_hit
        config.USE_MXU_FIRST_HIT = False
    compare_irs("K8 scene IRs against the default scene's", irs_k8, irs_k1, 0.05, 0.05)
    if len(kept_mxu) != 3:
        fail(f"the K8 trace ran at ray counts {sorted(kept_mxu)}, expected three decimation phases")
    table_lod = ck.first_hit_table(st.acoustic_tris)
    for rays, kept in sorted(kept_mxu.items(), reverse=True):
        for which, (tables, o8, d8, prev8) in zip(("first", "last"), kept):
            if tables is not cached:
                fail("the K8 trace did not take the tables cached per mesh")
            call = lambda: mxu.mxu_first_hit(tables, o8, d8, prev8)
            got = check_walk("first_hit_mxu", f"K8 trace's {which} bounce of {rays} rays",
                             lambda v: ck.first_hit_mxu(o8, d8, prev8, tables.center, tables.bvh, v),
                             lambda: mxu.mxu_walk(tables, o8, d8, prev8),
                             lambda: mxu.mxu_first_hit_plain(tables, o8, d8, prev8))
            t_k, i_k, vis = got["t"], got["face"], got["visits"].double()
            t_1, i_1 = ck.ray_first_hit(o8, d8, st.acoustic_tris, table_lod)
            agree = i_k == i_1
            both = agree & torch.isfinite(t_k) & torch.isfinite(t_1)
            # The reference's own test of this route: rtol and atol 5e-4 where the faces agree
            close = bool(((t_k - t_1).abs() <= 5e-4 + 5e-4 * t_1.abs())[both].all())
            rel = float(((t_k - t_1).abs() / t_1.abs())[both].max()) if bool(both.any()) else 0.0
            share = float(agree.float().mean())
            k_ms, dev_ms = time_ms(call), device_ms(call)
            k1_call = lambda: ck.ray_first_hit(o8, d8, st.acoustic_tris, table_lod)
            k1_ms, k1_dev = time_ms(k1_call), device_ms(k1_call)
            f_lod = tables.n_faces
            # Pairs this data needs: the faces whose window (with its slop)
            # the ray's segment up to its hit could reach
            needed, _ = first_hit_pairs(o8, d8, t_k, i_k, face_boxes(st.acoustic_tris, ck.MXU_EPS_UV))
            # Each ray's origin, direction and launch face read once, its (t, face)
            # written once, and the packed rows and the centre read once
            b_ms, b_by = bound_ms(needed * FLOPS_MXU_PAIR, rays * (24 + 4 + 8) + f_lod * ck.MXU_PACKED_COLS * 4 + 12)
            print(f"first_hit_mxu at the K8 trace's {which} bounce of {rays} rays x {f_lod} faces ({tables.bvh}): "
                  f"faces agree with K1 on {share:.4f} of the rays, t within 5e-4 + 5e-4 |t| there {close} (at most "
                  f"{rel:.3e} relative); per ray {float(vis[:, 0].mean()):.1f} box tests (max {int(vis[:, 0].max())}) "
                  f"and {float(vis[:, 1].mean()):.2f} leaves of {tables.bvh.leaf_faces} faces (max "
                  f"{int(vis[:, 1].max())}); {k_ms:.4f} ms per call (device {dev_ms:.4f} ms, "
                  f"{launches_per_call(call)} launch), plain walk {got['walk_ms']:.3f} ms, dense plain "
                  f"{got['dense_ms']:.3f} ms, K1 on the same rays {k1_ms:.4f} ms (device {k1_dev:.4f} ms); (ray, "
                  f"face) pairs this data needs {needed} ({needed / (rays * f_lod):.3%} of dense), bound "
                  f"{b_ms:.5f} ms ({b_by})", flush=True)
            if share < 0.78 or not close:
                fail(f"first_hit_mxu strays from K1 at {rays} rays")
            if "first_hit_mxu" not in results:
                # Yardstick: the reference's four (R, 16) x (16, F_pad) fp32
                # products, their operands laid out from the packed rows
                _, _, rvec, _ = mxu.mxu_inputs(tables, o8, d8, prev8)
                rmat = torch.nn.functional.pad(torch.cat([rvec, torch.ones_like(rvec[:, :1])], dim=1), (0, 6))
                f_pad = tables.normal.shape[0]
                ops = []
                for row0, c0, c1 in ((0, 0, 6), (0, 6, 12), (3, 12, 15), (6, 15, 19)):
                    m = torch.zeros((16, f_pad), dtype=torch.float32, device=dev)
                    m[row0 : row0 + c1 - c0, :f_lod] = tables.packed[:, c0:c1].T
                    ops.append(m)
                results["first_hit_mxu"] = dict(
                    max_abs_err=got["max_abs_err"], bound_ms=b_ms, bound_by=b_by, ms=k_ms, plain_ms=got["walk_ms"],
                    library_ms=time_ms(lambda: [torch.matmul(rmat, m) for m in ops]),
                )
                print(f"first_hit_mxu yardstick: the four ({rays}, 16) x (16, {f_pad}) fp32 "
                      f"products by torch.matmul {results['first_hit_mxu']['library_ms']:.4f} ms")
    return mxu_n


def tiled_phase(make_scene, xscene, k1_scene: tuple, st_x, table_x, interior: tuple, results: dict) -> tuple:
    """The exact-mode scene again with config.USE_TILED_FIRST_HIT: the same
    seed and placement (`make_scene`) through Scene.generate(compiled=True), every
    bounce's first hit through K7 on the full mesh's face tree,
    built once per mesh (K1's launches there must be the K1 scene's less its
    bounces); its IRs held to 1 % in per-channel energy and 2 % in per-band
    T30 against the K1 scene's; its trace timed and profiled beside the K1
    trace. Then K7 (`check_walk`) against its plain walk (bit for bit, visit
    counts included) and its dense plain version (the dense classic
    Moller-Trumbore first hit over the mesh) on the K7 trace's own
    bounces (the first and the last of each decimation phase), on 80k of that
    scene's bounce rays (surface origins) and on the interior rays
    `interior`; and against K1 big on each: faces may differ only at edges
    (t within 1e-5 relative there); on the last two hits and misses agree,
    as before the redesign; on the trace's bounces the rays where one
    arithmetic hits and the other misses are printed, and K1 big is held to
    its dense walk there. `k1_scene` = (the K1 scene's
    generate seconds, launches, IRs, trace ms, trace device busy ms, trace
    kernel launches). Returns the K7 scene's launch counts and the 80k
    surface rays (origins, dirs)."""
    from audiblelight_tpu_torch import config
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.ops import tiled_first_hit as tfh
    from audiblelight_tpu_torch.rir import raytracer

    exact_s, exact_launches, exact_irs, exact_trace_ms, exact_busy, exact_calls = k1_scene
    origins, dirs = interior
    n_full = st_x.tris.shape[0]

    first_three, kept_tiled = [], {}

    def keep_tiled(tree, o, d):
        if len(first_three) < 3:
            first_three.append((tree, o.clone(), d.clone()))
        keep_first_last(kept_tiled, o.shape[0], (tree, o.clone(), d.clone()))
        return tfh.tiled_first_hit(tree, o, d)

    tiled_dir = OUT / "exact_tiled"
    shutil.rmtree(tiled_dir, ignore_errors=True)
    tiled_dir.mkdir(parents=True)
    config.USE_TILED_FIRST_HIT = True
    raytracer.tiled_first_hit = keep_tiled
    try:
        tscene = make_scene()
        if not np.array_equal(tscene.state._emitter_positions(), xscene.state._emitter_positions()):
            fail("the K7 exact scene placed its events elsewhere than the K1 scene")
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        tscene.generate(output_dir=tiled_dir, compiled=True)
        torch.cuda.synchronize()
        tiled_s = time.time() - t0
        tiled_launches = dict(ck.launch_counts)
        tiled_irs = tscene.state.trace_irs_device()["mic000"]
    finally:
        raytracer.tiled_first_hit = tfh.tiled_first_hit
    bounces = tiled_launches["star_any_hit"]
    print(f"K7 exact scene: Scene.generate() in {tiled_s:.3f} s (host clock, render and writes; the K1 scene "
          f"{exact_s:.3f} s); launches {tiled_launches}", flush=True)
    for name in TILED_PATH:
        if tiled_launches[name] <= 0:
            fail(f"the K7 exact scene never launched {name}")
    if tiled_launches["first_hit_tiled"] != bounces:
        fail("the K7 exact scene did not take K7 once per bounce")
    if tiled_launches["first_hit_big"] != exact_launches["first_hit_big"] - exact_launches["star_any_hit"]:
        fail("the K7 exact scene's K1 launches are not the K1 scene's less its bounces")
    compare_irs("K7 exact scene IRs against the K1 exact scene's", tiled_irs, exact_irs, 0.01, 0.02)
    tree = first_three[0][0]
    if any(kept[0] is not tree for kept in first_three + [k for v in kept_tiled.values() for k in v]):
        fail("the K7 exact trace did not take one face tree per mesh")

    def tiled_trace():
        tscene.state._irs_device_cache = None
        tscene.state.trace_irs_device()

    try:
        tiled_trace_ms = time_ms(tiled_trace, reps=1, warm=False)
        avgs_t, busy_t = profiled(tiled_trace, "K7 exact trace profile")
    finally:
        config.USE_TILED_FIRST_HIT = False
    print(f"K7 exact trace time (CUDA events): {tiled_trace_ms:.3f} ms, device idle share "
          f"{1 - busy_t / tiled_trace_ms:.1%}, kernel launches per bounce {launch_calls(avgs_t) / bounces:.2f}; the K1 "
          f"trace's {exact_trace_ms:.3f} ms, idle share {1 - exact_busy / exact_trace_ms:.1%}, launches per bounce "
          f"{exact_calls / bounces:.2f} (profiler busy over CUDA-event time; {bounces} bounces)")
    kernel_times(avgs_t, TILED_PATH, "K7 exact per trace")
    n_real = int((tree.face >= 0).sum())
    tree_ms = build_ms(lambda: tfh.build_tiled_tree(st_x.tris, device=st_x.tris.device))
    print(f"K7 face tree of the full mesh ({tree}): built once per mesh, {tree_ms:.3f} ms (host clock, "
          f"synchronised)", flush=True)
    dense_x = ck.dense_mt_table(st_x.tris)

    boxes = face_boxes(st_x.tris)
    # The scene's bounces have 5,000 rays per padded source: its second and
    # third bounce together make the flagship's 80k surface-origin rays
    surface = [torch.cat([first_three[1][k], first_three[2][k]])[:80000].contiguous() for k in (1, 2)]
    waves = [(f"K7 trace's {which} bounce of {rays} rays", o7, d7)
             for rays, kept in sorted(kept_tiled.items(), reverse=True)
             for which, (_, o7, d7) in zip(("first", "last"), kept)]
    waves += [("exact scene's second and third bounces", *surface), ("interior rays", origins, dirs)]
    for label, o7, d7 in waves:
        got = check_walk("first_hit_tiled", f"{label} ({o7.shape[0]} rays x {n_full} faces)",
                         lambda v: ck.first_hit_tiled(o7, d7, tree, v), lambda: tfh.tiled_walk(tree, o7, d7),
                         lambda: ck.ray_first_hit_plain(o7, d7, st_x.tris, dense_x))
        t7, i7, vis = got["t"], got["face"], got["visits"].double()
        call = lambda: tfh.tiled_first_hit(tree, o7, d7)
        k7_ms, k7_dev = time_ms(call), device_ms(call)
        k1_call = lambda: ck.ray_first_hit(o7, d7, st_x.tris, table_x)
        k1_ms, k1_dev = time_ms(k1_call), device_ms(k1_call)
        t_1, i_1 = k1_call()
        mis = (i7 != i_1) & torch.isfinite(t7) & torch.isfinite(t_1)
        rel1 = float(((t7 - t_1).abs() / t_1.abs())[mis].max()) if bool(mis.any()) else 0.0
        odd = torch.nonzero(torch.isfinite(t7) != torch.isfinite(t_1)).flatten()
        miss1 = odd.numel()
        if miss1:
            # Where one arithmetic hits and the other misses, K1 big must
            # still be its own dense walk: the two arithmetics differ, not a cull
            t_b, i_b = ck.ray_first_hit_plain(o7[odd], d7[odd], st_x.tris, table_x)
            for j, tb, ib in zip(odd.tolist()[:5], t_b.tolist(), i_b.tolist()):
                print(f"  K7 (classic Moller-Trumbore) and K1 big (bilinear) disagree on a hit, ray {j}: K7 face "
                      f"{int(i7[j])} t {float(t7[j]):.9g}, K1 big face {int(i_1[j])} t {float(t_1[j]):.9g}, K1's dense "
                      f"walk face {ib} t {tb:.9g}; origin {o7[j].tolist()}, direction {d7[j].tolist()}")
            if not (torch.equal(i_b, i_1[odd]) and torch.equal(t_b, t_1[odd])):
                fail(f"first_hit_big differs from its dense walk on the {label}")
        # Pairs this data needs: each face whose box the ray's segment
        # [0, t_hit] enters (a slab test, the boxes of the tree's Morton
        # runs of 256 faces first)
        needed, _ = first_hit_pairs(o7, d7, t7, i7, boxes, order=tree.face.long())
        n_rays = o7.shape[0]
        # Each ray read once and its (t, face) written once, each real
        # face's [a, e1, e2] read once, as the dense first hit needs them
        b_ms, b_by = bound_ms(needed * FLOPS_MT_PAIR, n_rays * (24 + 8) + n_real * 36)
        print(f"first_hit_tiled on the {label}: against K1 big {int(mis.sum())} faces differ (t within {rel1:.3e} "
              f"relative there), {miss1} hit/miss differ; per ray {float(vis[:, 0].mean()):.1f} box tests (max "
              f"{int(vis[:, 0].max())}) and {float(vis[:, 1].mean()):.2f} leaves of {tree.leaf_faces} faces "
              f"(max {int(vis[:, 1].max())}); {k7_ms:.4f} ms per call (device {k7_dev:.4f} ms, "
              f"{launches_per_call(call)} launch), plain walk {got['walk_ms']:.3f} ms, dense plain "
              f"{got['dense_ms']:.3f} ms, K1 big {k1_ms:.4f} ms (device {k1_dev:.4f} ms) on the same rays; (ray, "
              f"face) pairs this data needs {needed} ({needed / (n_rays * n_full):.4%} of dense); bound "
              f"{b_ms:.5f} ms ({b_by})", flush=True)
        if rel1 > 1e-5 or (miss1 and not label.startswith("K7 trace's")):
            fail(f"first_hit_tiled differs from K1 big by more than an edge tie ({label})")
        if label.startswith("exact scene's") and "first_hit_tiled" not in results:
            results["first_hit_tiled"] = dict(max_abs_err=got["max_abs_err"], bound_ms=b_ms, bound_by=b_by, ms=k7_ms,
                                              library_ms=None, plain_ms=got["walk_ms"])
    return tiled_launches, surface


def sorted_pair_phase(wavefronts: list, results: dict) -> dict:
    """The cone-sorted (K9) and pair-walk (K10) first hits, which neither
    package wires into its tracer, through their own entry points: the
    Morton tiles of each mesh (`build_sorted_tiles`, which builds K10's tree
    of the tiles' rows in their own order, `build_pair_tree`, timed again on
    its own) and K9's tree of them (`build_sorted_tree`), then
    `sorted_first_hit` and `pair_first_hit` on every wavefront of
    `wavefronts` ((label, tris, origins, dirs, alive or None)), launches
    counted from zero around that run (each once per call). Then, per
    wavefront: K9 with visits against its plain walk (t, faces and visit
    counts identical) and against K1 big over the sentinel-padded sorted
    faces (bit for bit, the same table and the same tree: K1 big's visits
    equal K9's on the live rays); K10 with its per-ray counts against its
    plain walk (t, faces and every ray's rounds, live pairs, box tests and
    leaves identical) and against the reference-shaped rounds
    (`pair_rounds`: t, faces, rounds and live pairs identical); each op
    against K1 big over the sorted faces and, through `order`, against K1
    big over the mesh as it is (t identical, faces differing only at a tie);
    K9's box tests and leaves per live ray, K10's tiles, box tests and
    leaves per live ray, rounds and rays unresolved after round 1; each op
    one kernel launch per call and K10 no host sync (profiler); K9's and
    K10's time per call (and its device part) beside K1 big's on the same
    rays, the plain versions' times, and the bound of the first hit: the
    pairs this data needs, the rays and the table read once, the result
    written once. Returns the phase's launch counts."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.ops import pair_first_hit as pfh
    from audiblelight_tpu_torch.ops import sorted_first_hit as sfh

    built, tables = {}, {}
    for _, tris, *_ in wavefronts:
        if id(tris) not in built:
            t0 = time.time()
            tris_np = tris.cpu().numpy()
            tiles, order = sfh.build_sorted_tiles(tris_np, device=tris.device)
            t1 = time.time()
            tree = sfh.build_sorted_tree(tiles, tris_np, order)
            torch.cuda.synchronize()
            t2 = time.time()
            again = pfh.build_pair_tree(tiles, tris_np, order)
            torch.cuda.synchronize()
            t3 = time.time()
            if not (torch.equal(again.boxes, tiles.pair_tree.boxes) and torch.equal(again.face, tiles.pair_tree.face)):
                fail(f"build_pair_tree gave another tree than build_sorted_tiles' on {tiles}")
            built[id(tris)] = (tiles, order, tree, t1 - t0, t2 - t1, t3 - t2)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    outs = []
    for _, tris, o, d, alive in wavefronts:
        tiles, _, tree, *_ = built[id(tris)]
        outs.append((sfh.sorted_first_hit(tiles, tree, o, d, alive), pfh.pair_first_hit(tiles, o, d, alive)))
    torch.cuda.synchronize()
    launches = dict(ck.launch_counts)
    print(f"K9 and K10 on {len(wavefronts)} wavefronts through their entry points in {time.time() - t0:.3f} s "
          f"(host clock); launches {launches}; host builds (tiles with K10's tree, then K9's tree; K10's tree alone) "
          f"{', '.join(f'{b[0]} {b[3]:.2f} s, {b[2]} {b[4] * 1e3:.1f} ms; {b[0].pair_tree} {b[5] * 1e3:.1f} ms' for b in built.values())}",
          flush=True)
    for name in ("first_hit_sorted", "first_hit_pair"):
        if launches[name] != len(wavefronts):
            fail(f"the K9/K10 path launched {name} {launches[name]} times, not once per wavefront")

    for (label, tris, o, d, alive), ((t9, i9), (t10, i10)) in zip(wavefronts, outs):
        tiles, order, tree, *_ = built[id(tris)]
        ptree = tiles.pair_tree
        r, dev = o.shape[0], o.device
        live = torch.ones(r, dtype=torch.bool, device=dev) if alive is None else alive
        n_live = int(live.sum())
        # K9 with visits against its plain walk
        visits = torch.empty((r, 2), dtype=torch.int32, device=dev)
        t_k, i_k = ck.first_hit_sorted(o, d, alive, tiles.center, tree, visits)
        walk = []
        k9_plain_ms = time_ms(lambda: walk.append(sfh.sorted_walk(tiles, tree, o, d, alive)), reps=1, warm=False)
        t_p, i_p, vis_p = walk[0]
        exact9 = (torch.equal(t_k, t_p) and torch.equal(i_k, i_p) and torch.equal(visits, vis_p)
                  and torch.equal(t_k, t9) and torch.equal(i_k, i9) and not bool(visits[~live].any()))
        # K10 with its per-ray counts against its plain walk, and against the
        # reference-shaped rounds
        counts = torch.empty((r, 4), dtype=torch.int32, device=dev)
        t_kc, i_kc = ck.first_hit_pair(o, d, alive, tiles.center, tiles.tile_lo, tiles.tile_hi, ptree, 8, counts)
        walk10, rounds10 = [], []
        k10_plain_ms = time_ms(lambda: walk10.append(ck.pair_walk_plain(o, d, alive, tiles.center, tiles.tile_lo,
                                                                        tiles.tile_hi, ptree, 8)), reps=1, warm=False)
        t_pw, i_pw, c_pw = walk10[0]
        k10_rounds_ms = time_ms(lambda: rounds10.append(pfh.pair_rounds(tiles, o, d, live)), reps=1, warm=False)
        t_r, i_r, st_r = rounds10[0]
        n_rounds = int(counts[:, 0].max())
        exact10 = (torch.equal(t_kc.view(torch.int32), t_pw.view(torch.int32)) and torch.equal(i_kc, i_pw)
                   and torch.equal(counts, c_pw) and torch.equal(t_kc, t10) and torch.equal(i_kc, i10))
        fin = torch.isfinite(t_pw)
        k10_err = float((t_kc[fin] - t_pw[fin]).abs().max()) if bool(fin.any()) else 0.0
        rounds_ok = (torch.equal(t10, t_r) and torch.equal(i10, i_r) and st_r["rounds"] == max(1, n_rounds)
                     and int(st_r["pairs"]) == int(counts[:, 1].sum())
                     and int(st_r["unresolved_first"]) == int((counts[:, 0] > 1).sum()))
        # Each op against K1 big over the sentinel-padded sorted faces: the
        # same table, and the same tree (K1 big's visits are K9's)
        st = torch.from_numpy(sfh.padded_sorted_tris(tris.cpu().numpy(), order, tiles.n_tiles)).to(dev)
        table_s = ck.big_first_hit_table(st)
        same_table = (torch.equal(table_s[1], tiles.center) and torch.equal(table_s[2], tiles.face_tab)
                      and torch.equal(table_s[3].boxes, tree.boxes) and torch.equal(table_s[3].face, tree.face))
        t_d, i_d, vis_d = ck.first_hit_walk(o, d, table_s)
        t_d = torch.where(live, t_d, torch.inf)
        i_d = torch.where(live, i_d, -1)
        equal9 = torch.equal(t9, t_d) and torch.equal(i9, i_d) and torch.equal(visits[live], vis_d[live])
        equal10 = torch.equal(t10, t_d) and torch.equal(i10, i_d)
        # ... and through `order` against K1 big over the mesh as it is
        order_t = torch.as_tensor(order, dtype=torch.int64, device=dev)
        if id(tris) not in tables:
            tables[id(tris)] = ck.first_hit_table(tris)
        t_m, i_m = ck.ray_first_hit(o, d, tris, tables[id(tris)])
        t_m = torch.where(live, t_m, torch.inf)
        i_m = torch.where(live, i_m, -1)
        i9_orig = torch.where(i9 >= 0, order_t[i9.clamp_min(0).long()].to(torch.int32), -1)
        ties = int((i9_orig != i_m).sum())
        orig_ok = torch.equal(t9, t_m) and torch.equal(t10, t9)
        # Times, launches and syncs per call, and the bound of the (ray, face)
        # pairs this data needs
        k9_op = (lambda: sfh.sorted_first_hit(tiles, tree, o, d, alive))
        k9_ms, k9_dev_ms, k9_launches = time_ms(k9_op), device_ms(k9_op), launches_per_call(k9_op)
        if k9_launches != 1:
            fail(f"sorted_first_hit launched {k9_launches} kernels per call on the {label}, not one")
        k10_op = (lambda: pfh.pair_first_hit(tiles, o, d, alive))
        k10_ms, k10_dev_ms = time_ms(k10_op), device_ms(k10_op)
        k10_launches, k10_syncs = call_profile(k10_op)
        if k10_launches != 1 or k10_syncs != 0:
            fail(f"pair_first_hit made {k10_launches} kernel launches and {k10_syncs} host syncs per call on the "
                 f"{label}, not one launch and none")
        k1_op = (lambda: ck.ray_first_hit(o, d, st, table_s))
        k1_ms, k1_dev_ms = time_ms(k1_op), device_ms(k1_op)
        boxes = face_boxes(tris)
        pad_order = torch.nn.functional.pad(order_t, (0, tiles.n_tiles * sfh.TILE_FACES - order_t.numel()), value=-1)
        needed, _ = first_hit_pairs(o[live], d[live], t9[live], i9_orig[live], boxes, order=pad_order,
                                    group=sfh.TILE_FACES)
        tab_bytes = tiles.n_faces * 64
        # K9 reads each ray, its alive flag and the centre once, each real row
        # of the table once, and writes t and the face once
        b9_ms, b9_by = bound_ms(needed * FLOPS_BIG_PAIR, r * 25 + 12 + tab_bytes + r * 8)
        # K10's op computes the same first hit: the rays (and their flags)
        # read once, the table read once, t and face written once
        b10_ms, b10_by = bound_ms(needed * FLOPS_BIG_PAIR, r * 25 + tiles.n_tiles * sfh.TILE_FACES * 64 + r * 8)
        vis = visits[live].double()
        c10 = counts[live].double()
        pairs, ideal = int(counts[:, 1].sum()), int(st_r["needed"])
        unres = int((counts[:, 0] > 1).sum())
        print(f"check K9/K10 on the {label}: {r} rays ({n_live} live) x {tiles.n_faces} faces ({tiles}, {tree}, "
              f"K10's {ptree}); K9 identical to its plain walk, visit counts included, {exact9}; K10 identical to "
              f"its plain walk, per-ray rounds, live pairs, box tests and leaves included, {exact10} (largest t gap "
              f"{k10_err}), to the reference-shaped rounds (t, faces, rounds, pairs) {rounds_ok}; the dense big "
              f"table and tree over the sorted faces are the tiles' and K9's {same_table}; K9 equals K1 big over the "
              f"sorted faces, visits included, {equal9}, K10 {equal10}; against K1 big over the mesh as it is t "
              f"identical {orig_ok}, faces differ at {ties} ties; K9 per live ray {float(vis[:, 0].mean()):.1f} box "
              f"tests (max {int(vis[:, 0].max())}) and {float(vis[:, 1].mean()):.2f} leaves of {tree.leaf_faces} "
              f"faces (max {int(vis[:, 1].max())}), {k9_launches} launch per call; K10 {n_rounds} rounds, per live "
              f"ray {float(c10[:, 1].mean()):.2f} tiles tested (max {int(c10[:, 1].max())}; entered before the hit "
              f"{ideal / max(n_live, 1):.2f}), {float(c10[:, 2].mean()):.1f} subtree box tests (max "
              f"{int(c10[:, 2].max())}) and {float(c10[:, 3].mean()):.2f} leaves (max {int(c10[:, 3].max())}), "
              f"{unres / max(n_live, 1):.2%} of live rays unresolved after round 1 ({pairs} pairs), {k10_launches} "
              f"launch and {k10_syncs} host syncs per call; (ray, face) pairs this data needs {needed}; K9 "
              f"{k9_ms:.4f} ms per call (device {k9_dev_ms:.4f} ms), plain walk {k9_plain_ms:.3f} ms, bound "
              f"{b9_ms:.5f} ms ({b9_by}); K10 {k10_ms:.4f} ms per call (device {k10_dev_ms:.4f} ms, "
              f"{k10_ms / k1_ms:.2f}x K1 big), plain walk {k10_plain_ms:.3f} ms, reference-shaped rounds "
              f"{k10_rounds_ms:.3f} ms, bound {b10_ms:.5f} ms ({b10_by}); K1 big on the same rays {k1_ms:.4f} ms "
              f"(device {k1_dev_ms:.4f} ms)", flush=True)
        if not exact9 or not exact10:
            fail(f"K9 or K10 disagrees with its plain walk on the {label}")
        if not rounds_ok:
            fail(f"K10 disagrees with the reference-shaped rounds on the {label}")
        if not (same_table and equal9 and equal10):
            fail(f"K9 or K10 differs from K1 big over the sorted faces on the {label}")
        if not orig_ok:
            fail(f"K9 or K10 differs from K1 big over the mesh beyond a tie on the {label}")
        if "first_hit_sorted" not in results:
            fin = torch.isfinite(t_d)
            results["first_hit_sorted"] = dict(max_abs_err=float((t9[fin] - t_d[fin]).abs().max()) if fin.any() else 0.0,
                                               bound_ms=b9_ms, bound_by=b9_by, ms=k9_ms, plain_ms=k9_plain_ms,
                                               library_ms=None)
            results["first_hit_pair"] = dict(max_abs_err=k10_err, bound_ms=b10_ms, bound_by=b10_by, ms=k10_ms,
                                             plain_ms=k10_plain_ms, library_ms=None)
    return launches


def check_k5_bounces(kept: dict, label: str = "HOA3 trace") -> None:
    """K5 on a trace's own bounces (`kept`: rays per source -> the first and
    last bounce's (bins, deposits, n_bins)): against its plain version (bins
    identical, sums within 1e-5 relative plus 1e-6 of the peak), timed
    beside one `index_add_` of the same fold."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    if len(kept) != 3:
        fail(f"the {label} ran K5 at ray counts {sorted(kept)}, expected three decimation phases")
    for rays, bounces in sorted(kept.items(), reverse=True):
        for which, (bins, dep, n_bins) in zip(("first", "last"), bounces):
            g, _, k = dep.shape
            h_k = ck.bin_histogram(bins, dep, n_bins)
            h_p = ck.bin_histogram_plain(bins, dep, n_bins)
            bins_bad = int(((h_k != 0) != (h_p != 0)).sum())
            peak = h_p.abs().amax().clamp_min(1e-30)
            ok = bool(((h_k - h_p).abs() <= 1e-5 * h_p.abs() + 1e-6 * peak).all())
            keep = (bins >= 0) & (bins < n_bins)
            flat = (torch.arange(g, device=bins.device)[:, None] * n_bins + bins.clamp(0, n_bins - 1)).reshape(-1)
            vals = torch.where(keep[..., None], dep, 0.0).reshape(-1, k)
            out = torch.zeros(g * n_bins, k, device=bins.device)
            warps, cluster = ck.bin_histogram_shape(g, k, n_bins, k % 4 == 0)
            b_ms, b_by = bound_ms(g * rays * k, g * rays * (4 * k + 4) + h_k.numel() * 4)
            print(f"check bin_histogram at the {label}'s {which} bounce of {rays} rays per source ({tuple(dep.shape)}, "
                  f"{int((dep != 0).any(-1).sum())} rays deposit, in {int(torch.unique(bins[keep]).numel())} bins; "
                  f"{warps} warps a CTA, clusters of {cluster}): bin mismatches {bins_bad}, within tolerance {ok}; "
                  f"{time_ms(lambda: ck.bin_histogram(bins, dep, n_bins)):.4f} ms per call (device "
                  f"{device_ms(lambda: ck.bin_histogram(bins, dep, n_bins)):.4f}), index_add_ "
                  f"{time_ms(lambda: out.index_add_(0, flat.long(), vals)):.4f} ms (device "
                  f"{device_ms(lambda: out.index_add_(0, flat.long(), vals)):.4f}), bound {b_ms:.5f} ms ({b_by})",
                  flush=True)
            if bins_bad or not ok:
                fail(f"bin_histogram disagrees with its plain version at the {label}'s bounce of {rays} rays")


def check_deposit(name: str, args: list, kw: dict, label: str) -> dict:
    """K3 (`name` "deposit_histogram") or K4 ("deposit_histogram_foa") on one
    bounce's inputs: against its plain version (bins identical, max |diff|
    within 1e-5 of each histogram's peak), a second launch bit-identical;
    timed per call by CUDA events, on the device (profiler) and the host's
    part as their difference, beside its plain version and one `index_add_`
    of the plain version's fold on the same inputs (per call and on the
    device). The bound reads what this bounce needs: every occlusion flag,
    and the rays a capsule sees once each; the geometry for each seen (ray,
    capsule). Returns the kernel line's entry."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    foa = name == "deposit_histogram_foa"
    kernel, plain = getattr(ck, name), getattr(ck, f"{name}_plain")
    h_k = kernel(*args, **kw)
    h_p = plain(*args, **kw)
    same = torch.equal(h_k, kernel(*args, **kw))
    bins_bad = int(((h_k != 0) != (h_p != 0)).sum())
    rel = float(((h_k - h_p).abs() / h_p.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    err = float((h_k - h_p).abs().max())
    hit, _, e_refl, _, occ, _ = args
    tr, n_bands = e_refl.shape
    n_caps, n_sources, n_bins = occ.shape[0], kw["n_sources"], kw["n_bins"]
    n_bins_pad = ck._deposit_constants(n_bins, kw["bin_dt"], kw["c_sound"])[0]
    rows, vals = (ck.deposit_foa_fold_plain if foa else ck.deposit_fold_plain)(*args, **kw)
    hist = torch.zeros(n_caps * n_sources * n_bins_pad, vals.shape[1], device=hit.device)
    seen = ~occ
    flops = int(seen.sum()) * (FLOPS_DEPOSIT_FOA if foa else FLOPS_DEPOSIT)
    b_ms, b_by = bound_ms(flops, occ.numel() + int(seen.any(0).sum()) * (28 + 4 * n_bands) + h_k.numel() * 4)
    ms, dev_ms = time_ms(lambda: kernel(*args, **kw)), device_ms(lambda: kernel(*args, **kw))
    fold = lambda: hist.index_add_(0, rows, vals)  # noqa: E731
    lib_ms, lib_dev_ms = time_ms(fold), device_ms(fold)
    plain_ms = time_ms(lambda: plain(*args, **kw), reps=3)
    n_scenes = args[5].shape[0] if args[5].dim() == 3 else 1  # a batch's listener points (n_scenes, C, 3)
    warps, cluster = ck.deposit_histogram_shape(n_sources // n_scenes * (1 if foa else n_caps), 4 if foa else 1,
                                                n_bands, n_bins, n_bands % 4 == 0)
    print(f"check {name} at {label} ({tr} rays, {n_sources} sources x {n_caps} {'listener' if foa else 'capsules'} "
          f"-> {tuple(h_k.shape)}; {int(seen.sum())} (ray, {'listener' if foa else 'capsule'}) pairs seen, deposits "
          f"in {int(torch.unique(rows[vals.ne(0).any(-1)]).numel())} histogram rows; {warps} warps a CTA, clusters "
          f"of {cluster}): bin mismatches {bins_bad}, max |diff| {err:.3e}, max |diff| / histogram peak {rel:.3e}, "
          f"second launch bit-identical {same}; {ms:.4f} ms per call, device {dev_ms:.4f}, host {ms - dev_ms:.4f}; "
          f"plain {plain_ms:.4f} ms; index_add_ of the plain fold {lib_ms:.4f} ms, device {lib_dev_ms:.4f}; bound "
          f"{b_ms:.5f} ms ({b_by})", flush=True)
    if bins_bad or rel > 1e-5 or not same or tuple(h_k.shape) != (n_sources, 4 if foa else n_caps, n_bands, n_bins):
        fail(f"{name} disagrees with its plain version or with itself, or is misshapen, at {label}")
    return dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, ms=ms, plain_ms=plain_ms, library_ms=lib_ms)


def check_deposit_bounces(name: str, kept: dict, label: str) -> None:
    """`check_deposit` on a trace's own bounces (`kept`: rays -> the first
    and the last bounce's (args, kwargs)), three decimation phases."""
    if len(kept) != 3:
        fail(f"the {label} ran {name} at ray counts {sorted(kept)}, expected three decimation phases")
    for rays, bounces in sorted(kept.items(), reverse=True):
        for which, (args, kwargs) in zip(("first", "last"), bounces):
            check_deposit(name, args, kwargs, f"the {label}'s {which} bounce of {rays} rays")


def keep_deposits(name: str, kept: dict):
    """A stand-in for the tracer's `name` that keeps its inputs at the first
    and the last bounce of each ray count (`keep_first_last`) in `kept`."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    def keep(*args, **kwargs):
        keep_first_last(kept, args[0].shape[0], ([a.clone() for a in args], kwargs))
        return getattr(ck, name)(*args, **kwargs)

    return keep


def check_first_hits(launches: dict, big: int, label: str) -> None:
    """Fails unless the run `launches` launched K1 big `big` times and no
    other first-hit kernel."""
    others = {k: launches[k] for k in KERNELS if k.startswith("first_hit") and k != "first_hit_big" and launches[k]}
    if launches["first_hit_big"] != big or others:
        fail(f"{label} launched first_hit_big {launches['first_hit_big']} times (expected {big}) and {others}")


def check_k1(label: str, o, d, tris, table, results: dict = None, bound: tuple = None) -> None:
    """K1 big (the face-tree walk, one launch) against its plain version (the
    dense walk over every face) and the plain tree walk on the rays `o`, `d`
    against `tris` and its `table` (`first_hit_table`): t bits, faces and
    misses identical (0 ulp), the kernel's visit counts equal to the plain
    walk's. Prints the mean box tests and leaf folds per ray (the walk's
    divergence), the time per call (and its device part: the centring
    subtraction and the kernel) and the dense plain time; with `results`,
    records K1's line from this check (`bound` = (ms, by))."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    t_k, i_k = ck.ray_first_hit(o, d, tris, table)
    dense = []
    plain_ms = time_ms(lambda: dense.append(ck.ray_first_hit_plain(o, d, tris, table)), reps=1, warm=False)
    t_p, i_p = dense[0]
    t_w, i_w, vis_k = ck.first_hit_walk(o, d, table)
    t_wp, i_wp, vis_p = ck.first_hit_walk_plain(o, d, table)
    torch.cuda.synchronize()
    fin = torch.isfinite(t_p)
    idx_bad = int((i_k != i_p).sum())
    inf_bad = int((torch.isfinite(t_k) != fin).sum())
    ulp = int(ulp_distance(t_k[fin], t_p[fin]).max()) if fin.any() else 0
    err = float((t_k[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0
    walk_same = (torch.equal(t_w, t_k) and torch.equal(i_w, i_k) and torch.equal(t_wp, t_k) and torch.equal(i_wp, i_k)
                 and torch.equal(vis_k, vis_p))
    vis = vis_k.double()
    k_ms = time_ms(lambda: ck.ray_first_hit(o, d, tris, table))
    dev_ms = device_ms(lambda: ck.ray_first_hit(o, d, tris, table))
    print(f"check first_hit_big on the {label}: {o.shape[0]} rays x {tris.shape[0]} faces ({table[3]}): face "
          f"mismatches {idx_bad}, miss mismatches {inf_bad}, max ulp {ulp}, max |dt| {err:.3e} against the dense "
          f"walk; identical to the plain tree walk, visit counts included, {walk_same}; per ray {float(vis[:, 0].mean()):.1f} "
          f"box tests (max {int(vis[:, 0].max())}) and {float(vis[:, 1].mean()):.2f} leaves of "
          f"{table[3].leaf_faces} faces (max {int(vis[:, 1].max())}); {k_ms:.4f} ms per call (device {dev_ms:.4f} "
          f"ms), dense plain "
          f"{plain_ms:.3f} ms; hits {float(fin.float().mean()):.4f}", flush=True)
    if idx_bad or inf_bad or ulp or not walk_same:
        fail(f"first_hit_big disagrees with its plain version on the {label}")
    if results is not None:
        results["first_hit_big"] = dict(max_abs_err=err, bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                                        ms=k_ms, plain_ms=plain_ms)


def check_small(label: str, o, d, tris, table, results: dict = None) -> dict:
    """K1 small (the walk of the mesh's any-hit tree, staged in shared memory,
    one launch) on the rays `o`, `d` against `tris` (<= 512 faces) and its
    `table` (`first_hit_table`): the kernel against its plain version (the
    dense classic scan: t bits, faces and misses identical, 0 ulp) and its
    plain walk (visit counts included). Where the tree has no always-tested
    rows, the same walk reading the tree through L1/L2 (K7's kernel on it:
    the same rows and leaf test) is held to the same bits and visits and
    timed beside it. Prints the box tests and leaves per ray, the times per
    call and on the device, the dense plain time and the bound of the (ray,
    face) pairs this data needs; with `results`, records K1 small's line from
    this check. Returns {ms, dev_ms, l1_ms, l1_dev_ms} (None where not
    measured)."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    r, f = o.shape[0], tris.shape[0]
    tree = table[3]
    t_k, i_k = ck.ray_first_hit(o, d, tris, table)
    dense = []
    plain_ms = time_ms(lambda: dense.append(ck.ray_first_hit_plain(o, d, tris, table)), reps=1, warm=False)
    t_p, i_p = dense[0]
    t_w, i_w, vis_k = ck.first_hit_walk(o, d, table)
    t_wp, i_wp, vis_p = ck.first_hit_walk_plain(o, d, table)
    walk_same = (torch.equal(t_w, t_k) and torch.equal(i_w, i_k) and torch.equal(t_wp, t_k)
                 and torch.equal(i_wp, i_k) and torch.equal(vis_k, vis_p))
    l1_ms = l1_dev_ms = None
    if tree.always.shape[0] == 0:
        vis_l1 = torch.empty_like(vis_k)
        t_l1, i_l1 = ck.first_hit_tiled(o, d, tree.bvh, vis_l1)
        walk_same = walk_same and torch.equal(t_l1, t_k) and torch.equal(i_l1, i_k) and torch.equal(vis_l1, vis_p)
        l1_call = (lambda: ck.first_hit_tiled(o, d, tree.bvh))
        l1_ms, l1_dev_ms = time_ms(l1_call), device_ms(l1_call)
    torch.cuda.synchronize()
    fin = torch.isfinite(t_p)
    idx_bad = int((i_k != i_p).sum())
    inf_bad = int((torch.isfinite(t_k) != fin).sum())
    ulp = int(ulp_distance(t_k[fin], t_p[fin]).max()) if fin.any() else 0
    err = float((t_k[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0
    vis = vis_p.double()
    call = (lambda: ck.ray_first_hit(o, d, tris, table))
    k_ms, dev_ms = time_ms(call), device_ms(call)
    needed, _ = first_hit_pairs(o, d, t_k, i_k, face_boxes(tris))
    b_ms, b_by = bound_ms(needed * FLOPS_MT_PAIR, r * 24 + f * 36 + r * 8)
    l1 = ("not measured (always-tested rows)" if l1_ms is None else
          f"{l1_ms:.4f} ms (device {l1_dev_ms:.4f} ms), identical, visit counts included")
    print(f"check first_hit_small on the {label}: {r} rays x {f} faces ({tree}): face mismatches {idx_bad}, miss "
          f"mismatches {inf_bad}, max ulp {ulp}, max |dt| {err:.3e} against the dense scan; identical to the plain "
          f"tree walk, visit counts included, {walk_same}; per ray {float(vis[:, 0].mean()):.1f} box tests (max "
          f"{int(vis[:, 0].max())}) and {float(vis[:, 1].mean()):.2f} leaves of {tree.bvh.leaf_faces} faces (max "
          f"{int(vis[:, 1].max())}); {k_ms:.4f} ms per call (device {dev_ms:.4f} ms), staged in shared memory; "
          f"the same walk through L1 (K7's kernel on this tree) {l1}; dense plain {plain_ms:.3f} ms; bound "
          f"{b_ms:.5f} ms ({b_by}, {needed} pairs this data needs, {needed / max(r * f, 1):.3%} of dense); hits "
          f"{float(fin.float().mean()):.4f}", flush=True)
    if idx_bad or inf_bad or ulp or not walk_same:
        fail(f"first_hit_small disagrees with its plain version or its plain walk on the {label}")
    if results is not None:
        results["first_hit_small"] = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, library_ms=None, ms=k_ms,
                                          plain_ms=plain_ms)
    return dict(ms=k_ms, dev_ms=dev_ms, l1_ms=l1_ms, l1_dev_ms=l1_dev_ms)


def small_room_phase(caps, listeners, t_scene: int, results: dict) -> dict:
    """The rlr main path in a room of <= 512 faces, where K1 small takes every
    bounce: one fused MIC scene (the flagship settings: 5,000 rays per
    source, 60 bounces, AmbeoVR, 16 padded sources, 60 s) in
    `scanned_like_room((7, 5, 3), subdivision_levels=1, seed=0)` (432
    faces; the traced mesh is the room itself), launches counted from zero
    around it (K1 small once per bounce, no other first-hit kernel), its
    int16 WAV checked; the scene timed and profiled (K1 small's device time
    per scene); then the scene traced again with its bounces kept (first and
    last of each decimation phase) and K1 small held through `check_small`
    on each, the first recording its line. Returns the scene's launches."""
    from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer, write_wav
    from audiblelight_tpu_torch.render import ScenePlan
    from audiblelight_tpu_torch.rir import raytracer

    dev = listeners.device
    mesh = scanned_like_room((7.0, 5.0, 3.0), subdivision_levels=1, seed=0)
    rend = FusedSceneRenderer.from_mesh(mesh, ENGINE, caps, BUCKETS, N_SOURCES, t_scene, device=dev)
    st = rend.state
    n_faces = st.acoustic_tris.shape[0]
    if n_faces != 432 or not torch.equal(st.acoustic_tris, st.tris):
        fail(f"the small room traces {n_faces} faces, not the room's {st.tris.shape[0]}")
    face_occ = rend.rain_table(caps)
    src, s_idx, m_idx, plan, amb = flagship_inputs(st.tris, np.random.default_rng(200), dev)
    args = (torch.as_tensor(src, device=dev), listeners, face_occ, torch.as_tensor(s_idx, device=dev),
            torch.as_tensor(m_idx, device=dev), ScenePlan.from_numpy(plan, dev), *amb)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    wav = rend.render_mix(torch.Generator(device=dev).manual_seed(300), *args)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = dict(ck.launch_counts)
    peak = int(wav.abs().max())
    path = write_wav(OUT / "small_room.wav", wav, SR)
    print(f"small room: {n_faces} faces, a fused MIC scene in {first_s:.3f} s (host clock, first); "
          f"{path.relative_to(REPO)} {tuple(wav.shape)} {wav.dtype}, peak {peak}; launches {launches}", flush=True)
    if wav.dtype != torch.int16 or tuple(wav.shape) != (4, t_scene) or peak < 100:
        fail(f"small-room scene: payload {wav.dtype} {tuple(wav.shape)}, peak {peak}")
    for name in SMALL_PATH:
        if launches[name] <= 0:
            fail(f"the small-room scene never launched {name}")
    bounces = int(ENGINE["indirect_ray_depth"])
    others = {k: launches[k] for k in KERNELS if k.startswith("first_hit") and k != "first_hit_small" and launches[k]}
    if launches["first_hit_small"] != bounces or others:
        fail(f"the small-room scene launched first_hit_small {launches['first_hit_small']} times (expected "
             f"{bounces}) and {others}")

    def scene():
        rend.render_mix(torch.Generator(device=dev).manual_seed(301), *args)

    scene_ms = time_ms(scene, reps=3)
    avgs, busy = profiled(scene, "small-room scene profile")
    k1 = kernel_times(avgs, ["first_hit_small"], "small room per scene")
    print(f"small-room scene time (CUDA events): median {scene_ms:.3f} ms; device idle share {1 - busy / scene_ms:.1%}; "
          f"first_hit_small per scene {k1.get('first_hit_small', ('not measured', 0))[0]} ms of device time over "
          f"{k1.get('first_hit_small', (0, 0))[1]} launches", flush=True)

    kept = {}
    route = raytracer._first_hit_route

    def keep_bounce(o, d, prev_face, tris, rt):
        keep_first_last(kept, o.shape[0], (o.clone(), d.clone(), tris, rt[0]))
        return route(o, d, prev_face, tris, rt)

    raytracer._first_hit_route = keep_bounce
    try:
        rend.trace(torch.Generator(device=dev).manual_seed(302), *args[:3])
    finally:
        raytracer._first_hit_route = route
    if len(kept) != 3:
        fail(f"the small-room trace ran K1 small at ray counts {sorted(kept)}, expected three decimation phases")
    for rays, pair in sorted(kept.items(), reverse=True):
        for which, (o, d, tris, table) in zip(("first", "last"), pair):
            if table is None or table[0] != "small" or table[3] is not st.any_hit_tree(st.acoustic_tris):
                fail("the small-room trace's first-hit table does not carry the room's cached any-hit tree")
            check_small(f"small-room trace's {which} bounce of {rays} rays", o, d, tris, table,
                        results if "first_hit_small" not in results else None)
    return launches


def count_tree_builds() -> tuple:
    """(builds, restore): every any-hit tree build from now on appends its
    face count to `builds` (the builder under each module's name for it);
    `restore()` puts the builder back."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.ops import star_occlusion as so
    from audiblelight_tpu_torch.worldstate import mesh_backend as mb

    builds, real = [], ck.any_hit_tree

    def counted(tris, faces=None):
        builds.append(int(tris.shape[0]))
        return real(tris, faces)

    modules = (ck, so, mb)
    for m in modules:
        m.any_hit_tree = counted

    def restore():
        for m in modules:
            m.any_hit_tree = real

    return builds, restore


def check_any_hit(name: str, label: str, starts, ends, tris, tree, call, results: dict = None) -> torch.Tensor:
    """K2 (`name` "any_hit") or K6 ("star_any_hit") on the segments starts ->
    ends through `tree`: the kernel's booleans and per-segment visit counts
    equal to the plain walk's (`any_hit_walk_plain`), its booleans to the
    dense plain any-hit over every face of `tris`, 0 mismatches. Prints the
    blocked share, the box tests and leaves per segment, the pairs this data
    needs and the bound on them, the entry point's time per call (`call`)
    and its device part, the plain walk's and the dense plain time; with
    `results`, records the kernel's line from this check. Returns the
    booleans."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    o, d, length = ck.segment_inputs(starts, ends)
    r, f = o.shape[0], tris.shape[0]
    visits = torch.empty((r, 2), dtype=torch.int32, device=o.device)
    got = (ck.any_hit if name == "any_hit" else ck.star_any_hit)(o, d, length, tree, visits)
    walked = []
    walk_ms = time_ms(lambda: walked.append(ck.any_hit_walk_plain(o, d, length, tree)), reps=1, warm=False)
    dense = []
    dense_ms = time_ms(lambda: dense.append(ck.segments_occluded_plain(starts, ends, tris)), reps=1, warm=False)
    torch.cuda.synchronize()
    (walk, vis_p), dense = walked[0], dense[0]
    bad_w, bad_d = int((got != walk).sum()), int((got != dense).sum())
    vis_same = torch.equal(visits, vis_p)
    if not torch.equal(call(), got):
        fail(f"{name}: the entry point and the kernel disagree on the {label}")
    needed = any_hit_pairs(o, d, length, got, tris)
    one_end = name == "star_any_hit"  # K6 reads the starts and one end point
    b_ms, b_by = bound_ms(needed * FLOPS_MT_PAIR, r * (12 if one_end else 24) + (12 if one_end else 0) + f * 36 + r)
    k_ms, dev_ms = time_ms(call), device_ms(call)
    vis = visits.double()
    print(f"check {name} on the {label}: {r} segments x {f} faces ({tree}): mismatches {bad_w} against the plain "
          f"walk, {bad_d} against the dense any-hit; visit counts equal {vis_same}; blocked "
          f"{float(got.float().mean()):.3f}; per segment {float(vis[:, 0].mean()):.1f} box tests (max "
          f"{int(vis[:, 0].max())}) and {float(vis[:, 1].mean()):.2f} leaves of {tree.bvh.leaf_faces} (max "
          f"{int(vis[:, 1].max())}); pairs this data needs {needed} ({needed / max(r * f, 1):.4%} of dense), bound "
          f"{b_ms:.5f} ms ({b_by}); {k_ms:.4f} ms per call (device {dev_ms:.4f} ms), plain walk {walk_ms:.3f} ms, "
          f"dense plain {dense_ms:.3f} ms", flush=True)
    if bad_w or bad_d or not vis_same:
        fail(f"{name} disagrees with its plain walk or the dense any-hit on the {label}")
    if results is not None:
        results[name] = dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, library_ms=None, ms=k_ms,
                             plain_ms=walk_ms)
    return got


def build_ms(build) -> float:
    """Milliseconds of `build()` on the card, host clock around a
    synchronised build (median of three after one)."""
    build()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        build()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return float(np.median(times))


def tree_build_ms(tris, faces=None) -> float:
    """Milliseconds to build `any_hit_tree(tris, faces)` on the card."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    return build_ms(lambda: ck.any_hit_tree(tris, faces))


def table_build_ms(tris) -> float:
    """Milliseconds to build `first_hit_table(tris)` (the big table and its
    face tree) on the card."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    return build_ms(lambda: ck.first_hit_table(tris))


def launch_calls(avgs) -> int:
    """Kernel launches (runtime API calls) in the profiler averages `avgs`."""
    return sum(ev.count for ev in avgs if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))


def call_profile(fn) -> tuple:
    """(kernel launches, host syncs) of one call of `fn` (after a warm-up), by
    the profiler; a sync is a stream synchronisation or a read of a device
    scalar (the device synchronisation that ends the profiled window is
    not counted)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    return launch_calls(avgs), sum(ev.count for ev in avgs
                                   if ev.key in ("cudaStreamSynchronize", "aten::_local_scalar_dense"))


def launches_per_call(fn) -> int:
    """Kernel launches of one call of `fn` (after a warm-up), by the profiler."""
    return call_profile(fn)[0]


def check_walk(name: str, label: str, kernel, walk, dense) -> dict:
    """K7 or K8 (`name`) on one wavefront: `kernel(visits)` launches it once
    ((t, face), the per-ray visit counts written to `visits`), `walk()` is
    its plain walk ((t, face, visits)), `dense()` its dense plain version
    ((t, face)). Fails unless the kernel's t bits, faces and visit counts
    equal the walk's and its t bits and faces the dense version's. Returns
    {t, face, visits, walk_ms, dense_ms, max_abs_err} (the two plain
    versions timed on the calls that are checked; the error is the kernel's
    against the dense version on finite t)."""
    t_k, i_k = kernel(None)
    visits = torch.empty((t_k.shape[0], 2), dtype=torch.int32, device=t_k.device)
    t_v, i_v = kernel(visits)
    walked, dense_out = [], []
    walk_ms = time_ms(lambda: walked.append(walk()), reps=1, warm=False)
    dense_ms = time_ms(lambda: dense_out.append(dense()), reps=1, warm=False)
    (t_w, i_w, vis_w), (t_d, i_d) = walked[0], dense_out[0]
    torch.cuda.synchronize()

    def mismatches(t, i):
        return int(((i != i_k) | (t.view(torch.int32) != t_k.view(torch.int32))).sum())

    bad_v, bad_w, bad_d = mismatches(t_v, i_v), mismatches(t_w, i_w), mismatches(t_d, i_d)
    vis_same = torch.equal(visits, vis_w)
    print(f"check {name} on the {label}: mismatches (t bits or face) {bad_w} against the plain walk, {bad_d} against "
          f"the dense plain version, {bad_v} between its two launches; visit counts equal the plain walk's "
          f"{vis_same}; hits {float((i_k >= 0).float().mean()):.4f}", flush=True)
    if bad_w or bad_d or bad_v or not vis_same:
        fail(f"{name} disagrees with its plain walk or its dense plain version on the {label}")
    fin = torch.isfinite(t_d)
    err = float((t_k[fin] - t_d[fin]).abs().max()) if bool(fin.any()) else 0.0
    return dict(t=t_k, face=i_k, visits=visits, walk_ms=walk_ms, dense_ms=dense_ms, max_abs_err=err)


def k1_phase(xscene, st_x, table_x, surface: tuple, interior: tuple) -> None:
    """K1 big on the full mesh: the exact scene's second and third bounces
    (surface origins, 80k rays; K1 takes no alive mask, so these are also
    the rays of K9's and K10's 45 %-dead wavefront), the 80k interior rays,
    and the exact trace's own wavefront at the bounce with the largest share
    of dead rays (the tracer passes dead rays to K1 too), each through
    `check_k1`."""
    from audiblelight_tpu_torch.rir import raytracer

    kept = []
    bounce = raytracer._bounce

    def keep_dead(gen, state, *args):
        share = float((~state[4]).float().mean())
        if not kept or share > kept[0][2]:
            kept[:] = [(state[0].clone(), state[1].clone(), share)]
        return bounce(gen, state, *args)

    raytracer._bounce = keep_dead
    try:
        xscene.state._irs_device_cache = None
        xscene.state.trace_irs_device()
    finally:
        raytracer._bounce = bounce
    if not kept or kept[0][2] <= 0.0:
        fail("the exact trace never held a dead ray")
    o_dead, d_dead, dead_share = kept[0]
    for label, o, d in (("exact scene's second and third bounces", *surface), ("interior rays", *interior),
                        (f"exact trace's wavefront with {dead_share:.1%} of its rays dead", o_dead, d_dead)):
        check_k1(f"{label} on the full mesh", o, d, st_x.tris, table_x)


def eigenmike_phase(st, scene_inputs: tuple, t_scene: int, win: int) -> dict:
    """The Eigenmike em32 and em64 rigs on the rlr main path: the first
    flagship scene through the fused renderer with each rig at MIC_CENTRE
    (omni capsules: K1 big, K2, K3 at 32 and 64 capsules), written as a 32-
    and a 64-channel int16 WAV, launches counted as for the MIC scene (K1
    big 60 times), timed and profiled; K3 held against its plain version and
    itself on that trace's own bounces (first and last of each decimation
    phase) and timed there; each unoccluded (source, capsule) pair's direct
    arrival within 2 samples of d/c: on the trace's direct component for
    every pair, and on the traced IRs, where the tail can top a far source's
    direct path within 2 ms of it, for 99 % of the pairs (each miss printed
    with the tail's and the direct path's size there). Returns {capsules:
    launch counts}."""
    from audiblelight_tpu_torch.micarrays import Eigenmike32, Eigenmike64
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer, write_wav
    from audiblelight_tpu_torch.render import ScenePlan
    from audiblelight_tpu_torch.rir import raytracer

    dev = st.device
    src, s_idx, m_idx, plan, amb = scene_inputs
    src_t, s_idx_t, m_idx_t = (torch.as_tensor(x, device=dev) for x in (src, s_idx, m_idx))
    out = {}
    for rig in (Eigenmike32, Eigenmike64):
        caps = rig().set_absolute_coordinates(np.array(MIC_CENTRE))
        n = len(caps)
        label = f"Eigenmike{n} scene"
        rend = FusedSceneRenderer(st, n, BUCKETS, N_SOURCES, t_scene, layout="mic")
        lis = torch.as_tensor(caps, dtype=torch.float32, device=dev)
        occ = rend.rain_table(caps)
        splan = ScenePlan.from_numpy(plan, dev)

        def scene(seed=5):
            return rend.render_mix(torch.Generator(device=dev).manual_seed(seed), src_t, lis, occ, s_idx_t, m_idx_t,
                                   splan, *amb)

        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        wav = scene(31)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        out[n] = launches = dict(ck.launch_counts)
        peak = int(wav.abs().max())
        path = write_wav(OUT / f"eigenmike{n}.wav", wav, SR)
        print(f"{label}: {path.relative_to(REPO)} {tuple(wav.shape)} {wav.dtype}, peak {peak}; {first_s:.3f} s "
              f"(host clock, first); rain table {tuple(occ.shape)}; launches {launches}", flush=True)
        if wav.dtype != torch.int16 or tuple(wav.shape) != (n, t_scene) or peak < 100:
            fail(f"{label}: payload {wav.dtype} {tuple(wav.shape)}, peak {peak}")
        for name in MIC_PATH:
            if launches[name] <= 0:
                fail(f"the {label} never launched {name}")
        check_first_hits(launches, 60, f"the {label}")
        scene_ms = time_ms(scene, reps=3)
        avgs, busy = profiled(scene, f"{label} profile")
        print(f"{label} time (CUDA events): median {scene_ms:.3f} ms; device idle share {1 - busy / scene_ms:.1%} "
              f"(profiler busy over CUDA-event time) on {card_line()}")
        kernel_times(avgs, MIC_PATH, f"{label}, per scene")
        kept = {}
        raytracer.deposit_histogram = keep_deposits("deposit_histogram", kept)
        try:
            irs = rend.trace(torch.Generator(device=dev).manual_seed(7), src_t, lis, occ)
        finally:
            raytracer.deposit_histogram = ck.deposit_histogram
        check_deposit_bounces("deposit_histogram", kept, f"Eigenmike{n} trace")
        del kept
        blocked = ck.segments_occluded(lis.repeat(N_SOURCES, 1), src_t.repeat_interleave(n, dim=0),
                                       st.tris).reshape(N_SOURCES, n)
        expect = (torch.linalg.vector_norm(src_t[:, None] - lis[None], dim=-1) / 343.0 * SR).cpu().numpy()
        direct = raytracer.direct_paths_ir(st.tris, src_t, lis, irs.shape[-1], sr=SR)  # (E, C, L)
        ir_ec, dir_ec = irs.transpose(0, 1).cpu().numpy(), direct.cpu().numpy()
        free = ~blocked.cpu().numpy()
        off, off_d, misses = [], [], []
        for e, c in zip(*np.nonzero(free)):
            lo, hi = max(int(expect[e, c]) - win, 0), int(expect[e, c]) + win
            peak_t = lo + int(np.argmax(np.abs(ir_ec[e, c, lo:hi])))
            off.append(abs(peak_t - expect[e, c]))
            off_d.append(abs(lo + int(np.argmax(np.abs(dir_ec[e, c, lo:hi]))) - expect[e, c]))
            if off[-1] > 2.0:
                d_peak = float(np.abs(dir_ec[e, c, lo:hi]).max())
                misses.append(f"source {e} capsule {c} ({expect[e, c] / SR * 343.0:.2f} m): peak "
                              f"{peak_t - expect[e, c]:+.2f} samples off, |IR| there / direct peak "
                              f"{abs(ir_ec[e, c, peak_t]) / d_peak:.3f}, |IR - direct| there / direct peak "
                              f"{abs(ir_ec[e, c, peak_t] - dir_ec[e, c, peak_t]) / d_peak:.3f}")
        print(f"{label} direct paths: {int(free.sum())} of {free.size} (source, capsule) pairs unoccluded; direct "
              f"component: max |peak - d/c| {max(off_d, default=float('nan')):.2f} samples; traced IRs: max |peak "
              f"within 2 ms - d/c| {max(off, default=float('nan')):.2f} samples, off by more than 2 samples for "
              f"{len(misses)} pairs (the tail there outweighing the direct path) {misses}", flush=True)
        if not off or max(off_d) > 2.0 or len(misses) > 0.01 * len(off):
            fail(f"{label}: direct-path arrivals off their distance")
    return out



def ism_terms(rows: int, emitters: int, n_samples: int, order: int) -> int:
    """(listener, emitter, image, bin) terms of one `shoebox_rirs` call."""
    return rows * emitters * 8 * (2 * order + 1) ** 3 * (n_samples // 2 + 1)


def shoebox_phase(fg: Path, out: Path, win: int, dev) -> None:
    """The shoebox backend, the SELD CLI's default: the image-source engine
    on the card against the same function on the CPU (order 4, 8,192
    samples, 4 capsules, 6 sources, 4 bands; omni and FOA; within 1e-5 of
    peak); the direct paths of its order-12, 1 s, 24 kHz IRs in a 7 x 5 x 3 m
    room (omni: each capsule's peak within 2 samples of d/c; FOA: the
    direction at the W peak within 5 degrees; binaural: `check_binaural`,
    the direct component from the same call at order 0 with walls that
    absorb all but 1e-6 of the energy); `seld.main` at its defaults in MIC
    and FOA, two scenes each, its outputs checked, with each scene's CLI
    time and the engine's time (CUDA events), peak device memory, terms and
    bound, and no tracer kernel launched; the engine's device idle share on
    one MIC scene; one MonoCapsule scene through `Scene.generate(compiled=True)`."""
    from audiblelight_tpu_torch import seld
    from audiblelight_tpu_torch import utils as tutils
    from audiblelight_tpu_torch.core import Scene
    from audiblelight_tpu_torch.io.audio import _read_header
    from audiblelight_tpu_torch.micarrays import ambeovr_capsules
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.rir.image_source import shoebox_rirs, wall_log_betas_from_absorption
    from audiblelight_tpu_torch.worldstate import shoebox_backend

    card = card_line()
    rng = np.random.default_rng(9)
    room = np.array([7.0, 5.0, 3.0], np.float32)
    caps = ambeovr_capsules(MIC_CENTRE).astype(np.float32)

    # The engine on the card against the CPU
    src = rng.uniform(0.5, room - 0.5, (6, 3)).astype(np.float32)
    log_beta, bands = wall_log_betas_from_absorption(rng.uniform(0.1, 0.6, (6, 4)))
    for enc, rows in (("omni", 4), ("foa", 1)):
        kw = dict(n_samples=8192, max_order=4, sr=SR, encoding=enc)
        t0 = time.time()
        on_cpu = shoebox_rirs(room, src, caps, log_beta, bands, device="cpu", **kw)
        cpu_s = time.time() - t0
        src_d = torch.as_tensor(src, device=dev)
        on_card = shoebox_rirs(room, src_d, caps, log_beta, bands, **kw)
        gap = float((on_card.cpu() - on_cpu).abs().max() / on_cpu.abs().max())
        ms = time_ms(lambda: shoebox_rirs(room, src_d, caps, log_beta, bands, **kw), reps=3)
        print(f"shoebox_rirs {enc} on the card against the CPU: {tuple(on_card.shape)}, "
              f"{ism_terms(rows, 6, 8192, 4)} terms, max |diff| / peak {gap:.3e}; card {ms:.3f} ms, CPU "
              f"{cpu_s * 1e3:.1f} ms (host clock)", flush=True)
        if gap > 1e-5:
            fail(f"shoebox_rirs {enc}: the card's IRs are {gap:.3e} of peak from the CPU's")

    # Direct paths at the CLI's order, length and rate
    cand = rng.uniform(0.6, room - 0.6, (256, 3))
    src = cand[np.linalg.norm(cand - np.array(MIC_CENTRE), axis=1) >= 1.0][:6].astype(np.float32)
    src_d = torch.as_tensor(src, device=dev)
    log_beta, bands = wall_log_betas_from_absorption(0.3, n_bands=4)
    centre = np.array([MIC_CENTRE], np.float32)
    n = SR

    def ism(lis, enc, order=ISM_ORDER, lb=log_beta):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base, t0 = torch.cuda.memory_allocated(), time.time()
        irs = shoebox_rirs(room, src_d, lis, lb, bands, n_samples=n, max_order=order, sr=SR, encoding=enc)
        torch.cuda.synchronize()
        if order == ISM_ORDER:
            print(f"shoebox_rirs {enc}, {len(src)} sources, order {order}, {n} samples: {time.time() - t0:.3f} s "
                  f"(host clock), peak device memory {(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB",
                  flush=True)
        return irs

    omni = ism(caps, "omni").cpu().numpy()  # (4, E, n)
    expect = np.linalg.norm(src[:, None] - caps[None], axis=-1) / 343.0 * SR  # (E, C)
    off, global_hits = [], 0
    for e in range(len(src)):
        for c in range(4):
            lo = max(int(expect[e, c]) - win, 0)
            off.append(abs(lo + int(np.argmax(np.abs(omni[c, e, lo : int(expect[e, c]) + win]))) - expect[e, c]))
            global_hits += abs(int(np.argmax(np.abs(omni[c, e]))) - expect[e, c]) <= 2.0
    print(f"shoebox direct paths, omni (AmbeoVR, {len(src)} sources, order {ISM_ORDER}, {n} samples, "
          f"{ism_terms(4, len(src), n, ISM_ORDER)} terms): max |peak within 2 ms - d/c| "
          f"{max(off):.2f} samples; the direct path is the IR's peak in {global_hits} of {len(off)}", flush=True)
    if max(off) > 2.0:
        fail("shoebox omni direct paths off their distance")
    foa = ism(centre, "foa").cpu().numpy()
    offs, angles = [], []
    for e in range(len(src)):
        vec = src[e] - centre[0]
        expect_s = np.linalg.norm(vec) / 343.0 * SR
        lo = max(int(expect_s) - win, 0)
        peak_i = lo + int(np.argmax(np.abs(foa[0, e, lo : int(expect_s) + win])))
        offs.append(abs(peak_i - expect_s))
        xyz = foa[1:, e, peak_i] / foa[0, e, peak_i]
        cosang = float(xyz @ vec / (np.linalg.norm(xyz) * np.linalg.norm(vec)))
        angles.append(float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))))
    print(f"shoebox direct paths, FOA: max |W peak - d/c| {max(offs):.2f} samples; max angle of (X, Y, Z)/W at the "
          f"peak to the source {max(angles):.2f} deg", flush=True)
    if max(offs) > 2.0 or max(angles) > 5.0:
        fail("shoebox FOA direct paths off their arrival time or direction")
    direct_lb, _ = wall_log_betas_from_absorption(1.0, n_bands=4)  # beta clipped to 1e-3
    check_binaural(ism(centre, "binaural"), ism(centre, "binaural", order=0, lb=direct_lb), src,
                   np.ones(len(src), bool), win, centre=MIC_CENTRE, label="shoebox binaural")

    # The SELD CLI at its defaults; the engine timed per call inside it
    calls = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        irs = shoebox_rirs(*args, **kwargs)
        b.record()
        b.synchronize()
        rows = args[2].shape[0] if kwargs["encoding"] == "omni" else 1
        calls.append(dict(ms=a.elapsed_time(b), peak=torch.cuda.max_memory_allocated() - base,
                          e=int(args[1].shape[0]), rows=rows,
                          terms=ism_terms(rows, int(args[1].shape[0]), kwargs["n_samples"], kwargs["max_order"])))
        return irs

    t_scene = int(SCENE_SECONDS * SR)
    shutil.rmtree(out, ignore_errors=True)
    cli_s = {}
    shoebox_backend.shoebox_rirs = timed
    try:
        for layout in ("mic", "foa"):
            argv = ["--fg-dir", str(fg), "--output-dir", str(out / layout), "--channel-layout", layout, *SHOEBOX_FLAGS]
            if seld.build_parser().parse_args(argv).backend != "shoebox":
                fail("the SELD CLI's default backend is not the shoebox")
            ck.reset_launch_counts()
            n_calls = len(calls)
            cli_s[layout] = seld.main(argv)
            launched = {k: v for k, v in ck.launch_counts.items() if v}
            for sec, call in zip(cli_s[layout], calls[n_calls:]):
                b_ms = call["terms"] * FLOPS_ISM_TERM / PEAK_FP32 * 1e3
                print(f"shoebox CLI {layout} scene: E = {call['e']} emitters x {call['rows']} listener rows, "
                      f"C.E.K.F = {call['terms']} terms", flush=True)
                print(f"shoebox CLI {layout} scene: {sec:.3f} s (host clock: placement, engine, render, writes); "
                      f"shoebox_rirs {call['ms']:.3f} ms (CUDA events), peak device memory "
                      f"{call['peak'] / 2**30:.3f} GiB, bound {b_ms:.3f} ms (operations: {FLOPS_ISM_TERM} per "
                      f"term at {PEAK_FP32 / 1e12:.0f} TFLOP/s) on {card}", flush=True)
            if len(cli_s[layout]) != 2 or len(calls) - n_calls != 2 or launched:
                fail(f"the shoebox {layout} CLI rendered {len(cli_s[layout])} scenes with "
                     f"{len(calls) - n_calls} engine calls and launched {launched}")
            check_cli_outputs(out / layout, layout, t_scene)
    finally:
        shoebox_backend.shoebox_rirs = shoebox_rirs
    sec = cli_s["mic"] + cli_s["foa"]
    print(f"shoebox CLI scene time: median {np.median(sec):.3f} s (host clock) over {len(sec)} scenes on {card}")

    # The engine's share of the device on one MIC scene, loaded from its JSON
    mscene = Scene.from_json(sorted((out / "mic" / "metadata_dev").rglob("*.json"))[0], device=dev)
    engine_ms = time_ms(mscene.state.get_irs, reps=1)
    _, busy = profiled(mscene.state.get_irs, "shoebox engine profile")
    print(f"shoebox engine on a MIC CLI scene ({mscene.state.num_emitters} emitters): {engine_ms:.3f} ms (CUDA events); "
          f"device idle share {1 - busy / engine_ms:.1%} (profiler busy over CUDA-event time)", flush=True)

    # One MonoCapsule scene through Scene.generate(compiled=True) (the plan path)
    mono_dir = out / "mono"
    mono_dir.mkdir(parents=True)
    tutils.seed_everything(13)
    scene = Scene(duration=SCENE_SECONDS, sample_rate=SR, backend="shoebox", fg_path=fg, max_overlap=2, device=dev,
                  backend_kwargs=dict(dimensions=room.tolist(), max_order=ISM_ORDER, seed=13))
    scene.add_microphone(microphone_type="monocapsule")
    for event_type in ["static"] * N_STATIC + ["moving"]:
        scene.add_event(event_type=event_type, max_place_attempts=100)
    scene.add_ambience(noise="gaussian")
    torch.cuda.synchronize()
    t0 = time.time()
    scene.generate(output_dir=mono_dir, compiled=True)
    mono_s = time.time() - t0
    audio = scene.audio["mic000"]
    names = sorted(p.name for p in mono_dir.iterdir())
    header = _read_header(mono_dir / "audio_out_mic000.wav")
    print(f"MonoCapsule shoebox scene: {len(scene.events)} events ({scene.state.num_emitters} emitters), "
          f"Scene.generate() {mono_s:.3f} s (host clock); audio {audio.shape}, peak "
          f"{float(np.abs(audio).max()):.4f}; WAV header {header[:4]}; wrote {names}", flush=True)
    if (names != ["audio_out_mic000.wav", "metadata_out.json", "metadata_out_mic000.csv"]
            or audio.shape != (1, t_scene) or float(np.abs(audio).max()) * 32768 < 100 or header[:4] != (1, 1, SR, 16)):
        fail("the MonoCapsule shoebox scene's outputs are misshapen or silent")


def measured_room(path: Path, n_az: int, heights, dists, n_taps: int, sr: int, short_name: str,
                  seed: int) -> np.ndarray:
    """Write a SingleRoomSRIR file the size of a converted TAU-SRIR room with
    the port's own writer: sources on `n_az` azimuths x `heights` x `dists`
    around SOFA_LISTENER, the AmbeoVR's 4 capsules, float64 IRs at `sr`, each
    a unit spike at the sample nearest d/c plus a decaying noise tail.
    Returns the (M, 3) measured source positions."""
    from audiblelight_tpu_torch.io.sofa import write_sofa
    from audiblelight_tpu_torch.micarrays import ambeovr_capsules

    az, h, d = np.meshgrid(np.radians(np.arange(n_az) * (360.0 / n_az)), heights, dists, indexing="ij")
    rel = np.stack([d * np.cos(az), d * np.sin(az), h], axis=-1).reshape(-1, 3)
    grid = rel + np.array(SOFA_LISTENER)
    rng = np.random.default_rng(seed)
    irs = rng.standard_normal((len(grid), 4, n_taps))
    irs *= 0.02 * np.exp(-np.arange(n_taps) / (0.05 * sr))
    spike = np.rint(np.linalg.norm(rel, axis=1) / 343.0 * sr).astype(int)
    irs[np.arange(len(grid)), :, spike] = 1.0
    write_sofa(path, irs, grid, SOFA_LISTENER, ambeovr_capsules((0.0, 0.0, 0.0)), sr, listener_short_name=short_name)
    return grid


class PlacementWarnings(logging.Handler):
    """Counts the SELD CLI's "Could not place" warnings by scene (its
    "fold<k>_scene<n>_<scape>" name, from the CLI's "[i/N] split scene n
    scape s" line before them)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.counts, self.scene = {}, None

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        job = re.match(r"\[\d+/\d+\] (\w+) scene (\d+) scape (\d+)", msg)
        if job:
            split, num, scape = job.groups()
            self.scene = f"fold{1 if split == 'train' else 2}_scene{num}_{int(scape):03d}"
        elif msg.startswith("Could not place") and self.scene is not None:
            self.counts[self.scene] = self.counts.get(self.scene, 0) + 1
        elif msg.startswith("No events placed"):  # the CLI builds the scene again
            self.counts.pop(self.scene, None)


def sofa_phase(fg: Path, out: Path, dev) -> None:
    """The SOFA backend through the SELD CLI (`--backend sofa --sofa`), on two
    measured rooms the size of converted TAU-SRIR rooms written with the
    port's own HDF5 writer: MIC (2,160 positions: 360 azimuths x 3 heights x
    2 distances, 4 capsules, 7,200 samples at 24 kHz) and FOA (720
    positions, 14,400 samples at 48 kHz, resampled to the scene's 24 kHz).
    Two 60 s scenes each: the outputs checked as the rlr CLI's; every
    emitter of each scene on the measured grid, its IR's spike within 2
    samples of d/c on every capsule; each static event's DCASE rows at its
    grid point; the host time per scene split into the file's opens and
    reads, `get_irs`, the render and the writes; the peak device memory;
    how `get_irs` read Data.IR; no tracer kernel launched. The CLI runs as
    users run it (its grid unseeded, as the reference script leaves it, and
    the foreground folder in the file system's order), so a scene holds the
    5 events the flags ask for less those its placement warned it dropped,
    and at least one."""
    from audiblelight_tpu_torch import seld
    from audiblelight_tpu_torch.core import Scene
    from audiblelight_tpu_torch.io import sofa as sofa_io
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.utils import cartesian_to_polar, logger
    from audiblelight_tpu_torch.worldstate.sofa_backend import WorldStateSOFA

    card = card_line()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t_scene = int(SCENE_SECONDS * SR)
    # file: every open and read of the SOFA file; get_irs: the rest of
    # get_irs (the resample and the bank); render: the plan path without
    # get_irs; writes: WAV, JSON and CSV
    spent = dict(file=0.0, get_irs=0.0, render=0.0, writes=0.0)
    per_scene, read_modes = [], []

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    def get_irs(self):
        t0, f0 = time.perf_counter(), spent["file"]
        out_irs = real["get_irs"](self)
        spent["get_irs"] += time.perf_counter() - t0 - (spent["file"] - f0)
        spent["render"] -= time.perf_counter() - t0  # get_irs runs inside the render
        read_modes.append(self.ir_read)
        return out_irs

    def write_outputs(*args, **kwargs):
        t0 = time.perf_counter()
        real["write_outputs"](*args, **kwargs)
        spent["writes"] += time.perf_counter() - t0
        per_scene.append(dict(spent))
        for k in spent:
            spent[k] = 0.0

    real = dict(init=sofa_io.SOFAFile.__init__, get_variable=sofa_io.SOFAFile.get_variable,
                attrs=sofa_io.SOFAFile.get_global_attributes, rows=sofa_io.SOFAFile.read_ir_rows,
                get_irs=WorldStateSOFA.get_irs, render=seld.render_scene_audio_compiled,
                write_outputs=seld.write_outputs)
    dropped = PlacementWarnings()
    logger.addHandler(dropped)
    sofa_io.SOFAFile.__init__ = timed(real["init"], "file")
    sofa_io.SOFAFile.get_variable = timed(real["get_variable"], "file")
    sofa_io.SOFAFile.get_global_attributes = timed(real["attrs"], "file")
    sofa_io.SOFAFile.read_ir_rows = timed(real["rows"], "file")
    WorldStateSOFA.get_irs = get_irs
    seld.render_scene_audio_compiled = timed(real["render"], "render")
    seld.write_outputs = write_outputs
    try:
        for layout, n_az, heights, dists, n_taps, file_sr in (
                ("mic", 360, (-0.3, 0.0, 0.3), (1.0, 2.0), 7200, 24000),
                ("foa", 360, (0.0,), (1.0, 2.0), 14400, 48000)):
            path = out / f"room_{layout}.sofa"
            t0 = time.time()
            grid = measured_room(path, n_az, heights, dists, n_taps, file_sr, layout, seed=17)
            write_s = time.time() - t0
            argv = ["--fg-dir", str(fg), "--output-dir", str(out / layout), "--sofa", str(path),
                    "--channel-layout", layout, *SOFA_FLAGS]
            ck.reset_launch_counts()
            per_scene.clear()
            read_modes.clear()
            dropped.counts.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.time()
            seconds = seld.main(argv)
            torch.cuda.synchronize()
            run_s = time.time() - t0
            peak = torch.cuda.max_memory_allocated() - base
            launched = {k: v for k, v in ck.launch_counts.items() if v}
            print(f"SOFA {layout} file: {len(grid)} positions x 4 capsules x {n_taps} samples at {file_sr} Hz, "
                  f"{path.stat().st_size / 1e6:.1f} MB, written in {write_s:.2f} s (host clock); CLI {len(seconds)} "
                  f"scenes in {run_s:.2f} s; peak device memory {peak / 2**30:.3f} GiB; Data.IR read {read_modes}; "
                  f"launches {launched} on {card}", flush=True)
            for sec, parts in zip(seconds, per_scene):
                print(f"SOFA CLI {layout} scene: {sec:.3f} s (host clock): file opens and reads {parts['file']:.3f} s, "
                      f"get_irs without its reads {parts['get_irs']:.3f} s, render {parts['render']:.3f} s, writes "
                      f"{parts['writes']:.3f} s, placement and the rest {sec - sum(parts.values()):.3f} s", flush=True)
            if len(seconds) != 2 or len(per_scene) != 2 or launched or set(read_modes) != {"rows"}:
                fail(f"the SOFA {layout} CLI rendered {len(seconds)} scenes, launched {launched}, read {read_modes}")
            check_cli_outputs(out / layout, layout, t_scene)
            triples = {(round(a), round(e), round(r * 100)) for a, e, r in cartesian_to_polar(grid - SOFA_LISTENER)}
            worst, n_em, n_static = 0.0, 0, 0
            for meta in sorted((out / layout / "metadata_dev").rglob("*.json")):
                scene = Scene.from_json(meta, device=dev)
                pos = np.stack([e.coordinates_absolute for lst in scene.state.emitters.values() for e in lst])
                on_grid = np.abs(pos[:, None] - grid[None]).max(-1).min(-1) < 1e-9
                irs = scene.state.get_irs()["mic000"]  # (4, E, L) at 24 kHz
                expect = np.linalg.norm(pos - SOFA_LISTENER, axis=1) / 343.0 * SR
                peaks = np.abs(irs).argmax(-1)  # (4, E)
                worst = max(worst, float(np.abs(peaks - expect[None]).max()))
                n_em += len(pos)
                if not on_grid.all() or irs.shape != (4, len(pos), round(n_taps * SR / file_sr)):
                    fail(f"SOFA {layout} scene {meta.name}: emitters off the grid or IRs {irs.shape}")
                tracks = {}
                for row in csv.reader(meta.with_name(f"{meta.stem}_mic000.csv").open()):
                    tracks.setdefault((int(row[1]), int(row[2])), set()).add(tuple(int(v) for v in row[3:]))
                static = [p for p in tracks.values() if len(p) == 1]
                n_static += len(static)
                n_dropped = dropped.counts.get(meta.stem, 0)
                if n_dropped:
                    print(f"SOFA {layout} scene {meta.stem}: the CLI warned that it could not place {n_dropped} "
                          "event(s)", flush=True)
                if (not 1 <= len(scene.events) == 5 - n_dropped or not static
                        or not all(p <= triples for p in static)):
                    fail(f"SOFA {layout} scene {meta.name}: {len(scene.events)} events ({n_dropped} dropped with "
                         f"the placement warning), static rows {static} not on the measured grid")
            print(f"SOFA {layout} IRs: {n_em} emitters on the measured grid; max |spike - d/c| {worst:.2f} samples "
                  f"over 4 capsules; {n_static} static tracks in the CSVs at measured points", flush=True)
            if worst > 2.0:
                fail(f"SOFA {layout}: a direct spike {worst:.2f} samples off d/c")
    finally:
        sofa_io.SOFAFile.__init__ = real["init"]
        sofa_io.SOFAFile.get_variable = real["get_variable"]
        sofa_io.SOFAFile.get_global_attributes = real["attrs"]
        sofa_io.SOFAFile.read_ir_rows = real["rows"]
        WorldStateSOFA.get_irs = real["get_irs"]
        seld.render_scene_audio_compiled = real["render"]
        seld.write_outputs = real["write_outputs"]
        logger.removeHandler(dropped)


def fixture_phase() -> None:
    """The port's HDF5 reader on the committed h5py-written fixtures
    (tests/resources/torch_sofa/): every dataset's dtype, shape and sha256,
    and every attribute's value, as digests.json recorded them with h5py;
    the unlimited datasets refused by name."""
    import hashlib

    from audiblelight_tpu_torch.io import hdf5

    def jsonable(v):
        if isinstance(v, bytes):
            return {"bytes": v.hex()}
        if isinstance(v, str):
            return {"str": v}
        arr = np.asarray(v)
        if arr.dtype.kind == "S":
            return {"bytes_array": [x.hex() for x in arr.ravel().tolist()], "shape": list(arr.shape)}
        return {"dtype": arr.dtype.str, "shape": list(arr.shape), "hex": arr.tobytes().hex()}

    root = REPO / "tests" / "resources" / "torch_sofa"
    record = json.loads((root / "digests.json").read_text())
    n_ds = n_attrs = n_refused = 0
    for name, rec in sorted(record.items()):
        with hdf5.File(root / name) as f:
            for ds, want in rec["datasets"].items():
                arr = f[ds][()]
                got = dict(dtype=arr.dtype.str, shape=list(arr.shape), sha256=hashlib.sha256(arr.tobytes()).hexdigest())
                if got != want:
                    fail(f"fixture {name}: {ds} read as {got}, h5py read {want}")
                n_ds += 1
            for obj, attrs in rec["attrs"].items():
                for k, want in attrs.items():
                    if jsonable(f[obj].attrs[k]) != want:
                        fail(f"fixture {name}: attribute {obj}:{k} read as {f[obj].attrs[k]!r}")
                    n_attrs += 1
            for ds, feature in rec["refused"].items():
                try:
                    f[ds][()]
                    fail(f"fixture {name}: {ds} read, expected the {feature} refused")
                except NotImplementedError as err:
                    if f"HDF5 {feature} is not supported" not in str(err):
                        fail(f"fixture {name}: {ds} refused as {err}")
                    n_refused += 1
    print(f"HDF5 fixtures: {len(record)} h5py-written files, {n_ds} datasets equal to h5py's sha256, {n_attrs} "
          f"attributes equal to its values, {n_refused} unlimited datasets refused by name", flush=True)


def head_hrirs(az_deg: np.ndarray, el_deg: np.ndarray) -> np.ndarray:
    """(M, 2, HRIR_TAPS) HRIRs at HRIR_SR of the analytic head: a windowed
    sinc at HRIR_DELAY samples plus each ear's Woodworth offset, scaled by
    the ear's shadow gain averaged over the tail's four bands."""
    from audiblelight_tpu_torch.rir.sh import spherical_head_gains, woodworth_itd

    az, el = np.radians(az_deg), np.radians(el_deg)
    dirs = torch.as_tensor(np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1),
                           dtype=torch.float32)
    itd = woodworth_itd(dirs).numpy()  # (M, 2)
    gain = spherical_head_gains(dirs, np.array([125.0, 500.0, 2000.0, 8000.0])).numpy().mean(-1)  # (M, 2)
    x = np.arange(HRIR_TAPS)[None, None, :] - (HRIR_DELAY + itd * HRIR_SR)[..., None]
    return gain[..., None] * np.sinc(x) * np.where(np.abs(x) < 16, 0.5 + 0.5 * np.cos(np.pi * x / 16), 0.0)


def hrtf_phase(st, scene_inputs: tuple, t_scene: int, win: int, fg: Path, out: Path, dev) -> dict:
    """Measured HRTFs: a SimpleFreeFieldHRIR set written with the port's
    `write_hrtf_sofa` on CIPIC's grid size (1,250 directions x 2 ears x 200
    taps at 44.1 kHz, the analytic head's delays and shadow gains), read
    back at 24 kHz on the card and on the CPU (band powers and
    interpolation weights within 1e-6 relative; indices equal). Then:

    - the first flagship scene through the fused renderer with the measured
      set (the fused path's K1 big, K2 and K5 launches counted and checked),
      written as an int16 WAV; K5 held against its plain version on the
      trace's own bounces; the direct paths checked against each ear's HRIR
      onset plus d/c (`check_binaural`); the scene timed by CUDA events in
      turns with the analytic-head scene of the same inputs, profiled (idle
      share, K5's device time per scene); the per-bounce gather
      `band_power_at` (an 80k x 1,250 product and a top-3) timed;
    - the shoebox with `Binaural(hrtf_sofa=...)` (examples/03_sofa_measured.py
      part 2 at full size: a 60 s scene, order 6, 1.0 s IRs): the engine
      with the measured set on the card against the CPU (order 3, 4,096
      samples; within 1e-5 of peak), then the scene through
      `Scene.generate(compiled=True)`, its engine call timed with its peak device memory
      and bytes per term of its blocks.

    Returns the fused scene's launches."""
    from audiblelight_tpu_torch import utils as tutils
    from audiblelight_tpu_torch.core import Scene
    from audiblelight_tpu_torch.micarrays import Binaural
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer, write_wav
    from audiblelight_tpu_torch.render import ScenePlan
    from audiblelight_tpu_torch.rir import hrtf as hrtf_mod
    from audiblelight_tpu_torch.rir import image_source, raytracer
    from audiblelight_tpu_torch.rir.raytracer import _band_centers
    from audiblelight_tpu_torch.worldstate import shoebox_backend

    card = card_line()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    az, el = np.meshgrid(np.arange(50) * 7.2, np.linspace(-45.0, 80.0, 25), indexing="ij")
    az, el = az.ravel(), el.ravel()
    path = hrtf_mod.write_hrtf_sofa(out / "head.sofa", head_hrirs(az, el), az, el, HRIR_SR)
    hrtf = hrtf_mod.load_hrtf_sofa(path, SR, dev)
    hrtf_cpu = hrtf_mod.load_hrtf_sofa(path, SR, "cpu")
    bands = _band_centers(4, dev)
    bp, bp_cpu = hrtf.band_powers(bands), hrtf_cpu.band_powers(bands.cpu())
    bp_gap = float(((bp.cpu() - bp_cpu).abs() / bp_cpu.abs().clamp_min(1e-30)).max())
    q = torch.randn(80000, 3, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    idx, w = hrtf.interp_weights(q)
    idx_c, w_c = hrtf_cpu.interp_weights(q.cpu())
    w_gap = float(((w.cpu() - w_c).abs() / w_c).max())
    gather_ms = time_ms(lambda: hrtf.band_power_at(q, bp))
    gather_dev = device_ms(lambda: hrtf.band_power_at(q, bp))
    fast = q @ hrtf.dirs.T
    print(f"measured HRTF gather's parts (device): the 80k x {hrtf.dirs.shape[0]} product "
          f"{device_ms(lambda: q @ hrtf.dirs.T):.4f} ms, its candidates' top-k "
          f"{device_ms(lambda: torch.topk(fast, 3 + hrtf_mod.TOP_K_SLACK, dim=-1)):.4f} ms", flush=True)
    del fast
    print(f"measured HRTF set: {tuple(hrtf.hrirs.shape)} at {hrtf.sr} Hz from {path.stat().st_size / 1e6:.2f} MB; "
          f"card against CPU: band powers max rel diff {bp_gap:.3e}, interp_weights on 80k directions: indices "
          f"equal {torch.equal(idx.cpu(), idx_c)}, weights max rel diff {w_gap:.3e}; band_power_at (80k x "
          f"{hrtf.dirs.shape[0]} product, top-3, blend) {gather_ms:.4f} ms per call (device {gather_dev:.4f}) on "
          f"{card}", flush=True)
    if bp_gap > 1e-6 or w_gap > 1e-6 or not torch.equal(idx.cpu(), idx_c):
        fail("the measured set's band powers or interpolation on the card differ from the CPU's")

    # The fused scene with the measured set, beside the analytic head
    src, s_idx, m_idx, plan, amb = scene_inputs
    src_t, s_idx_t, m_idx_t = (torch.as_tensor(x, device=dev) for x in (src, s_idx, m_idx))
    lis_c = torch.tensor([MIC_CENTRE], dtype=torch.float32, device=dev)
    occ_c = st.rain_occlusion_for(np.array([MIC_CENTRE]))
    free_c = ~ck.segments_occluded(lis_c.expand(N_SOURCES, 3).contiguous(), src_t, st.tris).cpu().numpy()
    splan = ScenePlan.from_numpy(plan, dev)
    rend = FusedSceneRenderer(st, 1, BUCKETS, N_SOURCES, t_scene, layout="binaural", hrtf=hrtf)
    analytic = FusedSceneRenderer(st, 1, BUCKETS, N_SOURCES, t_scene, layout="binaural")
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    wav = rend.render_mix(torch.Generator(device=dev).manual_seed(21), src_t, lis_c, occ_c, s_idx_t, m_idx_t,
                          splan, *amb)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = dict(ck.launch_counts)
    peak = int(wav.abs().max())
    wav_path = write_wav(OUT / "binaural_measured.wav", wav, SR)
    print(f"measured-HRTF binaural scene: {wav_path.relative_to(REPO)} {tuple(wav.shape)} {wav.dtype}, peak {peak}; "
          f"{first_s:.3f} s (host clock, first); launches {launches}", flush=True)
    if wav.dtype != torch.int16 or tuple(wav.shape) != (2, t_scene) or peak < 100:
        fail(f"measured-HRTF binaural scene: payload {wav.dtype} {tuple(wav.shape)}, peak {peak}")
    for name in RIG_PATH:
        if launches[name] <= 0:
            fail(f"the measured-HRTF binaural scene never launched {name}")
    if launches["bin_histogram"] != launches["first_hit_big"]:
        fail("the measured-HRTF binaural scene did not fold with K5 once per bounce")
    check_first_hits(launches, 60, "the measured-HRTF binaural scene")

    def scene(r):
        return lambda: r.render_mix(torch.Generator(device=dev).manual_seed(5), src_t, lis_c, occ_c, s_idx_t,
                                    m_idx_t, splan, *amb)

    turns = {"measured": [], "analytic": []}
    for _ in range(2):
        for name, r in (("measured", rend), ("analytic", analytic)):
            turns[name].append(time_ms(scene(r), reps=3))
    avgs, busy = profiled(scene(rend), "measured-HRTF binaural scene profile")
    m_ms = float(np.median(turns["measured"]))
    print(f"measured-HRTF binaural scene time (CUDA events, in turns with the analytic head on the same inputs): "
          f"measured {', '.join(f'{x:.3f}' for x in turns['measured'])} ms, analytic "
          f"{', '.join(f'{x:.3f}' for x in turns['analytic'])} ms; device idle share {1 - busy / m_ms:.1%} on {card}",
          flush=True)
    kernel_times(avgs, RIG_PATH, "measured-HRTF binaural per scene")
    kept5 = {}

    def keep_k5(bins, dep, n_bins):
        keep_first_last(kept5, bins.shape[1], (bins.clone(), dep.clone(), n_bins))
        return ck.bin_histogram(bins, dep, n_bins)

    raytracer.bin_histogram = keep_k5
    try:
        irs = rend.trace(torch.Generator(device=dev).manual_seed(7), src_t, lis_c, occ_c)
    finally:
        raytracer.bin_histogram = ck.bin_histogram
    check_k5_bounces(kept5, "measured-HRTF binaural trace")
    direct = raytracer.direct_paths_ir(st.tris, src_t, lis_c, irs.shape[-1], sr=SR, encoding="binaural", hrtf=hrtf)
    check_binaural(irs, direct.transpose(0, 1), src, free_c, win, label="measured-HRTF binaural",
                   delay0=HRIR_DELAY * SR / HRIR_SR)

    # The shoebox with the measured set: the engine on the card against the CPU
    rng = np.random.default_rng(23)
    room = np.array(HRTF_SHOEBOX["dimensions"], np.float32)
    centre = np.array([[2.4, 2.1, 1.5]], np.float32)
    src_s = rng.uniform(0.5, room - 0.5, (3, 3)).astype(np.float32)
    log_beta, bands_s = image_source.wall_log_betas_from_absorption(rng.uniform(0.1, 0.6, (6, 4)))
    kw = dict(n_samples=4096, max_order=3, sr=SR, encoding="binaural")
    t0 = time.time()
    on_cpu = image_source.shoebox_rirs(room, src_s, centre, log_beta, bands_s, device="cpu", hrtf=hrtf_cpu, **kw)
    cpu_s = time.time() - t0
    src_d = torch.as_tensor(src_s, device=dev)
    on_card = image_source.shoebox_rirs(room, src_d, centre, log_beta, bands_s, hrtf=hrtf, **kw)
    gap = float((on_card.cpu() - on_cpu).abs().max() / on_cpu.abs().max())
    print(f"shoebox_rirs with the measured set on the card against the CPU: {tuple(on_card.shape)}, "
          f"{ism_terms(1, 3, 4096, 3)} terms, max |diff| / peak {gap:.3e}; CPU {cpu_s:.2f} s (host clock)", flush=True)
    if gap > 1e-5:
        fail(f"shoebox_rirs with the measured set: the card's IRs are {gap:.3e} of peak from the CPU's")

    calls = []
    real_rirs = shoebox_backend.shoebox_rirs

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        irs_s = real_rirs(*args, **kwargs)
        b.record()
        b.synchronize()
        n_e, n_f = int(args[1].shape[0]), kwargs["n_samples"] // 2 + 1
        k_img = 8 * (2 * kwargs["max_order"] + 1) ** 3
        e_blk, chunk = image_source.block_shape(1, n_e, n_f, k_img, "hrtf", None, image_source.CARD_LIVE_BYTES)
        calls.append(dict(ms=a.elapsed_time(b), peak=torch.cuda.max_memory_allocated() - base, e=n_e,
                          hrtf=kwargs.get("hrtf") is not None, terms=ism_terms(1, n_e, kwargs["n_samples"],
                                                                               kwargs["max_order"]),
                          block=e_blk * chunk * n_f))
        return irs_s

    tutils.seed_everything(13)
    scene_s = Scene(duration=SCENE_SECONDS, sample_rate=SR, backend="shoebox", fg_path=fg, max_overlap=2, device=dev,
                    backend_kwargs=dict(HRTF_SHOEBOX))
    scene_s.add_microphone(microphone_type=Binaural(hrtf_sofa=str(path)))
    for event_type in ["static"] * N_STATIC + ["moving"]:
        scene_s.add_event(event_type=event_type, max_place_attempts=100)
    scene_s.add_ambience(noise="gaussian")
    ck.reset_launch_counts()
    shoebox_backend.shoebox_rirs = timed
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        (out / "shoebox").mkdir()
        scene_s.generate(output_dir=out / "shoebox", compiled=True)
        gen_s = time.time() - t0
    finally:
        shoebox_backend.shoebox_rirs = real_rirs
    launched = {k: v for k, v in ck.launch_counts.items() if v}
    audio = scene_s.audio["mic000"]
    call = calls[-1] if calls else {}
    print(f"measured-HRTF shoebox scene (order {HRTF_SHOEBOX['max_order']}, {HRTF_SHOEBOX['max_ir_length']} s IRs, "
          f"{scene_s.state.num_emitters} emitters): "
          f"Scene.generate() {gen_s:.3f} s (host clock); shoebox_rirs {call.get('ms', float('nan')):.3f} ms (CUDA "
          f"events), {call.get('terms', 0)} terms, peak device memory {call.get('peak', 0) / 2**30:.3f} GiB, "
          f"{call.get('peak', 0) / max(call.get('block', 1), 1):.1f} B per term of its blocks "
          f"({call.get('block', 0)} terms a block; TERM_BYTES['hrtf'] = {image_source.TERM_BYTES['hrtf']}); audio "
          f"{audio.shape}, peak {float(np.abs(audio).max()):.4f}; launches {launched} on {card}", flush=True)
    if (len(calls) != 1 or not call["hrtf"] or launched or audio.shape != (2, t_scene)
            or float(np.abs(audio).max()) * 32768 < 100):
        fail(f"the measured-HRTF shoebox scene: {len(calls)} engine calls, launches {launched}, audio {audio.shape}")
    return launches


def first_arrival(h: np.ndarray) -> int:
    """The first arrival of an impulse response: the peak within 16 samples
    of its first tap at 20 % of its peak or more (near a wall, reflections
    that arrive together can top the direct path)."""
    h = np.abs(h)
    first = int(np.flatnonzero(h >= 0.2 * h.max())[0])
    return first + int(np.argmax(h[first : first + 16]))


def direct_lag(dry: np.ndarray, audio: np.ndarray) -> int:
    """The first arrival (samples) of a dry stem `dry` from its event's
    start: that of its IR window, deconvolved from the event's audio by
    regularised spectral division."""
    n = len(dry) + len(audio)
    a = np.fft.rfft(audio, n)
    h = np.fft.irfft(np.fft.rfft(dry, n) * np.conj(a) / (np.abs(a) ** 2 + 1e-6 * np.abs(a).max() ** 2), n)
    return first_arrival(h[: len(dry)])


def dry_window(ir: np.ndarray, sr: int, low_ms: float = 5, high_ms: float = 50) -> tuple:
    """(window, its start) of a reference-channel IR as compute_dry_audio cuts
    it: [peak - low, peak + high] around the IR's (signed) peak."""
    peak = int(np.argmax(ir))
    lo, hi = max(peak - int(low_ms * sr / 1000), 0), peak + int(high_ms * sr / 1000)
    win = np.zeros_like(ir)
    win[lo:hi] = ir[lo:hi]
    return win, lo


def stem_correlation(dry: np.ndarray, audio: np.ndarray, win: np.ndarray) -> float:
    """Correlation of a dry stem `dry` (its event's span in the scene) with
    its event's audio convolved with the IR window `win`: the stem
    compute_dry_audio makes, up to its scale."""
    n = len(audio) + len(win) - 1
    want = np.fft.irfft(np.fft.rfft(audio, n) * np.fft.rfft(win, n), n)[: len(dry)]
    got = dry[: len(want)]
    return float(np.dot(got, want) / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))


def classic_phase(mesh, fg: Path, room_obj: Path, out: Path, dev) -> dict:
    """The classic per-event render, `Scene.generate()`'s default, on the
    first flagship MIC scene's settings (the flagship room and engine
    config, AmbeoVR, 60 s at 24 kHz, 4 static and 1 moving event): its IR
    banks simulated to choose one static event with an unoccluded direct
    path (the plain any-hit) that peaks its capsule-0 IR, given
    `ref_ir_channel=0, direct_path_time_ms=(5, 50)`; then the banks dropped
    and `generate()` run, which traces them again from the same point of
    the trace walk (its launches counted: K1 big 60 times, K2 and K3), and
    `generate()` and `generate(compiled=True)` in turns (classic, plan,
    plan, classic) on the same scene and banks, timed by host clock: WAVs
    within 5e-3 of peak of each other, every event's spatial audio not
    silent, the dry stem's direct path (deconvolved from the event's audio)
    within 2 samples of scene_start + d/c, the classic render of the same
    banks on the CPU within 1e-5 of peak of the card's (every event's spatial
    audio and the dry stem); the trace profiled. Then one rlr CLI scene with
    `--pipeline classic --channel-layout foa` (K1 big, K2, K4 counted).
    Returns the phase's launch counts."""
    from audiblelight_tpu_torch import seld, synthesize
    from audiblelight_tpu_torch import utils as tutils
    from audiblelight_tpu_torch.core import Scene
    from audiblelight_tpu_torch.io.audio import wav_read
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    card = card_line()
    t_scene = int(SCENE_SECONDS * SR)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    engine = {k: v for k, v in ENGINE.items() if k != "sample_rate"}
    for seed in range(21, 26):
        tutils.seed_everything(seed)
        scene = Scene(duration=SCENE_SECONDS, sample_rate=SR, backend="rlr", fg_path=fg, max_overlap=3, device=dev,
                      backend_kwargs=dict(mesh=mesh, seed=seed, add_to_context=False, rlr_kwargs=engine))
        scene.add_microphone(microphone_type="ambeovr")
        for event_type in ["static"] * N_STATIC + ["moving"]:
            try:
                scene.add_event(event_type=event_type, max_place_attempts=100)
            except ValueError as err:
                print(f"classic scene: could not place a {event_type} event: {err}")
        scene.add_ambience(noise="gaussian")
        # The banks to choose the dry-stem event on: a trace from the point
        # of the state's trace walk at which generate() will trace them again
        walk = scene.state._trace_count
        torch.cuda.synchronize()
        t0 = time.time()
        scene.state.simulate()
        torch.cuda.synchronize()
        sim_s = time.time() - t0
        bank = scene.state.irs["mic000"]  # (4, E, L) host
        cap0 = scene.state.microphones["mic000"].coordinates_absolute[0]
        tris = scene.state.device_state.tris
        first, dry_event = 0, None
        for event in scene.events.values():
            pos = event.emitters[0].coordinates_absolute
            d_c = float(np.linalg.norm(pos - cap0)) / 343.0 * SR
            free = not bool(ck.segments_occluded_plain(
                torch.tensor(np.array([cap0]), dtype=torch.float32, device=dev),
                torch.tensor(np.array([pos]), dtype=torch.float32, device=dev), tris)[0])
            if (dry_event is None and not event.is_moving and free
                    and abs(int(np.argmax(bank[0, first])) - d_c) <= 2.0):
                dry_event = event
            first += len(event)
        if dry_event is not None and any(e.is_moving for e in scene.events.values()):
            break
        print(f"classic scene seed {seed}: no unoccluded static event whose direct path peaks its IR; placing again")
    else:
        fail("the classic scene found no unoccluded static event whose direct path peaks its IR")
    dry_event.ref_ir_channel, dry_event.direct_path_time_ms = 0, [5, 50]
    print(f"classic scene: {len(scene.events)} events ({scene.state.num_emitters} emitters), trace (simulate) "
          f"{sim_s:.3f} s (host clock); dry stem on {dry_event.alias}", flush=True)

    def generate(compiled: bool, where: Path) -> float:
        if not compiled:
            for event in scene.events.values():
                event.spatial_audio.clear()  # render again (the banks and event audio stay cached)
        where.mkdir(parents=True, exist_ok=True)
        torch.cuda.synchronize()
        t0 = time.time()
        scene.generate(output_dir=where, compiled=compiled)
        torch.cuda.synchronize()
        return time.time() - t0

    # The first generate() is the main path whole: the trace (the same rays
    # as the banks above) and the classic render
    scene.state._irs = scene.state._irs_device_cache = None
    scene.state._trace_count = walk
    secs = {"classic": [], "plan": []}
    ck.reset_launch_counts()
    secs["classic"].append(generate(False, out / "classic"))
    launches = dict(ck.launch_counts)
    print(f"classic scene: launches {launches} (Scene.generate(): the trace and the classic render)", flush=True)
    if np.abs(scene.state.irs["mic000"] - bank).max() > 1e-5 * np.abs(bank).max():
        fail("the classic scene's generate() traced other banks than the first trace")
    bank = scene.state.irs["mic000"]
    for name in MIC_PATH:
        if launches[name] <= 0:
            fail(f"the classic scene never launched {name}")
    check_first_hits(launches, ENGINE["indirect_ray_depth"], "the classic scene")
    events = list(scene.events.values())
    for event in events:
        peak = float(np.abs(event.spatial_audio["mic000"]).max())
        if not peak > 0 or not np.isfinite(event.spatial_audio["mic000"]).all():
            fail(f"classic scene: {event.alias}'s spatial audio is silent or not finite (peak {peak})")
    padded = dry_event._spatial_audio_dry_padded["mic000"]
    dry_tail = padded[round(dry_event.scene_start * SR):]
    lag = direct_lag(dry_tail, dry_event.load_audio())
    d_c = np.linalg.norm(dry_event.emitters[0].coordinates_absolute - scene.state.microphones["mic000"]
                         .coordinates_absolute[0]) / 343.0 * SR
    print(f"classic scene dry stem: {padded.shape} float32, peak {float(np.abs(padded).max()):.3e}; direct path at "
          f"{lag} samples after the event's start, d/c {d_c:.2f}", flush=True)
    if padded.shape != (t_scene,) or padded[: round(dry_event.scene_start * SR)].any() or abs(lag - d_c) > 2.0:
        fail("the classic scene's dry stem is misplaced")
    secs["plan"].append(generate(True, out / "plan"))
    secs["plan"].append(generate(True, out / "plan"))
    secs["classic"].append(generate(False, out / "classic"))
    w_c, _ = wav_read(out / "classic" / "audio_out_mic000.wav")
    w_p, _ = wav_read(out / "plan" / "audio_out_mic000.wav")
    gap = float(np.abs(w_c - w_p).max() / np.abs(w_c).max())
    print(f"classic scene: Scene.generate() {', '.join(f'{s:.3f}' for s in secs['classic'])} s, "
          f"generate(compiled=True) {', '.join(f'{s:.3f}' for s in secs['plan'])} s (host clock, in turns: render and "
          f"writes, banks cached) on {card}; WAVs max |diff| / peak {gap:.3e}", flush=True)
    if w_c.shape != (4, t_scene) or gap > 5e-3:
        fail("the classic and plan renders of the classic scene disagree")

    # The classic render of the same banks on the CPU
    worst, first = 0.0, 0
    t0 = time.time()
    for event in events:
        synthesize.render_event_audio(event, bank[:, first : first + len(event)], "cpu", ref_db=scene.ref_db,
                                      device="cpu")
        first += len(event)
        pairs = [(event.spatial_audio, "spatial audio")] + [(event._spatial_audio_dry, "dry stem")] * (
            event is dry_event)
        for store, what in pairs:
            want = store.pop("cpu")
            gap = float(np.abs(store["mic000"] - want).max() / np.abs(want).max())
            worst = max(worst, gap)
            if gap > 1e-5:
                fail(f"classic scene: {event.alias}'s {what} on the card is {gap:.3e} of peak from the CPU's")
    print(f"classic render on the card against the CPU (the same banks): max |diff| / peak {worst:.3e} over "
          f"{len(events)} events and the dry stem; CPU {time.time() - t0:.2f} s (host clock)", flush=True)

    # Where the classic scene's trace goes
    def trace():
        scene.state._irs_device_cache = None
        scene.state.trace_irs_device()

    trace_ms = time_ms(trace, reps=1, warm=False)
    avgs, busy = profiled(trace, "classic scene trace profile")
    print(f"classic scene trace (CUDA events): {trace_ms:.3f} ms; device idle share {1 - busy / trace_ms:.1%}")
    kernel_times(avgs, MIC_PATH, "classic scene per trace")

    # One rlr CLI scene through the classic render in FOA (K4)
    argv = ["--fg-dir", str(fg), "--output-dir", str(out / "cli"), "--mesh", str(room_obj), "--channel-layout", "foa",
            *CLI_FLAGS, "--n-scenes", "1", "--pipeline", "classic"]
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    cli_s = seld.main(argv)
    torch.cuda.synchronize()
    cli = dict(ck.launch_counts)
    print(f"SELD CLI foa --pipeline classic: {len(cli_s)} scene, host clock {', '.join(f'{x:.3f}' for x in cli_s)} s "
          f"(placement, trace, classic render, writes); launches {cli}", flush=True)
    for name in FOA_PATH:
        if cli[name] <= 0:
            fail(f"the classic FOA CLI run never launched {name}")
    check_first_hits(cli, int(CLI_FLAGS[CLI_FLAGS.index("--ray-depth") + 1]), "the classic FOA CLI run")
    check_cli_outputs(out / "cli", "foa", t_scene, n_scenes=1)
    return launches


# The repo's WAVs under DCASE2025Task4 class folders (the SSSEG script's mapping)
SSSEG_CLASSES = {"femaleSpeech": "Speech", "maleSpeech": "Speech", "musicInstrument": "MusicalKeyboard",
                 "telephone": "AlarmClock"}
SSSEG_FLAGS = []  # the entry's defaults


def ssseg_phase(out: Path, dev) -> None:
    """`python -m audiblelight_tpu_torch.ssseg` at its defaults (10 s FOA
    scenes at 32 kHz, shoebox rooms of random size, image sources to order
    10, 0.5 s IRs, 1-3 static events with dry stems) for two scenes: the
    script's files, the mixtures int16 and the stems float32, each stem
    silent before its event and correlated (>= 0.999) with the event's
    audio through its W IR's window (5 ms before to 50 ms after the IR's
    peak, as compute_dry_audio cuts it), and its first arrival (deconvolved
    from the event's audio) within 2 samples of d/c from the rig's centre
    where that window holds the direct path (a shoebox IR can peak on a
    reflection more than 5 ms after the direct path, and the window then
    leaves it out); each scene's host-clock time split
    into the engine (the image sources), the classic render (less the
    engine) and the writes."""
    from audiblelight_tpu_torch import core, ssseg, synthesize
    from audiblelight_tpu_torch.io.audio import _read_header, wav_read
    from audiblelight_tpu_torch.worldstate.shoebox_backend import WorldStateShoebox

    card = card_line()
    shutil.rmtree(out, ignore_errors=True)
    fg = out / "fg"
    for wav in sorted((REPO / "tests" / "resources" / "soundevents").glob("*/*.wav")):
        (fg / SSSEG_CLASSES[wav.parent.name]).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, fg / SSSEG_CLASSES[wav.parent.name] / wav.name)
    spent = {"engine": 0.0, "render": 0.0, "writes": 0.0}
    scenes = []

    def timed(key, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.time() - t0
            return result
        return call

    saved = (WorldStateShoebox.get_irs, synthesize.render_audio_for_all_scene_events,
             synthesize.generate_scene_audio_from_events, core.write_outputs, ssseg.wav_write, ssseg.generate_scene)
    WorldStateShoebox.get_irs = timed("engine", saved[0])
    synthesize.render_audio_for_all_scene_events = timed("render", saved[1])
    synthesize.generate_scene_audio_from_events = timed("render", saved[2])
    core.write_outputs = timed("writes", saved[3])
    ssseg.wav_write = timed("writes", saved[4])
    ssseg.generate_scene = lambda *args: scenes.append(saved[5](*args)) or scenes[-1]
    try:
        seconds = ssseg.main(["--fg-dir", str(fg), "--output-dir", str(out / "data"), "--n-scenes", "2", *SSSEG_FLAGS])
    finally:
        (WorldStateShoebox.get_irs, synthesize.render_audio_for_all_scene_events,
         synthesize.generate_scene_audio_from_events, core.write_outputs, ssseg.wav_write,
         ssseg.generate_scene) = saved
    if len(seconds) != 2 or len(scenes) != 2 or any(s is None for s in scenes):
        fail(f"the SSSEG entry wrote {len(seconds)} scenes")
    render = spent["render"] - spent["engine"]
    print(f"SSSEG scenes: {', '.join(f'{s:.3f}' for s in seconds)} s (host clock per scene, placement included); "
          f"over both: engine {spent['engine']:.3f} s, classic render less the engine {render:.3f} s, writes "
          f"{spent['writes']:.3f} s, the rest (placement) {sum(seconds) - spent['render'] - spent['writes']:.3f} s "
          f"on {card}", flush=True)
    worst, direct, cut, lowest = 0.0, 0, 0, 1.0
    for i, scene in enumerate(scenes):
        mix = out / "data" / "mixtures" / f"scene_{i:05d}"
        names = sorted(p.name for p in mix.parent.glob(f"{mix.name}*"))
        if names != [f"{mix.name}.json", f"{mix.name}_mic000.csv", f"{mix.name}_mic000.wav"]:
            fail(f"SSSEG scene {i} wrote {names}")
        if _read_header(mix.parent / f"{mix.name}_mic000.wav")[:4] != (1, 4, 32000, 16):
            fail(f"SSSEG scene {i}: the mixture is not a 4-channel 32 kHz int16 WAV")
        centre = scene.state.microphones["mic000"].coordinates_center
        bank = torch.as_tensor(scene.state.irs["mic000"]).cpu().numpy()  # (4, E, L): W first
        for e, (alias, event) in enumerate(scene.events.items()):
            path = out / "data" / "stems" / f"scene_{i:05d}" / f"{alias}_{event.class_label}_mic000_dry.wav"
            header = _read_header(path)
            dry, _ = wav_read(path)
            start = round(event.scene_start * 32000)
            win, lo = dry_window(bank[0, e], 32000)
            corr = stem_correlation(dry[0, start : round(event.scene_end * 32000)], event.load_audio(), win)
            lowest = min(lowest, corr)
            d_c = float(np.linalg.norm(event.emitters[0].coordinates_absolute - centre)) / 343.0 * 32000
            lag = direct_lag(dry[0, start:], event.load_audio()) if d_c >= lo else d_c
            if d_c >= lo:  # the window holds the direct path: the stem starts there
                direct += 1
                worst = max(worst, abs(lag - d_c))
            else:
                cut += 1
            if (header[0] != 3 or header[3] != 32 or dry.shape != (1, 320000) or dry[0, :start].any()
                    or corr < 0.999 or abs(lag - d_c) > 2):
                fail(f"SSSEG scene {i}, {alias}: stem format {header[:4]}, shape {dry.shape}, correlation {corr:.6f} "
                     f"with the windowed convolution, first arrival at {lag} samples, d/c {d_c:.2f}, window from {lo}")
    print(f"SSSEG stems: {direct + cut} float32 dry stems, each the event's audio through its IR window (correlation "
          f">= {lowest:.6f}); {direct} whose window holds the direct path start there (max |first arrival - d/c| "
          f"{worst:.2f} samples); {cut} whose IR peaks more than 5 ms after the direct path (a reflection), so the "
          f"reference's window leaves the direct path out", flush=True)


DEVICE_FX = {"LowpassFilter": "biquad", "HighpassFilter": "biquad", "HighShelfFilter": "biquad",
             "LowShelfFilter": "biquad", "MultibandEqualizer": "biquad", "Compressor": "compress",
             "Limiter": "compress", "SpeedUp": "time_stretch", "PitchShift": "pitch_shift"}
AUG_FLAGS = ["--augmentations", "pitchshift", "speedup", "reverse", "invert", "distortion"]


def correlated(got: np.ndarray, want: np.ndarray) -> tuple:
    """(correlation, |peak difference| / peak) of two signals of one shape."""
    corr = float(np.dot(got.ravel(), want.ravel()) / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-12))
    return corr, abs(float(np.abs(got).max()) - float(np.abs(want).max())) / float(np.abs(want).max())


def fx_against_host(dev) -> None:
    """The torch FX on the card against the host FX at the parameters and
    bounds of the reference's own fx_jax-vs-numpy tests (tests/test_fx_jax.py:
    a 1 s 440 + 3520 Hz tone with noise at 44.1 kHz; a biquad within 2e-4 of
    peak, the compressor within 5e-3, the stretch by correlation > 0.99 and
    peak within 10 %, the pitch shift by its length and the fundamental
    within 15 Hz). At the augmentations' drawn parameters the FFT-sampled
    biquad (the reference's algorithm) can sit further from the recursive
    host filter (e.g. a shelf near Nyquist), so there the gap is printed."""
    from audiblelight_tpu_torch.ops import fx_dsp, fx_torch

    sr = 44100
    t = np.arange(sr) / sr
    tone = (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * np.sin(2 * np.pi * 3520.0 * t)
            + 0.02 * np.random.default_rng(42).standard_normal(sr)).astype(np.float32)
    worst = {}
    for kind, freq, q, gain in (("lowpass", 1000.0, 0.7071, 0.0), ("highpass", 900.0, 0.7071, 0.0),
                                ("peak", 2000.0, 4.0, -12.0), ("lowshelf", 400.0, 0.7071, 9.0),
                                ("highshelf", 5000.0, 0.7071, -9.0)):
        b, a = fx_dsp._biquad_coeffs(kind, sr, freq, q, gain)
        want = fx_dsp.biquad(tone, kind, sr, freq, q, gain)
        worst[kind] = float(np.abs(fx_torch.biquad(tone, b, a, device=dev) - want).max() / np.abs(want).max())
    want = fx_dsp.compress(4 * tone, sr, -20.0, 4.0, 5.0, 100.0)
    worst["compress"] = float(np.abs(fx_torch.compress(4 * tone, sr, -20.0, 4.0, 5.0, 100.0, device=dev) - want).max()
                              / np.abs(want).max())
    stretch = {rate: correlated(fx_torch.time_stretch(tone, rate, device=dev), fx_dsp.time_stretch(tone, rate))
               for rate in (0.75, 1.3)}
    pitch = {}
    for semis in (-5.0, 4.0):
        out = fx_torch.pitch_shift(tone, sr, semis, device=dev)
        spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
        f = np.fft.rfftfreq(len(out), 1 / sr)
        band = (f > 100) & (f < 1000)
        pitch[semis] = (out.shape == tone.shape, float(f[band][np.argmax(spec[band])]), 440.0 * 2 ** (semis / 12.0))
    print(f"torch FX on the card against the host FX at the reference's test parameters: "
          f"{', '.join(f'{k} {v:.2e}' for k, v in worst.items())} (max |diff| / peak); stretch (corr, peak) "
          f"{stretch}; pitch shift (length kept, fundamental, target) {pitch}", flush=True)
    if (any(v > 2e-4 for k, v in worst.items() if k != "compress") or worst["compress"] > 5e-3
            or any(c <= 0.99 or p >= 0.1 for c, p in stretch.values())
            or any(not same or abs(f0 - want) >= 15.0 for same, f0, want in pitch.values())):
        fail("the torch FX on the card are outside the reference's fx_jax-vs-numpy bounds")


def augmentation_phase(fg: Path, out: Path, dev) -> None:
    """The 27 event augmentations on a 5 s event at 24 kHz on the card, each
    with the parameters it draws from one seed: where its FX run in torch
    (the biquads, the compressor and limiter, the time stretch, the pitch
    shift) against the same torch FX on the CPU (1e-5 of peak; the stretch
    and the pitch shift by correlation > 0.99 and peak within 10 %, their
    bound), its gap from the host version printed, timed per call by CUDA
    events beside the host version's host time; the others (host FX on
    every device) equal to the CPU instance's, timed by host clock. The
    torch FX against the host FX at the reference's test parameters
    (`fx_against_host`). Then the shoebox SELD
    CLI at its defaults for two MIC scenes with `--augmentations pitchshift
    speedup reverse invert distortion`, then the same CLI without them, by
    host clock."""
    import random

    from audiblelight_tpu_torch import augmentation as taug
    from audiblelight_tpu_torch import seld
    from audiblelight_tpu_torch.io.audio import load_audio

    card = card_line()
    wav = sorted((REPO / "tests" / "resources" / "soundevents").glob("*/*.wav"))[0]
    audio, _ = load_audio(wav, sr=SR, mono=True, dtype=np.float32)
    audio = np.resize(audio, int(EVENT_SECONDS * SR)).astype(np.float32)
    rows = []
    for i, cls in enumerate(taug.ALL_EVENT_AUGMENTATIONS):
        name = cls.__name__
        np.random.seed(i)
        on_card = cls(sample_rate=SR, device=dev)
        on_cpu = taug.EventAugmentation.from_dict(on_card.to_dict(), device="cpu")

        def run(aug):
            random.seed(100)  # the TimeWarp classes' per-frame draws
            return aug(audio)

        got, host = run(on_card), run(on_cpu)
        if got.shape != audio.shape or not np.isfinite(got).all():
            fail(f"augmentation {name} on the card: {got.shape}, finite {np.isfinite(got).all()}")
        if name not in DEVICE_FX:
            t_host = []
            for _ in range(3):
                t0 = time.perf_counter()
                run(on_card)
                t_host.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(got, host):
                fail(f"augmentation {name} (host FX) differs between its card and CPU instances")
            rows.append(f"{name}: host FX, {np.median(t_host):.3f} ms per call (host clock)")
            continue
        kind = DEVICE_FX[name]
        saved = taug._on_card
        taug._on_card = lambda device: True  # the torch FX, on the CPU instance's device
        try:
            torch_cpu = run(on_cpu)
        finally:
            taug._on_card = saved
        card_ms = time_ms(lambda: run(on_card), reps=5)
        t0 = time.perf_counter()
        run(on_cpu)
        host_ms = (time.perf_counter() - t0) * 1e3
        gap = float(np.abs(got - torch_cpu).max() / np.abs(torch_cpu).max())
        gap_host = float(np.abs(got - host).max() / np.abs(host).max())
        corr_h, dpeak_h = correlated(got, host)
        if kind in ("time_stretch", "pitch_shift"):
            corr, dpeak = correlated(got, torch_cpu)
            ok = corr > 0.99 and dpeak < 0.1
            note = f"against torch on the CPU corr {corr:.6f}, peak {dpeak:.2e}, max |diff| / peak {gap:.2e}"
        else:
            ok = gap <= 1e-5
            note = f"against torch on the CPU max |diff| / peak {gap:.2e} (bound 1e-5)"
        note += f"; against the host FX max |diff| / peak {gap_host:.2e}, corr {corr_h:.6f}, peak {dpeak_h:.2e}"
        rows.append(f"{name}: torch FX ({kind}) {card_ms:.3f} ms per call (CUDA events, numpy in and out), host "
                    f"version {host_ms:.3f} ms (host clock); {note}")
        if not ok:
            fail(f"augmentation {name}: {note}")
    print(f"augmentations on a {EVENT_SECONDS:.0f} s event at {SR} Hz on {card}:", flush=True)
    for row in rows:
        print(f"  {row}")
    fx_against_host(dev)

    # The shoebox SELD CLI with and without augmentations, in turns
    secs = {"augmented": [], "plain": []}
    shutil.rmtree(out, ignore_errors=True)
    for turn, augmented in enumerate((True, False)):
        key = "augmented" if augmented else "plain"
        argv = ["--fg-dir", str(fg), "--output-dir", str(out / f"{key}{turn}"), "--channel-layout", "mic",
                *SHOEBOX_FLAGS] + (AUG_FLAGS if augmented else [])
        secs[key] += seld.main(argv)
        meta = sorted((out / f"{key}{turn}" / "metadata_dev").rglob("*.json"))
        n_aug = sum(len(e["augmentations"]) for m in meta for e in json.loads(m.read_text())["events"].values())
        if len(meta) != 2 or (n_aug > 0) != augmented:
            fail(f"the shoebox CLI run {key} wrote {len(meta)} scenes with {n_aug} augmentations")
        check_cli_outputs(out / f"{key}{turn}", "mic", int(SCENE_SECONDS * SR))
    print(f"shoebox CLI mic, 2 scenes a run, one run each after the other: with --augmentations "
          f"{', '.join(f'{s:.3f}' for s in secs['augmented'])} s, without {', '.join(f'{s:.3f}' for s in secs['plain'])} "
          f"s (host clock per scene: placement, engine, augmentations, render, writes) on {card}", flush=True)


# The pooled SELD driver: the serial CLI's host time (with and without the
# host BVH, and in one batch), then 8 scenes with 1 worker against 4 workers
# in batches of 4
POOLED_SCENES = 8
BREAKDOWN_SCENES = 4
POOLED_WORKERS = 4
POOLED_BATCH = 4
N_BATCH = 4  # scenes per batched render in the batch-against-single checks


def host_bvh_check(mesh, dev) -> None:
    """The host BVH (`WorldStateRLR.native_bvh`) must be built; on 10,000
    random points and 1,000 segments in the flagship room its booleans equal
    the card's queries and its distances are within 1e-5 m of them; per-call
    host times beside the card's at placement's batch sizes."""
    from audiblelight_tpu_torch.geometry.native import lib_path
    from audiblelight_tpu_torch.geometry.queries import nearest_surface_distance, points_inside_mesh
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.worldstate.mesh_backend import WorldStateRLR

    t0 = time.time()
    ws = WorldStateRLR(mesh, device=dev, add_to_context=False)
    bvh = ws.native_bvh
    if bvh is None:
        fail("the host BVH was not built (g++ or the library failed)")
    print(f"host BVH: {lib_path().relative_to(REPO)} over {bvh.n_tris} faces, built and loaded in "
          f"{time.time() - t0:.3f} s (host clock, the library's build included)", flush=True)
    rng = np.random.default_rng(3)
    lo, hi = mesh.bounds
    pts = rng.uniform(lo - 0.2, hi + 0.2, (10_000, 3)).astype(np.float32)
    starts = rng.uniform(lo, hi, (1_000, 3)).astype(np.float32)
    ends = rng.uniform(lo, hi, (1_000, 3)).astype(np.float32)
    st = ws.device_state
    tree = st.any_hit_tree(st.tris)
    p_t, s_t, e_t = (torch.as_tensor(x, device=dev) for x in (pts, starts, ends))
    inside_c = points_inside_mesh(p_t, st.tris).cpu().numpy()
    near_c = nearest_surface_distance(p_t, st.tris).cpu().numpy()
    occ_c = ck.segments_occluded(s_t, e_t, st.tris, tree).cpu().numpy()
    inside_h, near_h, occ_h = bvh.contains(pts), bvh.nearest_surface_distance(pts), bvh.segments_occluded(starts, ends)
    gap = float(np.abs(near_h - near_c).max())
    bad = int((inside_h != inside_c).sum()), int((occ_h != occ_c).sum())
    print(f"host BVH against the card's queries: point in mesh {bad[0]} of 10,000 differ ({int(inside_h.sum())} "
          f"inside), segments {bad[1]} of 1,000 differ ({int(occ_h.sum())} blocked), nearest-surface distance max "
          f"gap {gap:.3e} m", flush=True)
    if any(bad) or gap > 1e-5:
        fail("the host BVH disagrees with the card's queries")

    def host_ms(fn, reps: int = 20) -> float:
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e3

    def card_ms(fn, reps: int = 5) -> float:  # host clock of a query whose answer the host reads
        return host_ms(lambda: fn().cpu(), reps)

    for n in (1, 100, 10_000):
        h_in = host_ms(lambda: bvh.contains(pts[:n]))
        h_near = host_ms(lambda: bvh.nearest_surface_distance(pts[:n]))
        c_in = card_ms(lambda: points_inside_mesh(p_t[:n], st.tris))
        c_near = card_ms(lambda: nearest_surface_distance(p_t[:n], st.tris))
        print(f"host BVH per call at {n} points: point in mesh {h_in:.4f} ms (card {c_in:.4f} ms), nearest surface "
              f"{h_near:.4f} ms (card {c_near:.4f} ms); host clock, the card's with its read", flush=True)
    for n in (1, 1_000):
        h_occ = host_ms(lambda: bvh.segments_occluded(starts[:n], ends[:n]))
        c_occ = card_ms(lambda: ck.segments_occluded(s_t[:n].contiguous(), e_t[:n].contiguous(), st.tris, tree))
        print(f"host BVH per call at {n} segments: occluded {h_occ:.4f} ms (card K2 {c_occ:.4f} ms)", flush=True)


def batch_check(renderer, scenes: list, label: str, path: tuple) -> None:
    """`render_mix_batch` of N_BATCH flagship scenes against `render_mix` of
    each with the same seeds (int16 within 1 LSB); K3 or K4 with a scene
    axis on the batched trace's own bounces against per-scene launches (bit
    for bit), the n_scenes = 1 form against the one-scene form (bit for
    bit) and its plain version (`check_deposit`); launches per bounce of the
    batched trace against one scene's, scene time per scene by CUDA events
    and the device idle share."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.render import ScenePlan
    from audiblelight_tpu_torch.rir import raytracer

    dev, st = renderer.device, renderer.state
    seeds = [2000 + i for i in range(N_BATCH)]
    singles_in = []
    for seed, (src, caps, s_idx, m_idx, plan, amb) in zip(seeds, scenes):
        lis = torch.as_tensor(caps if renderer.encoding == "omni" else np.mean(caps, 0, keepdims=True),
                              dtype=torch.float32, device=dev)
        singles_in.append((seed, torch.as_tensor(src, device=dev), lis, renderer.rain_table(caps),
                           torch.as_tensor(s_idx, device=dev), torch.as_tensor(m_idx, device=dev),
                           ScenePlan.from_numpy(plan, dev), amb))
    batch_in = [(seed, src, (caps if renderer.encoding == "omni" else np.mean(caps, 0, keepdims=True)),
                 renderer.rain_table(caps), s_idx, m_idx)
                for seed, (src, caps, s_idx, m_idx, _, _) in zip(seeds, scenes)]
    plans = [sc[4] for sc in scenes]
    extras = [sc[5] for sc in scenes]

    def single(i):
        seed, *args, plan, amb = singles_in[i]
        return renderer.render_mix(torch.Generator(device=dev).manual_seed(seed), *args, plan, *amb)

    def batch():
        return renderer.render_mix_batch(batch_in, plans, extras)

    ck.reset_launch_counts()
    got = batch()
    torch.cuda.synchronize()
    launches = dict(ck.launch_counts)
    want = [single(i) for i in range(N_BATCH)]
    gaps = [int((got[i].int() - want[i].int()).abs().max()) for i in range(N_BATCH)]
    print(f"{label} batch of {N_BATCH}: render_mix_batch against render_mix of each scene, max "
          f"{max(gaps)} LSB ({gaps}), bit for bit {all(torch.equal(got[i], want[i]) for i in range(N_BATCH))}; "
          f"launches {launches}", flush=True)
    if max(gaps) > 1 or any(int(w.abs().max()) < 100 for w in want):
        fail(f"{label}: the batch differs from its scenes rendered alone by more than 1 LSB, or is silent")
    for name in path:
        if launches[name] <= 0:
            fail(f"the {label} batch never launched {name}")
    check_first_hits(launches, 60, f"the {label} batch")

    # Launches per bounce: the batched trace's against one scene's, by the profiler
    gens = lambda: [torch.Generator(device=dev).manual_seed(s) for s in seeds]  # noqa: E731
    src_b = torch.stack([x[1] for x in singles_in])
    lis_b = torch.stack([x[2] for x in singles_in])
    occ_b = torch.stack([x[3] for x in singles_in])
    n_bounces = []
    bounce = raytracer._bounce

    def counted(draws, state, *args):
        n_bounces[-1] += 1
        return bounce(draws, state, *args)

    raytracer._bounce = counted
    try:
        per = {}
        for what, fn in (("one scene", lambda: renderer.trace(torch.Generator(device=dev).manual_seed(seeds[0]),
                                                               *singles_in[0][1:4])),
                         (f"batch of {N_BATCH}", lambda: st.trace_rirs_batch(gens(), src_b, lis_b, renderer.encoding,
                                                                             occ_b, None))):
            n_bounces.append(0)
            fn()
            torch.cuda.synchronize()
            b = n_bounces[-1]
            n, syncs = call_profile(fn)
            per[what] = (n, b, syncs)
    finally:
        raytracer._bounce = bounce
    print(f"{label} trace launches: " + "; ".join(f"{w} {n} over {b} bounces ({n / b:.1f} a bounce), host syncs "
                                                  f"{s}" for w, (n, b, s) in per.items()), flush=True)

    one_ms = time_ms(lambda: single(0), reps=3)
    batch_ms = time_ms(batch, reps=3)
    _, busy_one = profiled(lambda: single(0), f"{label} one scene profile")
    _, busy_b = profiled(batch, f"{label} batch profile")
    print(f"{label} scene time (CUDA events): one scene {one_ms:.3f} ms, batch of {N_BATCH} {batch_ms:.3f} ms = "
          f"{batch_ms / N_BATCH:.3f} ms a scene ({one_ms * N_BATCH / batch_ms:.2f}x); device idle share one scene "
          f"{1 - busy_one / one_ms:.1%}, batch {1 - busy_b / batch_ms:.1%} on {card_line()}", flush=True)

    # K3 / K4 with a scene axis on the batched trace's own bounces
    name = "deposit_histogram" if renderer.encoding == "omni" else "deposit_histogram_foa"
    kept = {}
    setattr(raytracer, name, keep_deposits(name, kept))
    try:
        st.trace_rirs_batch(gens(), src_b, lis_b, renderer.encoding, occ_b, None)
    finally:
        setattr(raytracer, name, getattr(ck, name))
    kernel = getattr(ck, name)
    for rays, bounces in sorted(kept.items(), reverse=True):
        for which, (args, kw) in zip(("first", "last"), bounces):
            hit, normal, e_refl, dist, occ, lis = args
            if lis.dim() != 3 or lis.shape[0] != N_BATCH:
                fail(f"{name} in the batched trace took listener points {tuple(lis.shape)}")
            h = kernel(*args, **kw)
            n = hit.shape[0] // N_BATCH
            per_scene = kw["n_sources"] // N_BATCH
            parts = [kernel(hit[b * n:(b + 1) * n], normal[b * n:(b + 1) * n], e_refl[b * n:(b + 1) * n],
                            dist[b * n:(b + 1) * n], occ[:, b * n:(b + 1) * n].contiguous(), lis[b],
                            **dict(kw, n_sources=per_scene)) for b in range(N_BATCH)]
            one = kernel(hit[:n], normal[:n], e_refl[:n], dist[:n], occ[:, :n].contiguous(), lis[:1],
                         **dict(kw, n_sources=per_scene))
            same = torch.equal(h, torch.cat(parts))
            print(f"{name} at n_scenes = {N_BATCH}, the batched {label} trace's {which} bounce of {rays} rays: "
                  f"equal to {N_BATCH} one-scene launches bit for bit {same}; the n_scenes = 1 form equal to the "
                  f"one-scene form {torch.equal(one, parts[0])}", flush=True)
            if not same or not torch.equal(one, parts[0]):
                fail(f"{name} with a scene axis differs from its one-scene launches")
    check_deposit_bounces(name, kept, f"batched {label} trace (n_scenes = {N_BATCH})")


def pooled_inputs(st, dev) -> list:
    """N_BATCH flagship scenes for the batch checks, each with its own
    AmbeoVR position: (sources, capsules, s_idx, m_idx, host plan, ambience)."""
    from audiblelight_tpu_torch.micarrays import ambeovr_capsules

    out = []
    for i in range(N_BATCH):
        src, s_idx, m_idx, plan, amb = flagship_inputs(st.tris, np.random.default_rng(300 + i), dev)
        centre = np.array(MIC_CENTRE) + np.array([0.25, -0.2, 0.1]) * np.array([i % 2, i // 2, i % 3])
        out.append((src, ambeovr_capsules(tuple(centre)), s_idx, m_idx, plan, amb))
    return out


def breakdown_main(mode: str, fg: str, room_obj: str, out: str) -> int:
    """The serial rlr CLI (MIC, --seed 7, BREAKDOWN_SCENES flagship scenes,
    one render per scene) with its host time split by stage: room state,
    host BVH build, placement, plan build, rain table, render, writes. Run in
    a process of its own; mode "nobvh" takes the host BVH away
    (`WorldStateRLR.native_bvh` patched to None), so that placement runs on
    the card; mode "batched" renders the scenes in one batch
    (`--fused-batch BREAKDOWN_SCENES`, `render_mix_batch`). Prints one JSON
    line last: seconds per stage, calls per stage and this run's kernel
    launches."""
    import threading

    sys.path.insert(0, str(REPO))
    from audiblelight_tpu_torch import pipeline, seld
    from audiblelight_tpu_torch.geometry import native
    from audiblelight_tpu_torch.ops import build
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.worldstate import mesh_backend

    build.build_all()
    if mode == "nobvh":
        mesh_backend.WorldStateRLR.native_bvh = property(lambda self: None)
    local = threading.local()
    spent: dict = {}
    counts: dict = {}

    def timed(stage: str, fn, sync: bool = True):
        """`fn` with its exclusive host-clock seconds added to `stage`,
        synchronised after each call where the stage runs device work."""
        def run(*a, **k):
            stack = local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if sync:
                    torch.cuda.synchronize()
                total = time.perf_counter() - t0
                inner = stack.pop()
                spent[stage] = spent.get(stage, 0.0) + total - inner
                counts[stage] = counts.get(stage, 0) + 1
                if stack:
                    stack[-1] += total
        return run

    seld.build_scene = timed("placement", seld.build_scene)
    pipeline.build_scene_plan = timed("plan build", pipeline.build_scene_plan)
    mesh_backend.MeshDeviceState.from_mesh = classmethod(
        timed("room state", mesh_backend.MeshDeviceState.from_mesh.__func__))
    mesh_backend.MeshDeviceState.rain_occlusion_for = timed(
        "rain table", mesh_backend.MeshDeviceState.rain_occlusion_for)
    native.NativeBVH.__init__ = timed("host BVH build", native.NativeBVH.__init__)
    pipeline.FusedSceneRenderer.render_scene = timed("render", pipeline.FusedSceneRenderer.render_scene)
    pipeline.FusedSceneRenderer.render_mix_batch = timed("render (batch)",
                                                         pipeline.FusedSceneRenderer.render_mix_batch)
    seld.write_outputs = timed("writes", seld.write_outputs, sync=False)  # the completion thread's
    batch = BREAKDOWN_SCENES if mode == "batched" else 1
    argv = ["--fg-dir", fg, "--output-dir", out, "--mesh", room_obj, "--channel-layout", "mic",
            *cli_flags(BREAKDOWN_SCENES), "--fused-batch", str(batch)]
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    seconds = seld.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.launch_counts)
    print(f"rlr CLI breakdown ({mode}): {len(seconds)} scenes in {wall:.3f} s; per scene (placement to writes) "
          f"{', '.join(f'{x:.3f}' for x in seconds)} s", flush=True)
    for stage, sec in sorted(spent.items(), key=lambda kv: -kv[1]):
        print(f"rlr CLI breakdown ({mode}): {stage} {sec:.3f} s over {counts[stage]} calls, "
              f"{sec / len(seconds):.3f} s a scene", flush=True)
    print(f"rlr CLI breakdown ({mode}): launches {launches}", flush=True)
    print(json.dumps(dict(mode=mode, wall_s=wall, scene_s=seconds, stages=spent, calls=counts, launches=launches)))
    return 0


def cli_flags(n_scenes: int) -> list:
    """CLI_FLAGS with `n_scenes` train scenes."""
    flags = list(CLI_FLAGS)
    flags[flags.index("--n-scenes") + 1] = str(n_scenes)
    return flags + ["--train-frac", "1.0"]


def card_probe_builder():
    """A `ScenePrepPool` builder whose tasks report what a worker process
    sees of the card: (CUDA_VISIBLE_DEVICES, torch.cuda.is_available(),
    torch.cuda.device_count())."""
    import os

    def prep(index: int, seed: int) -> tuple:
        return os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.is_available(), torch.cuda.device_count()

    return prep


def pooled_phase(mesh, st, fg: Path, room_obj: Path, out: Path, dev) -> dict:
    """The pooled SELD driver and what stands behind it: the host BVH, the
    batched renders (MIC: K3, FOA: K4) against one scene at a time, the
    serial rlr CLI's host time by stage with and without the host BVH, and
    in one batch of BREAKDOWN_SCENES (each in a process of its own; the
    batch's files against the single renders'), and the pooled CLI
    (POOLED_SCENES MIC scenes, --seed 7) with 1 worker in single renders
    against POOLED_WORKERS workers in batches of POOLED_BATCH (`--placement-
    workers 0` is the serial loop, whose scenes are not the pooled
    driver's): CSVs byte-identical, JSONs byte-identical but for the
    creation-time line, WAVs within 1 LSB, throughput and the stats
    breakdown. Returns the launches of the pooled run with POOLED_WORKERS and
    the stats of the run with 1 worker."""
    import os

    from audiblelight_tpu_torch import seld
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer
    from audiblelight_tpu_torch.prep import ScenePrepPool

    with ScenePrepPool("chip_smoke:card_probe_builder", {}, workers=2) as pool:
        seen = list(pool.imap([(0, 0), (1, 0)]))
    print(f"pool workers see of the card (CUDA_VISIBLE_DEVICES, is_available, device_count): {seen}", flush=True)
    if any(available or count for _, available, count in seen):
        fail("a scene-prep worker sees the card")
    host_bvh_check(mesh, dev)
    scenes = pooled_inputs(st, dev)
    t_scene = int(SCENE_SECONDS * SR)
    batch_check(FusedSceneRenderer(st, 4, BUCKETS, N_SOURCES, t_scene, layout="mic"), scenes, "MIC", MIC_PATH)
    batch_check(FusedSceneRenderer(st, 1, BUCKETS, N_SOURCES, t_scene, layout="foa"), scenes, "FOA", FOA_PATH)
    del scenes

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for mode in ("bvh", "nobvh", "batched"):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--cli-breakdown", mode, str(fg),
                               str(room_obj), str(out / f"serial_{mode}")], capture_output=True, text=True,
                              timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("rlr CLI breakdown")]
        print("\n".join(lines), flush=True)
        if proc.returncode != 0 or not proc.stdout.strip():
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            fail(f"the serial CLI breakdown ({mode}) failed with {proc.returncode}")
        check_cli_outputs(out / f"serial_{mode}", "mic", t_scene, BREAKDOWN_SCENES)
    # The CLI's default batch: one render_mix_batch of the 4 scenes, its
    # launches read from that run alone, its files the single renders'
    batched = json.loads(proc.stdout.strip().splitlines()[-1])
    if batched["calls"].get("render (batch)") != 1 or batched["calls"].get("render"):
        fail(f"the serial CLI at --fused-batch {BREAKDOWN_SCENES} rendered {batched['calls']}")
    for name in MIC_PATH:
        if batched["launches"][name] <= 0:
            fail(f"the serial CLI at --fused-batch {BREAKDOWN_SCENES} never launched {name}")
    if not 0 < batched["launches"]["first_hit_big"] <= 60:
        fail(f"the serial CLI's batch launched first_hit_big {batched['launches']['first_hit_big']} times")
    compare_cli_outputs(out / "serial_bvh", out / "serial_batched", f"serial CLI, --fused-batch 1 and "
                        f"{BREAKDOWN_SCENES}", 3 * BREAKDOWN_SCENES)

    runs = {}
    for workers, batch in ((1, 1), (POOLED_WORKERS, POOLED_BATCH)):
        argv = ["--fg-dir", str(fg), "--output-dir", str(out / f"pooled_w{workers}"), "--mesh", str(room_obj),
                "--channel-layout", "mic", *cli_flags(POOLED_SCENES), "--placement-workers", str(workers),
                "--fused-batch", str(batch)]
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        stats: dict = {}
        stats["scene_seconds"] = seld.main(argv, stats=stats)
        torch.cuda.synchronize()
        launches = dict(ck.launch_counts)
        runs[workers] = launches, stats
        n = stats["n_scenes"]
        print(f"pooled CLI, {workers} workers, batches of {batch}: {n} scenes in {stats['wall_s']:.3f} s = "
              f"{n / stats['wall_s']:.3f} scenes/s, {n * SCENE_SECONDS / stats['wall_s']:.1f} scene-seconds/s, "
              f"{stats['wall_s'] / n:.3f} s a scene; stats "
              f"{ {k: round(v, 3) for k, v in stats.items() if k.endswith('_s')} }; os.cpu_count() "
              f"{os.cpu_count()}; launches {launches} on {card_line()}", flush=True)
        if n != POOLED_SCENES:
            fail(f"the pooled CLI rendered {n} scenes")
        for name in MIC_PATH:
            if launches[name] <= 0:
                fail(f"the pooled CLI ({workers} workers) never launched {name}")
        if not 0 < launches["first_hit_big"] <= 60 * POOLED_SCENES:
            fail(f"the pooled CLI launched first_hit_big {launches['first_hit_big']} times")
        check_cli_outputs(out / f"pooled_w{workers}", "mic", t_scene, POOLED_SCENES)
    compare_cli_outputs(out / "pooled_w1", out / f"pooled_w{POOLED_WORKERS}",
                        f"pooled CLI, 1 and {POOLED_WORKERS} workers", 3 * POOLED_SCENES)
    return runs[POOLED_WORKERS][0], runs[1][1]


def compare_cli_outputs(a_dir: Path, b_dir: Path, label: str, n_files: int) -> None:
    """Two CLI runs of the same scenes wrote the same `n_files` files: CSVs
    byte-identical, JSONs byte-identical but for the creation-time line,
    WAVs within 1 LSB."""
    from audiblelight_tpu_torch.io.audio import wav_read

    files = sorted(p.relative_to(a_dir) for p in a_dir.rglob("*") if p.is_file())
    if len(files) != n_files or files != sorted(p.relative_to(b_dir) for p in b_dir.rglob("*") if p.is_file()):
        fail(f"{label}: the runs wrote different files ({len(files)} in the first)")
    worst = 0
    for rel in files:
        a, b = a_dir / rel, b_dir / rel
        if rel.suffix == ".csv" and a.read_bytes() != b.read_bytes():
            fail(f"{label}: {rel} differs")
        if rel.suffix == ".json" and [ln for ln in a.read_text().splitlines() if '"creation_time"' not in ln] != \
                [ln for ln in b.read_text().splitlines() if '"creation_time"' not in ln]:
            fail(f"{label}: {rel} differs")
        if rel.suffix == ".wav":
            x, y = (np.round(wav_read(f)[0] * 32768).astype(np.int32) for f in (a, b))
            worst = max(worst, int(np.abs(x - y).max()))
    print(f"{label}: {len(files)} files; CSVs byte-identical, JSONs byte-identical but for the creation time, "
          f"WAVs at most {worst} LSB apart", flush=True)
    if worst > 1:
        fail(f"{label}: WAVs differ by more than 1 LSB")


# Multi-device rendering: a world of one NCCL rank on the card, two gloo
# ranks sharing it, the CLI as rank 0 of a world of one, and a scene with
# two microphones
PARALLEL_BATCH = 4  # scenes of the sharded-render checks
PARALLEL_CLI_SCENES = 4  # the --coordinator CLI run: the first jobs of pooled_phase's 1-worker run
PARALLEL_BACKEND = "nccl"  # the world of one's backend
COLLECTIVE_REPS = 50
TWO_MIC_POSITIONS = dict(ambeovr=(2.4, 2.5, 1.5), foalistener=(4.6, 2.5, 1.4), event=(3.5, 1.3, 1.3))
TWO_MIC_PATH = ("first_hit_small", "any_hit", "deposit_histogram", "deposit_histogram_foa")
FLAGSHIP_ROOM = dict(extents=(7.0, 5.0, 3.0), seed=0)
RANK_DEVICE = "cuda:0"  # the gloo ranks' card
GLOO_RANK_SCRIPT = Path(__file__).resolve()  # run as `--gloo-rank`


def plan_path_plans(renderer, scenes: list, dev) -> list:
    """ScenePlans with IR banks: each flagship scene of `scenes`
    (`pooled_inputs`) traced by `renderer` (the MIC rig) and its IRs gathered
    per event slot as the plan path packs them, with a white -65 dB bed."""
    from audiblelight_tpu_torch.render import ScenePlan, ambience_bed_device

    plans = []
    for i, (src, caps, s_idx, m_idx, plan, _) in enumerate(scenes):
        lis = torch.as_tensor(caps, dtype=torch.float32, device=dev)
        irs = renderer.trace(torch.Generator(device=dev).manual_seed(4000 + i), torch.as_tensor(src, device=dev), lis,
                             renderer.rain_table(caps))  # (C, S, L)
        c, ir_len = irs.shape[0], irs.shape[-1]
        s_i, m_i = torch.as_tensor(s_idx, device=dev), torch.as_tensor(m_idx, device=dev)
        p = ScenePlan.from_numpy(plan, dev)
        p.static_irs = (irs[:, s_i.clamp_min(0)] * (s_i >= 0)[None, :, None]).transpose(0, 1).contiguous()
        em, j = m_i.shape
        m_irs = irs[:, m_i.clamp_min(0).reshape(-1)].reshape(c, em, j, ir_len) * (m_i >= 0)[None, :, :, None]
        p.moving_irs = m_irs.transpose(0, 1).contiguous()
        p.ambience = ambience_bed_device(torch.Generator(device=dev).manual_seed(5000 + i), 0.0, REF_DB, c,
                                         p.n_scene_samples, dev)
        plans.append(p)
    return plans


def collective_ms(op, reps: int = COLLECTIVE_REPS) -> float:
    """Milliseconds per call of `op()` (a collective), host clock over `reps`
    calls after a warm-up, synchronised."""
    op()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        op()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def rank_collectives(dev) -> dict:
    """all_reduce MAX of a scalar and all_gather of a 4-float tensor on `dev`,
    ms per call, over the process group."""
    import torch.distributed as dist

    peak = torch.ones((), device=dev)
    part = torch.ones(4, device=dev)
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size())]
    return dict(all_reduce_ms=collective_ms(lambda: dist.all_reduce(peak, op=dist.ReduceOp.MAX)),
                all_gather_ms=collective_ms(lambda: dist.all_gather(parts, part)))


def flagship_trace_kwargs(st) -> dict:
    """The flagship MIC trace's keywords in room state `st` (engine config,
    cached first-hit table and any-hit trees, the rain table toward the
    AmbeoVR's centre)."""
    from audiblelight_tpu_torch.micarrays import ambeovr_capsules

    caps = ambeovr_capsules(MIC_CENTRE)
    occ = st.rain_occlusion_for(np.asarray(caps).mean(axis=0, keepdims=True))
    return dict(st._trace_kwargs("omni", None), face_occlusion=occ)


def gloo_rank_main(rank: int, init: str, folder: str) -> int:
    """One of two gloo ranks on cuda:0 (`python3 chip_smoke.py --gloo-rank
    <rank> <init URL> <folder>`): shard_render (plain and normalised) of the
    batch in <folder>/inputs.pt, shard_convolve_time of its 60 s signal, and
    shard_trace_rirs of its 16 flagship sources in the flagship room (this
    rank's own room state), launches counted around the trace; the
    collectives timed per call. Writes <folder>/rank<rank>.pt."""
    sys.path.insert(0, str(REPO))
    from audiblelight_tpu_torch import parallel as par
    from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
    from audiblelight_tpu_torch.micarrays import ambeovr_capsules
    from audiblelight_tpu_torch.ops import build
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False  # as main() runs the unsharded side
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    folder = Path(folder)
    t0 = time.perf_counter()
    dev = torch.device(RANK_DEVICE)
    par.init_distributed(init, 2, rank, None if dev.index is None else [dev.index], backend="gloo", timeout=120)
    init_s = time.perf_counter() - t0
    try:
        mesh = par.make_mesh()
        inp = torch.load(folder / "inputs.pt", map_location=dev)
        out = dict(init_s=init_s, **rank_collectives(dev))
        out["render"] = par.shard_render(inp["batched"], mesh).cpu()
        out["render_norm"] = par.shard_render(inp["batched"], mesh, normalize=True).cpu()
        out["conv"] = par.shard_convolve_time(inp["audio"], inp["irs"], mesh).cpu()
        st = FusedSceneRenderer.from_mesh(scanned_like_room(**FLAGSHIP_ROOM), ENGINE,
                                          ambeovr_capsules(MIC_CENTRE), BUCKETS, N_SOURCES,
                                          int(SCENE_SECONDS * SR), device=dev).state
        ck.reset_launch_counts()
        trace = par.shard_trace_rirs(mesh, int(inp["trace_seed"]), st.acoustic_tris, st.absorption, st.scattering,
                                     inp["sources"], inp["listeners"], **flagship_trace_kwargs(st))
        torch.cuda.synchronize()
        out["trace"], out["trace_launches"] = trace.cpu(), dict(ck.launch_counts)
        torch.save(out, folder / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def compare_to_run(a_dir: Path, b_dir: Path, label: str, n_files: int, max_lsb: int = 0) -> None:
    """Every file `a_dir` holds is in `b_dir` with the same content: CSVs byte
    for byte, JSONs but for the creation time, WAVs within `max_lsb`."""
    from audiblelight_tpu_torch.io.audio import wav_read

    files = sorted(p.relative_to(a_dir) for p in a_dir.rglob("*") if p.is_file())
    if len(files) != n_files:
        fail(f"{label}: {len(files)} files, expected {n_files}")
    worst = 0
    for rel in files:
        a, b = a_dir / rel, b_dir / rel
        if not b.is_file():
            fail(f"{label}: {rel} is not in {b_dir}")
        if rel.suffix == ".csv" and a.read_bytes() != b.read_bytes():
            fail(f"{label}: {rel} differs")
        if rel.suffix == ".json" and [ln for ln in a.read_text().splitlines() if '"creation_time"' not in ln] != \
                [ln for ln in b.read_text().splitlines() if '"creation_time"' not in ln]:
            fail(f"{label}: {rel} differs")
        if rel.suffix == ".wav":
            x, y = (np.round(wav_read(f)[0] * 32768).astype(np.int32) for f in (a, b))
            worst = max(worst, int(np.abs(x - y).max()))
    print(f"{label}: {len(files)} files; CSVs byte-identical, JSONs byte-identical but for the creation time, "
          f"WAVs at most {worst} LSB apart", flush=True)
    if worst > max_lsb:
        fail(f"{label}: WAVs differ by more than {max_lsb} LSB")


def two_mic_check(fg: Path, dev) -> dict:
    """A 60 s rlr scene with an AmbeoVR and a FOA listener (the flagship
    engine config) in the 432-face small room through
    `render_scenes_pipelined`, which renders it on the plan path: both
    microphones' mixes with sound, launches counted around it (MIC: K1
    small, K2, K3; FOA: K4), and each microphone's direct path from the
    static event (line of sight checked with the plain any-hit) in its
    traced IRs within 2 samples of d/c (every AmbeoVR capsule; the FOA's W
    channel). Returns the launches."""
    from audiblelight_tpu_torch.core import Scene
    from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.pipeline import render_scenes_pipelined
    from audiblelight_tpu_torch import seld

    rlr = {k: v for k, v in ENGINE.items() if k != "sample_rate"}
    scene = Scene(duration=SCENE_SECONDS, sample_rate=SR, backend="rlr", fg_path=fg, device=dev,
                  backend_kwargs=dict(mesh=scanned_like_room((7.0, 5.0, 3.0), subdivision_levels=1, seed=0), seed=3,
                                      add_to_context=False, rlr_kwargs=rlr))
    scene.add_microphone(microphone_type="ambeovr", position=list(TWO_MIC_POSITIONS["ambeovr"]))
    scene.add_microphone(microphone_type="foalistener", position=list(TWO_MIC_POSITIONS["foalistener"]))
    scene.add_event(event_type="static", position=list(TWO_MIC_POSITIONS["event"]), scene_start=1.0,
                    duration=EVENT_SECONDS, snr=20.0)
    scene.add_event(event_type="moving", max_place_attempts=100)
    scene.add_ambience(noise="gaussian")
    audio = {}
    pk = seld.plan_kwargs(seld.build_parser().parse_args(["--fg-dir", ".", "--output-dir", "."]))
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    if render_scenes_pipelined([scene], lambda s, a: audio.update(a), plan_kwargs=pk) != 1:
        fail("the two-microphone scene did not complete")
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(ck.launch_counts)
    print(f"two-microphone scene (AmbeoVR + FOA, small room, plan path): {seconds:.3f} s (host clock); "
          f"peaks { {a: float(np.abs(x).max()) for a, x in audio.items()} }; launches {launches}", flush=True)
    if list(audio) != ["mic000", "mic001"] or any(np.abs(x).max() < 1e-3 or x.shape != (4, int(SCENE_SECONDS * SR))
                                                  for x in audio.values()):
        fail("the two-microphone scene's mixes are missing, silent or misshapen")
    for name in TWO_MIC_PATH:
        if launches[name] <= 0:
            fail(f"the two-microphone scene never launched {name}")
    banks = scene.state.trace_irs_device()  # the render's trace (cached)
    tris = scene.state.device_state.tris
    pos = np.asarray(TWO_MIC_POSITIONS["event"], dtype=np.float64)
    for alias, mic in scene.state.microphones.items():
        pts = (np.atleast_2d(mic.coordinates_absolute) if mic.channel_layout_type == "mic"
               else np.atleast_2d(mic.coordinates_center))
        blocked = ck.segments_occluded_plain(torch.tensor(pts, dtype=torch.float32, device=dev),
                                             torch.tensor(np.tile(pos, (len(pts), 1)), dtype=torch.float32,
                                                          device=dev), tris)
        if bool(blocked.any()):
            fail(f"the two-microphone scene's event has no line of sight to {alias}")
        bank = banks[alias].cpu().numpy()  # (C, E, L); the static event's emitter is 0
        offs = [first_arrival(bank[c, 0]) - np.linalg.norm(pts[c] - pos) / 343.0 * SR for c in range(len(pts))]
        print(f"two-microphone scene {alias} ({mic.channel_layout_type}): direct arrivals minus d/c "
              f"{[round(float(o), 2) for o in offs]} samples", flush=True)
        if max(abs(o) for o in offs) > 2.0:
            fail(f"the two-microphone scene's {alias} direct path is off d/c")
    return launches


def parallel_phase(renderer, st, fg: Path, room_obj: Path, out: Path, pooled_w1: dict, dev) -> dict:
    """Multi-device rendering on the one card (`audiblelight_tpu_torch.parallel`):

    - the rlr CLI as rank 0 of a world of one (`--coordinator
      127.0.0.1:<port> --num-processes 1 --process-id 0`, NCCL,
      `--placement-workers 1 --fused-batch 1`, the first
      PARALLEL_CLI_SCENES jobs of pooled_phase's 1-worker run, whose files it
      writes again to 0 LSB), launches counted, its seconds per scene beside
      that run's for the same jobs;
    - `--mesh-devices 2` exits with the reference's message on a one-card
      host, before anything is written;
    - a world of one NCCL rank in this process: init_distributed timed,
      make_mesh, the collectives per call, shard_render (normalised) of
      PARALLEL_BATCH traced flagship plans equal to the normalised
      render_batch, shard_render against render_batch and
      render_mix_batch_sharded against render_mix_batch (equal, timed in
      turns) on the same batch;
    - two gloo ranks sharing cuda:0 (`--gloo-rank`, subprocesses with a
      timeout): shard_render, shard_convolve_time and shard_trace_rirs
      against their unsharded runs here (shard_render within 1e-6 of peak,
      shard_convolve_time within 1e-5, each trace shard within 1e-5 of
      trace_rirs_multi of its slice with its shard generator; whether each
      is bit for bit printed), the collectives per call;
    - a scene with two microphones through render_scenes_pipelined
      (`two_mic_check`).

    Returns the CLI run's launches."""
    import socket
    import tempfile

    import torch.distributed as dist

    from audiblelight_tpu_torch import parallel as par
    from audiblelight_tpu_torch import seld
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.ops.convolve import fft_convolve
    from audiblelight_tpu_torch.rir.raytracer import trace_rirs_multi

    card = card_line()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)

    # The CLI as rank 0 of a world of one
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = ["--fg-dir", str(fg), "--mesh", str(room_obj), "--channel-layout", "mic",
            *cli_flags(PARALLEL_CLI_SCENES), "--placement-workers", "1", "--fused-batch", "1"]
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    stats: dict = {}
    seconds = seld.main(base + ["--output-dir", str(out / "coordinator"), "--coordinator", f"127.0.0.1:{port}",
                                "--num-processes", "1", "--process-id", "0"], stats=stats)
    torch.cuda.synchronize()
    launches = dict(ck.launch_counts)
    n = stats["n_scenes"]
    same_jobs = pooled_w1["scene_seconds"][:n]  # the same jobs in the run without it
    print(f"pooled CLI with --coordinator (world of one, NCCL): {n} scenes in {stats['wall_s']:.3f} s; per scene "
          f"(host clock since the previous writes) {[round(x, 3) for x in seconds]} s against "
          f"{[round(x, 3) for x in same_jobs]} s for the same jobs without it (pooled_phase's 1-worker run, "
          f"{pooled_w1['n_scenes']} scenes in {pooled_w1['wall_s']:.3f} s); after the first scene, median "
          f"{np.median(seconds[1:]):.3f} against {np.median(same_jobs[1:]):.3f} s; world_size "
          f"{stats.get('world_size')}; launches {launches} on {card}", flush=True)
    if n != PARALLEL_CLI_SCENES or stats.get("world_size") != 1 or dist.is_initialized():
        fail(f"the --coordinator CLI rendered {n} scenes in a world of {stats.get('world_size')}, or left its group up")
    for name in MIC_PATH:
        if launches[name] <= 0:
            fail(f"the --coordinator CLI never launched {name}")
    check_first_hits(launches, 60 * n, "the --coordinator CLI")
    compare_to_run(out / "coordinator", out.parent / "pooled" / "pooled_w1",
                   "pooled CLI with --coordinator against pooled_phase's 1-worker run", 3 * PARALLEL_CLI_SCENES)

    # --mesh-devices 2 on this host
    n_cards = torch.cuda.device_count()
    try:
        seld.main(base + ["--output-dir", str(out / "mesh2"), "--mesh-devices", "2"])
        fail("--mesh-devices 2 ran on a host with fewer than 2 cards" if n_cards < 2 else "unexpected")
    except SystemExit as exc:
        print(f"--mesh-devices 2 on a host with {n_cards} card(s): SystemExit({str(exc)!r})", flush=True)
        if str(exc) != f"--mesh-devices 2 but only {n_cards} devices" or (out / "mesh2").exists():
            fail("--mesh-devices 2 did not exit with the reference's message before writing")

    # A world of one NCCL rank in this process
    rendezvous = Path(tempfile.mkdtemp(dir=out))
    t0 = time.perf_counter()
    world = par.init_distributed((rendezvous / "init").as_uri(), 1, 0, backend=PARALLEL_BACKEND)
    init_s = time.perf_counter() - t0
    try:
        mesh = par.make_mesh()
        coll = rank_collectives(dev)
        print(f"world of one ({dist.get_backend()}): init_distributed {init_s * 1e3:.3f} ms (host clock), mesh "
              f"{mesh}; all_reduce MAX {coll['all_reduce_ms']:.4f} ms, all_gather {coll['all_gather_ms']:.4f} ms a "
              f"call (host clock over {COLLECTIVE_REPS}) on {card}", flush=True)
        if world != 1 or tuple(mesh.shape) != (1, 1):
            fail(f"the world of one has {world} ranks, mesh {tuple(mesh.shape)}")
        scenes = pooled_inputs(st, dev)[:PARALLEL_BATCH]
        plans = plan_path_plans(renderer, scenes, dev)
        batched = par.stack_plans(plans)
        ck.reset_launch_counts()
        got = par.shard_render(batched, mesh, normalize=True)
        torch.cuda.synchronize()
        render_launches = {k: v for k, v in ck.launch_counts.items() if v}
        want = par.render_batch(batched)
        want_norm = want / want.abs().max()
        print(f"shard_render (normalised, world of one) of {PARALLEL_BATCH} traced flagship plans "
              f"{tuple(got.shape)}: equal to the normalised render_batch {torch.equal(got, want_norm)}, peak "
              f"{float(got.abs().max()):.6f}; kernel launches {render_launches} (plain PyTorch)", flush=True)
        if not torch.equal(got, want_norm) or abs(float(got.abs().max()) - 1.0) > 1e-6:
            fail("shard_render (normalised) differs from the normalised render_batch")
        t_shard, t_local = [], []
        for _ in range(2):  # in turns: sharded, local, local, sharded
            t_shard.append(time_ms(lambda: par.shard_render(batched, mesh), reps=3))
            t_local.append(time_ms(lambda: par.render_batch(batched), reps=3))
        batch_in = [(2000 + i, src, caps, renderer.rain_table(caps), s_idx, m_idx)
                    for i, (src, caps, s_idx, m_idx, _, _) in enumerate(scenes)]
        host_plans, extras = [sc[4] for sc in scenes], [sc[5] for sc in scenes]
        mix_sharded = renderer.render_mix_batch_sharded(batch_in, host_plans, extras, mesh)
        mix_local = renderer.render_mix_batch(batch_in, host_plans, extras)
        if not torch.equal(mix_sharded, mix_local):
            fail("render_mix_batch_sharded (world of one) differs from render_mix_batch")
        m_shard, m_local = [], []
        for _ in range(2):
            m_shard.append(time_ms(lambda: renderer.render_mix_batch_sharded(batch_in, host_plans, extras, mesh),
                                   reps=3))
            m_local.append(time_ms(lambda: renderer.render_mix_batch(batch_in, host_plans, extras), reps=3))
        print(f"world of one, {PARALLEL_BATCH} flagship scenes (CUDA events, median of 3, two turns): shard_render "
              f"{t_shard} ms against render_batch {t_local} ms; render_mix_batch_sharded {m_shard} ms against "
              f"render_mix_batch {m_local} ms (equal {torch.equal(mix_sharded, mix_local)}) on {card}", flush=True)
    finally:
        dist.destroy_process_group()

    # Two gloo ranks sharing cuda:0
    gloo = out / "gloo"
    gloo.mkdir()
    rng = np.random.default_rng(11)
    src = torch.as_tensor(scenes[0][0], device=dev)
    inputs = dict(batched={k: (v.cpu() if torch.is_tensor(v) else v) for k, v in batched.items()},
                  audio=torch.as_tensor(rng.standard_normal(int(SCENE_SECONDS * SR)), dtype=torch.float32),
                  irs=plans[0].static_irs[0].cpu(), trace_seed=7, sources=src.cpu(),
                  listeners=torch.as_tensor(scenes[0][1], dtype=torch.float32))
    torch.save(inputs, gloo / "inputs.pt")
    init = (gloo / "init").as_uri()
    procs = [subprocess.Popen([sys.executable, str(GLOO_RANK_SCRIPT), "--gloo-rank", str(r), init, str(gloo)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-4000:])
            fail(f"gloo rank {r} failed with {p.returncode}")
    ranks = [torch.load(gloo / f"rank{r}.pt") for r in range(2)]
    print(f"two gloo ranks on cuda:0: init_distributed {[round(x['init_s'] * 1e3, 3) for x in ranks]} ms; all_reduce "
          f"MAX {[round(x['all_reduce_ms'], 4) for x in ranks]} ms, all_gather "
          f"{[round(x['all_gather_ms'], 4) for x in ranks]} ms a call (host clock over {COLLECTIVE_REPS}; gloo "
          f"stages CUDA tensors through the host) on {card}", flush=True)
    render = torch.cat([x["render"] for x in ranks]).to(dev)
    render_norm = torch.cat([x["render_norm"] for x in ranks]).to(dev)
    gaps = [float((a - b).abs().max() / b.abs().max()) for a, b in ((render, want), (render_norm, want_norm))]
    print(f"gloo shard_render: bit for bit with render_batch {torch.equal(render, want)}, max |diff| {gaps[0]:.3e} "
          f"of peak; normalised bit for bit {torch.equal(render_norm, want_norm)}, {gaps[1]:.3e}", flush=True)
    if max(gaps) > 1e-6:
        fail("the gloo ranks' shard_render differs from render_batch on the card")
    conv_want = fft_convolve(inputs["audio"].to(dev), inputs["irs"].to(dev))
    for r, x in enumerate(ranks):
        gap = float((x["conv"].to(dev) - conv_want).abs().max() / conv_want.abs().max())
        print(f"gloo rank {r} shard_convolve_time {tuple(x['conv'].shape)}: max |diff| {gap:.3e} of peak against "
              f"fft_convolve on the whole signal", flush=True)
        if tuple(x["conv"].shape) != tuple(conv_want.shape) or gap > 1e-5:
            fail(f"gloo rank {r}'s shard_convolve_time differs from fft_convolve")
    kw = flagship_trace_kwargs(st)
    half = N_SOURCES // 2
    for r, x in enumerate(ranks):
        want_t = trace_rirs_multi(par.shard_generator(7, r, dev), st.acoustic_tris, st.absorption, st.scattering,
                                  src[half * r : half * (r + 1)], inputs["listeners"].to(dev), **kw)
        got_t = x["trace"].to(dev)
        gap = float((got_t - want_t).abs().max() / want_t.abs().max())
        print(f"gloo rank {r} shard_trace_rirs {tuple(got_t.shape)}: bit for bit {torch.equal(got_t, want_t)}, max "
              f"|diff| {gap:.3e} of peak against trace_rirs_multi of its slice; launches {x['trace_launches']}",
              flush=True)
        if got_t.shape != want_t.shape or gap > 1e-5:
            fail(f"gloo rank {r}'s shard_trace_rirs differs from its unsharded slice")
        for name in MIC_PATH:
            if x["trace_launches"].get(name, 0) <= 0:
                fail(f"gloo rank {r}'s trace never launched {name}")

    two_mic_check(fg, dev)
    return launches


# Real datasets' assets: the asset room tables (a hand-packed GLB room and
# the table's stand-ins), MP3 and FLAC, file ambience, predefined
# trajectories and transmission through faces
ASSET_FLAGS = ["--backend", "rlr", "--assets", "9A", "--scapes-per-room", "1", "--duration", "60", "--rays", "5000",
               "--ray-depth", "60", "--ray-decimation", "--ir-seconds", "1.0", "--min-events-static", "4",
               "--max-events-static", "4", "--min-events-moving", "1", "--max-events-moving", "1", "--seed", "7",
               "--fused-batch", "1"]
# The FOA CLI scene whose foreground holds the MP3 and a FLAC: one static
# event a file (the foreground lists one file per extension, in the
# extensions' order, so the draws do not depend on the file system; --seed
# 4 draws each file once in the flagship room)
CODEC_CLI_FLAGS = ["--backend", "rlr", "--channel-layout", "foa", "--n-scenes", "1", "--train-frac", "1.0",
                   "--duration", "60", "--rays", "5000", "--ray-depth", "60", "--ray-decimation",
                   "--min-events-moving", "0", "--max-events-moving", "0", "--seed", "4"]
FLAC_SECONDS, FLAC_RICE_SECONDS = 60.0, 10.0
DIVIDED_ROOM = (6.0, 4.0, 3.0)
DIVIDED_KW = dict(n_rays=5000, max_depth=60, n_samples=2400, sr=SR, occlusion=True)


def pack_glb(path: Path, vertices: np.ndarray, faces: np.ndarray) -> Path:
    """A minimal GLB: one float32 position accessor, uint32 indices, one node."""
    import struct

    v, f = np.asarray(vertices, np.float32), np.asarray(faces, np.uint32)
    blob = v.tobytes() + f.tobytes()
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1, "mode": 4}]}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": len(v), "type": "VEC3"},
                      {"bufferView": 1, "componentType": 5125, "count": f.size, "type": "SCALAR"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": v.nbytes},
                        {"buffer": 0, "byteOffset": v.nbytes, "byteLength": f.nbytes}],
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\x00" * (-len(blob) % 4)
    out = struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(blob))
    out += struct.pack("<II", len(js), 0x4E4F534A) + js + struct.pack("<II", len(blob), 0x004E4942) + blob
    path.write_bytes(out)
    return path


def reference_loop_subframe(br, block_size: int, bps: int) -> np.ndarray:
    """The reference decoder's subframe, one field at a time (its
    `_decode_subframe` and `_decode_residual`, copied as they are): the
    yardstick of the port's numpy decode."""
    fixed = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}

    def residual(block_size, pred_order):
        method = br.read(2)
        param_bits = 4 if method == 0 else 5
        escape = (1 << param_bits) - 1
        part_order = br.read(4)
        out = np.empty(block_size - pred_order, dtype=np.int64)
        idx = 0
        for p in range(1 << part_order):
            n = (block_size >> part_order) - (pred_order if p == 0 else 0)
            param = br.read(param_bits)
            if param == escape:
                raw_bits = br.read(5)
                for i in range(n):
                    out[idx + i] = br.read_signed(raw_bits) if raw_bits else 0
            else:
                for i in range(n):
                    q = br.read_unary()
                    r = br.read(param) if param else 0
                    v = (q << param) | r
                    out[idx + i] = (v >> 1) ^ -(v & 1)
            idx += n
        return out

    if br.read(1) != 0:
        raise ValueError("Invalid FLAC subframe sync bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted
    if sf_type == 0:
        samples = np.full(block_size, br.read_signed(bps), dtype=np.int64)
    elif sf_type == 1:
        samples = np.array([br.read_signed(bps) for _ in range(block_size)], dtype=np.int64)
    elif 8 <= sf_type <= 12:
        order = sf_type - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        resid = residual(block_size, order)
        samples = np.empty(block_size, dtype=np.int64)
        samples[:order] = warm
        coeffs = fixed[order]
        for i in range(order, block_size):
            pred = 0
            for k, ck in enumerate(coeffs):
                pred += ck * samples[i - 1 - k]
            samples[i] = resid[i - order] + pred
    else:
        order = sf_type - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        shift = br.read_signed(5)
        coeffs = [br.read_signed(precision) for _ in range(order)]
        resid = residual(block_size, order)
        samples = np.empty(block_size, dtype=np.int64)
        samples[:order] = warm
        for i in range(order, block_size):
            pred = 0
            for k in range(order):
                pred += coeffs[k] * samples[i - 1 - k]
            samples[i] = resid[i - order] + (pred >> shift)
    if wasted:
        samples <<= wasted
    return samples


def host_s(fn) -> tuple:
    """(result, host-clock seconds) of one call of `fn`."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def codec_check(out: Path) -> Path:
    """MP3 and FLAC on the chip host: whether libmpg123 and libmp3lame load;
    where libmpg123 does, the repo's MP3 decoded (timed; its rate, duration
    and sound checked); a 60 s stereo 48 kHz FLAC written and read back bit
    for bit (verbatim, the reference's bytes), and fixed- and LPC-predicted
    Rice-coded FLACs of FLAC_RICE_SECONDS, each decode timed beside the
    reference's per-field loop on the same file (equal samples). Returns a
    foreground folder of the MP3 (where decodable) and a FLAC of a repo WAV
    for the CLI."""
    from audiblelight_tpu_torch.io import codecs
    from audiblelight_tpu_torch.io.audio import get_duration, load_audio

    mp3 = REPO / "tests/resources/soundevents/music/000010.mp3"
    have_dec, have_enc = codecs.mp3_available(), codecs.mp3_encode_available()
    print(f"codecs on this host: libmpg123 {'present' if have_dec else 'absent'}, libmp3lame "
          f"{'present' if have_enc else 'absent'}", flush=True)
    fg = out / "fg"
    shutil.rmtree(out, ignore_errors=True)
    (fg / "music").mkdir(parents=True)
    (fg / "femaleSpeech").mkdir()
    if have_dec:
        (audio, sr), dec_s = host_s(lambda: codecs.mp3_read(mp3))
        dur = get_duration(mp3)
        print(f"MP3 {mp3.name}: {audio.shape[0]} x {audio.shape[1]} at {sr} Hz decoded in {dec_s:.3f} s (host clock), "
              f"peak {float(np.abs(audio).max()):.3f}, duration {dur:.3f} s from the frame scan", flush=True)
        if sr not in (22050, 24000, 32000, 44100, 48000) or not np.isfinite(audio).all() or \
                np.abs(audio).max() < 1e-3 or abs(dur - audio.shape[1] / sr) > 0.5:
            fail("the repo's MP3 decoded wrongly")
        shutil.copy(mp3, fg / "music" / mp3.name)
    rng = np.random.default_rng(17)
    n = int(FLAC_SECONDS * 48000)
    t = np.arange(n) / 48000
    x = (0.3 * np.sin(2 * np.pi * 220.0 * t)[None] * np.array([[1.0], [0.7]])
         + 0.02 * rng.standard_normal((2, n))).astype(np.float32)
    q = (np.clip(np.round(x * 32768), -32768, 32767) / 32768).astype(np.float32)
    ref_sub = codecs._decode_subframe
    for method, seconds in (("verbatim", FLAC_SECONDS), ("fixed", FLAC_RICE_SECONDS), ("lpc", FLAC_RICE_SECONDS)):
        m = int(seconds * 48000)
        path = out / f"{method}.flac"
        _, write_s = host_s(lambda: codecs.flac_write(path, x[:, :m], 48000, method=method, stereo="mid_side"
                                                      if method == "lpc" else "independent"))
        (got, sr), port_s = host_s(lambda: codecs.flac_read(path))
        codecs._decode_subframe = reference_loop_subframe
        try:
            (want, _), ref_s = host_s(lambda: codecs.flac_read(path))
        finally:
            codecs._decode_subframe = ref_sub
        same = np.array_equal(got, q[:, :m]) and np.array_equal(got, want)
        print(f"FLAC {method} {got.shape[0]} x {got.shape[1]} at {sr} Hz ({seconds:.0f} s, {path.stat().st_size} "
              f"bytes): written in {write_s:.3f} s; decoded in {port_s:.3f} s, the reference's per-field loop "
              f"{ref_s:.3f} s on the same file ({ref_s / port_s:.1f}x); bit for bit with the input and the loop "
              f"{same} (host clock)", flush=True)
        if not same or sr != 48000:
            fail(f"the {method} FLAC did not round-trip bit for bit")
    speech = sorted((REPO / "tests/resources/soundevents/femaleSpeech").glob("*.wav"))[0]
    audio, sr = load_audio(speech, mono=False)
    codecs.flac_write(fg / "femaleSpeech" / f"{speech.stem}.flac", audio, sr, method="lpc")
    back, _ = load_audio(fg / "femaleSpeech" / f"{speech.stem}.flac", mono=False)
    if not np.array_equal(back, (np.clip(np.round(audio * 32768), -32768, 32767) / 32768).astype(np.float32)):
        fail("the speech FLAC did not read back")
    return fg


def glb_check(mesh, out: Path) -> Path:
    """The flagship room as a GLB (`Haymarket.glb`, a room of split 9A):
    load_mesh's time and its faces, repair's and fix_winding's time on it,
    and fix_winding on a copy with a tenth of its faces flipped, which must
    give back the room's winding. Returns the mesh folder."""
    from audiblelight_tpu_torch.geometry.mesh import TriMesh, load_mesh

    mesh_dir = out / "meshes"
    mesh_dir.mkdir(parents=True)
    path = pack_glb(mesh_dir / "Haymarket.glb", mesh.vertices, mesh.faces)
    loaded, load_s = host_s(lambda: load_mesh(path))
    same = np.array_equal(loaded.faces, mesh.faces) and np.array_equal(loaded.vertices,
                                                                        mesh.vertices.astype(np.float32))
    copy = TriMesh(loaded.vertices, loaded.faces.copy())
    _, degenerate_s = host_s(copy.remove_degenerate_faces)
    _, winding_s = host_s(copy.fix_winding)
    _, repair_s = host_s(TriMesh(loaded.vertices, loaded.faces.copy()).repair)
    flipped = loaded.faces.copy()
    flip = np.random.default_rng(3).random(len(flipped)) < 0.1
    flipped[flip] = flipped[flip][:, ::-1]
    broken = TriMesh(loaded.vertices, flipped)
    _, flipped_s = host_s(broken.fix_winding)
    f = broken.faces
    directed = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    coherent = len(np.unique(directed, axis=0)) == len(directed)
    print(f"GLB {path.name} ({path.stat().st_size} bytes): load_mesh {load_s:.3f} s for {len(loaded.faces)} faces "
          f"(the room's faces and float32 vertices: {same}); remove_degenerate_faces {degenerate_s:.3f} s, "
          f"fix_winding {winding_s:.3f} s, repair {repair_s:.3f} s; fix_winding with {int(flip.sum())} faces "
          f"flipped {flipped_s:.3f} s, every edge then traversed once each way {coherent} (host clock)", flush=True)
    if not same or len(loaded.faces) != len(mesh.faces) or not coherent:
        fail("the GLB room did not load or its winding was not repaired")
    return mesh_dir


def assets_cli_check(fg: Path, mesh_dir: Path, out: Path) -> dict:
    """The rlr SELD CLI over split 9A at one scape a room (`--assets 9A
    --scapes-per-room 1`, the flagship width): Haymarket from the GLB (K1
    big on its LOD, K2, K3), the other 8 rooms the table's stand-ins (K1
    small, K2, K3), through the pooled driver with 1 and with 2 prep workers:
    9 WAVs, CSVs and JSONs under the reference's names, the two runs' files
    equal (0 LSB), each scene's seconds (each a room's first). Returns the
    1-worker run's launches."""
    from audiblelight_tpu_torch import seld
    from audiblelight_tpu_torch.io.audio import wav_read
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    names = []
    for split, fold, n in (("train", 1, 6), ("test", 2, 3)):
        for i in range(n):
            stem = f"dev-{split}-alight/fold{fold}_scene{i}_000"
            names += [f"mic_dev/{stem}_mic000.wav", f"metadata_dev/{stem}.json", f"metadata_dev/{stem}_mic000.csv"]
    runs = {}
    for workers in (1, 2):
        argv = ["--fg-dir", str(fg), "--output-dir", str(out / f"assets_w{workers}"), "--mesh-dir", str(mesh_dir),
                "--channel-layout", "mic", *ASSET_FLAGS, "--placement-workers", str(workers)]
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        stats: dict = {}
        seconds = seld.main(argv, stats=stats)
        torch.cuda.synchronize()
        runs[workers] = launches = dict(ck.launch_counts)
        got = sorted(str(p.relative_to(out / f"assets_w{workers}")) for p in (out / f"assets_w{workers}").rglob("*")
                     if p.is_file())
        print(f"--assets 9A CLI, {workers} prep workers: {stats['n_scenes']} scenes in {stats['wall_s']:.3f} s; "
              f"seconds a scene (each its room's first) {[round(s, 3) for s in seconds]}; stats "
              f"{ {k: round(v, 3) for k, v in stats.items() if k.endswith('_s')} }; launches {launches} on "
              f"{card_line()}", flush=True)
        if got != sorted(names) or stats["n_scenes"] != 9:
            fail(f"the --assets CLI wrote {got}")
        for wav in (out / f"assets_w{workers}").rglob("*.wav"):
            data, sr = wav_read(wav)
            if sr != SR or data.shape != (4, int(SCENE_SECONDS * SR)) or np.abs(data).max() * 32768 < 100:
                fail(f"{wav.name}: not a 4-channel {SR} Hz scene with sound")
        for name in ("first_hit_big", "first_hit_small", "any_hit", "deposit_histogram"):
            if launches[name] <= 0:
                fail(f"the --assets CLI never launched {name}")
        depth = int(ASSET_FLAGS[ASSET_FLAGS.index("--ray-depth") + 1])
        if launches["first_hit_big"] != depth or launches["first_hit_small"] != 8 * depth:
            fail(f"the --assets CLI launched first_hit_big {launches['first_hit_big']} and first_hit_small "
                 f"{launches['first_hit_small']} times (expected {depth}, one scene in the GLB room, and "
                 f"{8 * depth})")
    meta = json.loads((out / "assets_w1/metadata_dev/dev-train-alight/fold1_scene0_000.json").read_text())
    if meta["state"]["mesh"]["fpath"] != str(mesh_dir / "Haymarket.glb"):
        fail(f"room Haymarket was {meta['state']['mesh']['fpath']}, not its GLB")
    compare_to_run(out / "assets_w1", out / "assets_w2", "--assets CLI, 1 and 2 prep workers", 27)
    return runs[1]


def scene_in_flagship_room(mesh, fg: Path, dev, seed: int, duration: float = SCENE_SECONDS):
    """A Scene in the flagship room at the flagship engine config, an
    AmbeoVR at MIC_CENTRE, the global streams seeded with `seed`."""
    from audiblelight_tpu_torch import utils
    from audiblelight_tpu_torch.core import Scene

    utils.seed_everything(seed)
    scene = Scene(duration=duration, backend="rlr", sample_rate=SR, fg_path=fg, device=dev,
                  backend_kwargs=dict(mesh=mesh, seed=seed, add_to_context=False, rlr_kwargs=dict(ENGINE)))
    scene.add_microphone(microphone_type="ambeovr", position=list(MIC_CENTRE), alias="mic000")
    return scene


def ambience_and_predefined_check(mesh, renderer, fg: Path, out: Path, dev) -> dict:
    """File ambience: a MIC scene in the flagship room with a 4-channel WAV
    bed (two static 2 s events, from a fifth of the scene on) renders through the plan path
    (`render_scenes_pipelined`), its bed equal to the host load of the same
    file and the mix before the first event the bed at the scene's level.
    Predefined trajectory: a fused flagship scene with an 11-point
    trajectory event and a gaussian bed, its emitters equal to the
    trajectory, its launches counted (K1 big 60 times), and the
    trajectory's direct paths in a trace checked as the flagship scene's.
    Returns the predefined scene's launches."""
    from audiblelight_tpu_torch.ambience import Ambience
    from audiblelight_tpu_torch.io.audio import get_duration, wav_write
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer, render_scenes_pipelined, write_wav

    bed_path = out / "bed.wav"
    rng = np.random.default_rng(23)
    wav_write(bed_path, (0.3 * rng.standard_normal((4, 7 * SR))).astype(np.float32), SR)
    scene = scene_in_flagship_room(mesh, fg, dev, 31)
    for _ in range(2):
        scene.add_event(event_type="static", scene_start=float(rng.uniform(0.2, 0.5)) * SCENE_SECONDS, duration=2.0,
                        max_place_attempts=100)
    scene.add_ambience(filepath=bed_path, ref_db=-30)
    if FusedSceneRenderer.mix_eligible(scene):
        fail("a file bed was offered to the device bed")
    done: dict = {}
    torch.cuda.synchronize()
    (_, plan_s) = host_s(lambda: render_scenes_pipelined([scene], lambda s, audio: done.update(audio)))
    mix = done["mic000"]
    bed = scene.ambience["ambience000"].load_ambience()
    host = Ambience(channels=4, duration=SCENE_SECONDS, alias="x", filepath=bed_path, sample_rate=SR).load_ambience()
    head = int(min(e.scene_start for e in scene.get_events()) * SR) - SR
    big = np.abs(bed[:, :head]) > 1e-2
    ratio = mix[:, :head][big] / bed[:, :head][big]
    spread = float(np.abs(ratio / ratio[0] - 1).max())
    print(f"file ambience: a plan-path MIC scene with a 4-channel WAV bed in {plan_s:.3f} s (host clock); the bed "
          f"equal to the host load {np.array_equal(bed, host)}; before the first event the mix is the bed times "
          f"{float(ratio[0]):.4e} (spread {spread:.2e})", flush=True)
    if mix.shape != (4, int(SCENE_SECONDS * SR)) or not np.array_equal(bed, host) or spread > 1e-4:
        fail("the file bed did not reach the mix")

    scene = scene_in_flagship_room(mesh, fg, dev, 32)
    lo, hi = np.array([0.3, 0.3, 0.3]), np.array([6.7, 4.7, 2.2])
    while True:  # an 11-point, 2 m line every point of which placement accepts
        a, step = rng.uniform(lo, hi), rng.standard_normal(3) * np.array([1.0, 1.0, 0.1])
        traj = a + np.linspace(0.0, 2.0, N_TRAJ)[:, None] * step / np.linalg.norm(step)
        if scene.state._validate_position(traj):
            break
    longest = max(fg.glob("*/*.wav"), key=get_duration)  # 2 s of audio along the 2 m line: 1 m/s
    event = scene.add_event(event_type="predefined", filepath=longest, trajectory=traj,
                            scene_start=0.3 * SCENE_SECONDS, event_start=0.0, duration=2.0, snr=20.0)
    scene.add_event(event_type="static", max_place_attempts=100)
    scene.add_ambience(noise="gaussian")
    emitters = np.stack([e.coordinates_absolute for e in event.emitters])
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    (_, fused_s) = host_s(lambda: render_scenes_pipelined([scene], lambda s, audio: done.update(pre=audio)))
    torch.cuda.synchronize()
    launches = dict(ck.launch_counts)
    wav = torch.as_tensor(done["pre"]["mic000"])
    path = write_wav(OUT / "predefined.wav", wav, SR)
    print(f"predefined trajectory: {len(event.emitters)} emitters equal to the trajectory "
          f"{np.array_equal(emitters, traj)}, velocity {event.spatial_velocity:.3f} m/s, resolution "
          f"{event.spatial_resolution}; fused scene {fused_s:.3f} s (host clock, the room state built); "
          f"{path.relative_to(REPO)} {tuple(wav.shape)} {wav.dtype}, peak {int(wav.abs().max())}; launches {launches}",
          flush=True)
    if not np.array_equal(emitters, traj) or wav.dtype != torch.int16 or int(wav.abs().max()) < 100:
        fail("the predefined event's emitters or its scene")
    check_first_hits(launches, int(ENGINE["indirect_ray_depth"]), "the predefined scene")
    listeners = torch.as_tensor(ambeovr_caps(), dtype=torch.float32, device=dev)
    src_t = torch.as_tensor(traj, dtype=torch.float32, device=dev)
    irs = renderer.trace(torch.Generator(device=dev).manual_seed(33), src_t, listeners,
                         renderer.rain_table(ambeovr_caps()))
    check_direct_paths(irs, src_t, listeners, renderer.state.tris, "predefined trajectory")
    return launches


def ambeovr_caps() -> np.ndarray:
    from audiblelight_tpu_torch.micarrays import ambeovr_capsules

    return ambeovr_capsules(MIC_CENTRE)


def check_direct_paths(irs, src_t, listeners, tris, label: str) -> None:
    """Every unoccluded (source, capsule) pair's IR peaks within 2 samples of
    d/c inside a 2 ms window, as the flagship scene's direct paths do."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    n_src, n_caps = src_t.shape[0], listeners.shape[0]
    blocked = ck.segments_occluded(listeners.repeat(n_src, 1), src_t.repeat_interleave(n_caps, dim=0),
                                   tris).reshape(n_src, n_caps)
    expect = (torch.linalg.vector_norm(src_t[:, None] - listeners[None], dim=-1) / 343.0 * SR).cpu().numpy()
    ir_ec = irs.transpose(0, 1).abs().cpu().numpy()
    free = ~blocked.cpu().numpy()
    off = []
    for e, c in zip(*np.nonzero(free)):
        lo = max(int(expect[e, c]) - 48, 0)
        off.append(abs(lo + int(np.argmax(ir_ec[e, c, lo : int(expect[e, c]) + 48])) - expect[e, c]))
    print(f"{label} direct paths: {int(free.sum())} of {free.size} (source, capsule) pairs unoccluded; max |peak "
          f"within 2 ms - d/c| {max(off, default=float('nan')):.2f} samples", flush=True)
    if not off or max(off) > 2.0:
        fail(f"{label}: direct-path arrivals off their distance")


def divided_room(tau: float, dev) -> tuple:
    """A room divided at x = 3 by a wall box overlapping the shell (the
    reference's transmission test room): (tris, absorption, scattering,
    transmission) on `dev`."""
    from audiblelight_tpu_torch.geometry.mesh import box_mesh

    ext = np.array(DIVIDED_ROOM)
    room = box_mesh(extents=ext, center=ext / 2)
    wall = box_mesh(extents=[0.2, 4.4, 3.4], center=[3.0, 2.0, 1.5], inward_normals=False)
    tris = torch.as_tensor(np.concatenate([room.triangles, wall.triangles]), dtype=torch.float32, device=dev)
    f = tris.shape[0]
    return (tris, torch.full((f, 4), 0.3, device=dev), torch.full((f,), 0.3, device=dev),
            torch.full((f, 4), tau, device=dev))


def transmission_check(mesh, renderer, scene_inputs: tuple, dev) -> None:
    """Transmission: the first flagship scene's inputs through a renderer
    with `transmission=True` (the Default material's tau) and the default
    one, timed in turns by CUDA events, launches counted; then a room
    divided by a wall at 5,000 rays x 60 bounces (AmbeoVR behind the wall):
    no energy off, some on, under 0.2 of the open room's; tau = 0 equal to
    off bit for bit; K1 small, K2 and K3 once a bounce of the trace with
    transmission on, each held to its plain version on that trace's first
    and last bounce."""
    from audiblelight_tpu_torch.geometry.mesh import box_mesh
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer
    from audiblelight_tpu_torch.render import ScenePlan
    from audiblelight_tpu_torch.rir import raytracer

    caps = ambeovr_caps()
    t_scene = int(SCENE_SECONDS * SR)
    on = FusedSceneRenderer.from_mesh(mesh, dict(ENGINE, transmission=True), caps, BUCKETS, N_SOURCES, t_scene,
                                      device=dev)
    if on.state.transmission is None or not bool(on.state.cfg["transmission"]):
        fail("the transmission renderer has no transmission table")
    src, s_idx, m_idx, plan, amb = scene_inputs
    listeners = torch.as_tensor(caps, dtype=torch.float32, device=dev)
    args = (torch.as_tensor(src, device=dev), listeners, renderer.rain_table(caps), torch.as_tensor(s_idx, device=dev),
            torch.as_tensor(m_idx, device=dev), ScenePlan.from_numpy(plan, dev), *amb)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    wav = on.render_mix(torch.Generator(device=dev).manual_seed(41), *args)
    torch.cuda.synchronize()
    launches = dict(ck.launch_counts)
    check_first_hits(launches, int(ENGINE["indirect_ray_depth"]), "the transmission scene")
    times = {"off": [], "on": []}
    for _ in range(3):
        for key, rend in (("off", renderer), ("on", on)):
            times[key].append(time_ms(lambda rend=rend: rend.render_mix(torch.Generator(device=dev).manual_seed(42),
                                                                        *args), reps=2))
    ratio = np.median(times["on"]) / np.median(times["off"])
    print(f"transmission scene (Default material, tau {on.state.transmission[0].tolist()}): peak "
          f"{int(wav.abs().max())}, launches {launches}; in turns by CUDA events on {[round(x, 3) for x in times['on']]}"
          f" ms, off {[round(x, 3) for x in times['off']]} ms, median ratio {ratio:.3f}", flush=True)

    tris, absorption, scatter, tau = divided_room(0.05, dev)
    rig = torch.as_tensor(np.stack([np.array([4.5, 2.0, 1.5]) + (c - np.array(MIC_CENTRE)) for c in caps]),
                          dtype=torch.float32, device=dev)
    src1 = torch.tensor([[1.5, 2.0, 1.5]], device=dev)

    def energy(irs):
        return float(irs.double().pow(2).sum())

    gen = lambda: torch.Generator(device=dev).manual_seed(43)  # noqa: E731
    off_irs = raytracer.trace_rirs_multi(gen(), tris, absorption, scatter, src1, rig, **DIVIDED_KW)
    zero_irs = raytracer.trace_rirs_multi(gen(), tris, absorption, scatter, src1, rig, transmission=True,
                                          face_transmission=tau * 0, **DIVIDED_KW)
    room = box_mesh(extents=np.array(DIVIDED_ROOM), center=np.array(DIVIDED_ROOM) / 2)
    open_tris = torch.as_tensor(room.triangles, dtype=torch.float32, device=dev)
    open_irs = raytracer.trace_rirs_multi(gen(), open_tris, absorption[:12], scatter[:12], src1, rig,
                                          **dict(DIVIDED_KW, occlusion=False))
    kept_fh, kept_ah, kept_dep, bounces = {}, {}, {}, [0]
    route, seg, bounce = raytracer._first_hit_route, raytracer.segments_occluded, raytracer._bounce

    def keep_route(o, d, prev_face, tris_, rt):
        keep_first_last(kept_fh, 0, (o.clone(), d.clone(), tris_, rt[0]))
        return route(o, d, prev_face, tris_, rt)

    def keep_seg(starts, ends, tris_, tree=None):
        if starts.shape[0] == kept_fh[0][-1][0].shape[0]:  # the bounce's rain query
            keep_first_last(kept_ah, 0, (starts.clone(), ends.clone(), tris_, tree))
        return seg(starts, ends, tris_, tree)

    def counted(*a, **k):
        bounces[0] += 1
        return bounce(*a, **k)

    raytracer._first_hit_route, raytracer.segments_occluded, raytracer._bounce = keep_route, keep_seg, counted
    raytracer.deposit_histogram = keep_deposits("deposit_histogram", kept_dep)
    tree = ck.any_hit_tree(tris)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    try:
        hist = raytracer.trace_energy_histogram_multi(
            gen(), tris, absorption, scatter, src1, rig, n_rays=DIVIDED_KW["n_rays"],
            max_depth=DIVIDED_KW["max_depth"], n_bins=60, bin_dt=0.002, occlusion=True, transmission=True,
            face_transmission=tau, any_hit_tree=lambda _: tree)
        torch.cuda.synchronize()
    finally:
        raytracer._first_hit_route, raytracer.segments_occluded, raytracer._bounce = route, seg, bounce
        raytracer.deposit_histogram = ck.deposit_histogram
    trace_launches = dict(ck.launch_counts)
    on_irs = raytracer.trace_rirs_multi(gen(), tris, absorption, scatter, src1, rig, transmission=True,
                                        face_transmission=tau, **DIVIDED_KW)
    e_off, e_on, e_open = energy(off_irs), energy(on_irs), energy(open_irs)
    print(f"divided room (tau 0.05, {DIVIDED_KW['n_rays']} rays x {DIVIDED_KW['max_depth']} bounces, AmbeoVR behind "
          f"the wall): IR energy off {e_off:.3e}, on {e_on:.3e}, open room {e_open:.3e} (on / open {e_on / e_open:.4f});"
          f" tau = 0 bit for bit with off {torch.equal(zero_irs, off_irs)}; the histogram trace with transmission: "
          f"{bounces[0]} bounces, launches {trace_launches}, energy {float(hist.sum()):.3e}", flush=True)
    if e_off != 0.0 or not 0.0 < e_on < 0.2 * e_open or not torch.equal(zero_irs, off_irs):
        fail("transmission through the divided room")
    for name in ("first_hit_small", "any_hit", "deposit_histogram"):
        if trace_launches[name] != bounces[0]:
            fail(f"the transmission trace launched {name} {trace_launches[name]} times over {bounces[0]} bounces")
    for which, (o, d, tris_, table) in zip(("first", "last"), kept_fh[0]):
        check_small(f"transmission trace's {which} bounce", o, d, tris_, table)
    for which, (s_, e_, tris_, tree) in zip(("first", "last"), kept_ah[0]):
        check_any_hit("any_hit", f"transmission trace's {which} bounce", s_, e_, tris_, tree,
                      lambda s_=s_, e_=e_, tris_=tris_, tree=tree: ck.segments_occluded(s_, e_, tris_, tree))
    for rays, pair in kept_dep.items():
        for which, (a, kw) in zip(("first", "last"), pair):
            check_deposit("deposit_histogram", a, kw, f"the transmission trace's {which} bounce of {rays} rays")


def assets_phase(mesh, renderer, scene_inputs: tuple, out: Path, dev) -> dict:
    """Real datasets' assets on the card: the codecs (`codec_check`), the GLB
    room and its repair (`glb_check`), the `--assets 9A` CLI with the GLB
    room and 8 stand-ins at 1 and 2 prep workers (`assets_cli_check`), a
    file bed and a predefined trajectory in the flagship room
    (`ambience_and_predefined_check`), an FOA CLI scene whose foreground
    holds the MP3 (where decodable) and a FLAC, and transmission
    (`transmission_check`). Returns the --assets CLI's launches."""
    from audiblelight_tpu_torch import seld
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    fg = codec_check(out / "codecs")
    mesh_dir = glb_check(mesh, out)
    cli_fg = out / "fg"
    for wav in sorted((REPO / "tests" / "resources" / "soundevents").glob("*/*.wav")):
        (cli_fg / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, cli_fg / wav.parent.name / wav.name)
    launches = assets_cli_check(cli_fg, mesh_dir, out)

    ambience_and_predefined_check(mesh, renderer, cli_fg, out, dev)

    n_files = str(len(list(fg.glob("*/*"))))
    argv = ["--fg-dir", str(fg), "--output-dir", str(out / "codec_cli"), "--mesh", str(OUT / "cli" / "room.obj"),
            *CODEC_CLI_FLAGS, "--min-events-static", n_files, "--max-events-static", n_files]
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    seconds = seld.main(argv)
    torch.cuda.synchronize()
    meta = json.loads((out / "codec_cli/metadata_dev/dev-train-alight/fold1_scene1_000.json").read_text())
    used = sorted(Path(ev["filepath"]).suffix for ev in meta["events"].values())
    want = sorted(p.suffix for p in fg.glob("*/*"))
    print(f"FOA CLI scene with a foreground of {want}: {seconds[0]:.3f} s (host clock), events from {used}; launches "
          f"{dict(ck.launch_counts)}", flush=True)
    if used != want:
        fail(f"the codec CLI scene used {used}, not {want}")
    for name in FOA_PATH:
        if ck.launch_counts[name] <= 0:
            fail(f"the codec CLI scene never launched {name}")

    transmission_check(mesh, renderer, scene_inputs, dev)
    return launches


MEDIA_IMAGE = REPO / "tests" / "resources" / "images" / "femaleSpeech" / "21_0.jpg"
VIDEO_SECONDS = 10.0  # 100 frames at the Scene's 10 fps
AIMG_CLI_FLAGS = ["--n-scenes", "2"]  # the entry's defaults otherwise: 10 s shoebox Eigenmike32 scenes
DOA_FLAGS = []  # the entry's defaults: 8 azimuths
RANDOM_EVENTS_FLAGS = []  # the entry's defaults: one 60 s shoebox AmbeoVR scene
# Two scenes of 10 s: at 60 s the seed's second scene draws many moving
# events, whose order-12 image sources at 44.1 kHz would take most of the phase
SCENE_TIMING_FLAGS = ["--n-scenes", "2", "--duration", "10"]
DCASE_FLAGS = []
AIMG_CPU_FRAMES = 150  # frames of the flagship image re-solved on the CPU (the chain is causal)
TRACE_KERNELS = ("first_hit_big", "any_hit", "deposit_histogram")


def card_memory() -> dict:
    """This card's `profiling.device_memory_stats()` entry."""
    from audiblelight_tpu_torch.profiling import device_memory_stats

    return device_memory_stats()[str(torch.device("cuda", 0))]


def trace_names(path: Path) -> set:
    """The event names of a Chrome-trace JSON."""
    return {ev.get("name", "") for ev in json.loads(path.read_text())["traceEvents"]}


def gif_frames(path: Path, fps: int = 10) -> int:
    """A GIF's video frames: PIL merges identical consecutive frames into one
    of their summed duration, so they are counted by duration."""
    from PIL import Image

    total = 0
    with Image.open(path) as im:
        for i in range(im.n_frames):
            im.seek(i)
            total += im.info["duration"]
    return total // int(1000 / fps)


def mp4_frames(path: Path) -> int:
    """An MP4's sample count, from its `stsz` box (H.264 or MJPEG)."""
    raw = path.read_bytes()
    i = raw.index(b"stsz")
    return int.from_bytes(raw[i + 12 : i + 16], "big")


def timers_check(renderer, scene_inputs: tuple, prof, out: Path, dev) -> dict:
    """(a) The stage timers: a synced empty stage's cost against an unsynced
    one; the flagship MIC scene's peak device memory (peak reset, one
    `render_mix`, read back through `device_memory_stats`); one flagship
    `render_mix` inside an `annotate` region under the trace capture, whose
    file must name the region and K1, K2 and K3's kernels."""
    from audiblelight_tpu_torch.profiling import Profiler, annotate, torch_trace
    from audiblelight_tpu_torch.render import ScenePlan

    src, s_idx, m_idx, plan, amb = scene_inputs
    caps = ambeovr_caps()
    args = (torch.as_tensor(src, device=dev), torch.as_tensor(caps, dtype=torch.float32, device=dev),
            renderer.rain_table(caps), torch.as_tensor(s_idx, device=dev), torch.as_tensor(m_idx, device=dev),
            ScenePlan.from_numpy(plan, dev), *amb)

    def render():
        return renderer.render_mix(torch.Generator(device=dev).manual_seed(51), *args)

    sync_ms = {}
    for sync in (True, False):
        p = Profiler(sync=sync)
        render()
        for _ in range(200):
            with p.stage("empty"):
                pass
        sync_ms[sync] = p.stages["empty"].mean_seconds * 1e3
    torch.cuda.synchronize()
    with prof.stage("memory"):
        torch.cuda.reset_peak_memory_stats()
        before = card_memory()
        wav = render()
        torch.cuda.synchronize()
        after = card_memory()
    print(f"stage timers: an empty stage with sync {sync_ms[True]:.4f} ms, without {sync_ms[False]:.4f} ms (host "
          f"clock, mean of 200); flagship MIC scene's peak device memory {after['peak_bytes_in_use'] / 2**30:.3f} GiB "
          f"({(after['peak_bytes_in_use'] - before['bytes_in_use']) / 2**30:.3f} GiB above the "
          f"{before['bytes_in_use'] / 2**30:.3f} GiB in use before it; limit {after['bytes_limit'] / 2**30:.1f} GiB)",
          flush=True)
    if int(wav.abs().max()) < 100 or after["peak_bytes_in_use"] < before["bytes_in_use"]:
        fail("the memory scene is silent or its peak is below what was in use")
    with prof.stage("trace capture"):
        with torch_trace(out / "trace") as cap:
            with annotate("flagship_render_mix"):
                render()
    names = trace_names(cap.path)
    found = {k: any(is_kernel(n, k) for n in names) for k in TRACE_KERNELS}
    print(f"trace capture: {cap.path.relative_to(OUT.parent)} ({cap.path.stat().st_size / 1e6:.2f} MB, "
          f"{len(names)} event names), region 'flagship_render_mix' {'flagship_render_mix' in names}, kernels {found}", flush=True)
    if "flagship_render_mix" not in names or not all(found.values()):
        fail("the trace capture does not name the region and K1, K2 and K3")
    return dict(sync_ms=sync_ms[True], peak_gib=after["peak_bytes_in_use"] / 2**30)


def acoustic_image_check(mesh, fg: Path, prof, out: Path, dev) -> None:
    """(b) A 60 s flagship MIC scene through `generate(compiled=True)` and
    `generate_acoustic_image` at the defaults (484 pixels, 9 bands, 600
    frames): the visibilities (host), the batched eigh, the APGD chain (CUDA
    events), the labels (host) and the HDF write timed; the first
    AIMG_CPU_FRAMES frames held against the port's CPU solve of the same
    visibilities (the chain is causal) within 1e-4 of the peak; the HDF read
    back by the port's reader, the JSON checked against the DCASE rows."""
    from audiblelight_tpu_torch import imaging
    from audiblelight_tpu_torch.core import Scene
    from audiblelight_tpu_torch.io import hdf5
    from audiblelight_tpu_torch.synthesize import generate_dcase2024_metadata
    from audiblelight_tpu_torch.utils import polar_to_cartesian

    scene = scene_in_flagship_room(mesh, fg, dev, 41, duration=SCENE_SECONDS)
    for event_type in ["static"] * N_STATIC + ["moving"]:
        scene.add_event(event_type=event_type, max_place_attempts=100)
    scene.add_ambience(noise="gaussian")
    (out / "image").mkdir(parents=True)
    with prof.stage("image scene"):
        scene.generate(output_dir=out / "image", compiled=True)
    kept, chain_ms = {}, []

    def timed(name, fn, events=False):
        def run(*a, **k):
            with prof.stage(name):
                if events:
                    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    t0.record()
                res = fn(*a, **k)
                if events:
                    t1.record()
            if events:
                chain_ms.append(t0.elapsed_time(t1))
            kept.setdefault(name, res)
            return res
        return run

    names = ("band_visibilities", "normalised_visibilities", "apgd_frames", "generate_acoustic_image_json")
    originals = {n: getattr(imaging, n) for n in names}
    write_hdf = Scene._generate_acoustic_image_hdf
    for n in names:
        setattr(imaging, n, timed(n, originals[n], events=n == "apgd_frames"))
    Scene._generate_acoustic_image_hdf = timed("hdf write", write_hdf)
    try:
        t0 = time.time()
        scene.generate_acoustic_image(output_dir=out / "image")
        image_s = time.time() - t0
        apgd = originals["apgd_frames"]
        sig = kept["band_visibilities"]
        s_norm = kept["normalised_visibilities"][:, :40]
        a_t = imaging._complex64(imaging.steering_operator(
            polar_to_cartesian(scene.state.microphones["mic000"].coordinates_polar).T, imaging.get_field(10)), dev)
        l_t = torch.tensor(2.0 * imaging.eigh_max(a_t, dev), dtype=torch.float32, device=dev)
        eager = imaging.apgd_frames_eager
        avgs, busy = profiled(lambda: eager(s_norm, a_t, l_t), "APGD chain profile, eager (40 frames)")
        _, busy_g = profiled(lambda: apgd(s_norm, a_t, l_t), "APGD chain profile, CUDA graph (40 frames)")
    finally:
        for n in names:
            setattr(imaging, n, originals[n])
        Scene._generate_acoustic_image_hdf = write_hdf
    img = scene.acoustic_image["mic000"]
    stats = prof.to_dict()
    print(f"acoustic image: {img.shape} {img.dtype} in {image_s:.3f} s (host clock); visibilities (host) "
          f"{stats['band_visibilities']['total_seconds']:.3f} s, batched eigh of {sig.shape[0]} x {sig.shape[1]} "
          f"matrices {stats['normalised_visibilities']['total_seconds'] * 1e3:.2f} ms, APGD chain {chain_ms[0]:.1f} ms "
          f"(CUDA events; {stats['apgd_frames']['total_seconds']:.3f} s host clock), labels (host) "
          f"{stats['generate_acoustic_image_json']['total_seconds']:.3f} s, HDF write "
          f"{stats['hdf write']['total_seconds'] * 1e3:.1f} ms on {card_line()}", flush=True)
    eager_40 = time_ms(lambda: eager(s_norm, a_t, l_t), reps=3)
    chain_40 = time_ms(lambda: apgd(s_norm, a_t, l_t), reps=3)
    same = torch.equal(apgd(s_norm, a_t, l_t), eager(s_norm, a_t, l_t))
    print(f"APGD chain, 40 frames (CUDA events): eager {eager_40:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / eager_40:.1%}, {launch_calls(avgs) / (40 * 50):.1f} launches per iteration; one frame as a "
          f"CUDA graph {chain_40:.2f} ms, device busy {busy_g:.2f} ms, idle share {1 - busy_g / chain_40:.1%}; "
          f"graph equal to eager bit for bit {same}", flush=True)
    if not same:
        fail("the APGD chain's CUDA graph differs from the eager chain")
    if img.shape != (484, 9, int(SCENE_SECONDS * 10)) or not np.isfinite(img).all() or img.min() < 0 or img.max() <= 0:
        fail(f"the flagship acoustic image is {img.shape}, min {img.min()}, max {img.max()}")

    n_cpu = AIMG_CPU_FRAMES
    a_c = a_t.cpu()
    l_c = torch.tensor(2.0 * imaging.eigh_max(a_c, "cpu"), dtype=torch.float32)
    t0 = time.time()
    cpu = imaging.apgd_frames(imaging.normalised_visibilities(imaging._complex64(sig[:, :n_cpu], torch.device("cpu"))),
                              a_c, l_c).permute(2, 0, 1).numpy()
    gap = float(np.abs(img[:, :, :n_cpu] - cpu).max() / np.abs(cpu).max())
    print(f"acoustic image against the port's CPU solve of the same visibilities (first {n_cpu} frames, "
          f"{time.time() - t0:.1f} s on the host): max |diff| / peak {gap:.3e}", flush=True)
    if not gap <= 1e-4:
        fail("the card's acoustic image disagrees with the CPU's")

    with hdf5.File(out / "image" / "acoustic_image_mic000.hdf") as f:
        data, attrs = f["ai_apgd"][()], dict(f.attrs.items())
    js = json.loads((out / "image" / "acoustic_image_metadata_mic000.json").read_text())
    rows = np.asarray(generate_dcase2024_metadata(scene, temporal_resolution=0.1)["mic000"])
    want = sum(int((rows[:, 0] == f).sum()) for f in np.unique(rows[:, 0]) if f < img.shape[2])
    blobs = sum(len(d["segmentation"]) for d in js)
    print(f"acoustic image files: HDF {data.shape} {data.dtype} equal to the image {np.array_equal(data, img)}, "
          f"attributes {attrs}; JSON {len(js)} entries ({want} DCASE rows in the image's frames), {blobs} blobs",
          flush=True)
    if (not np.array_equal(data, img) or attrs["ai_n_frames"] != 484 or attrs["ai_n_bands"] != 9 or len(js) != want
            or not blobs or {d["category_id"] for d in js} - set(CLI_CLASSES.values())):
        fail("the acoustic image's HDF or JSON")


def entries_check(fg: Path, prof, out: Path) -> None:
    """(c) and (e) The entries at their defaults, as a user calls them: the
    acoustic-image CLI (two 10 s shoebox Eigenmike32 scenes, its APGD chain
    by CUDA events), MUSIC DOA (8 azimuths), random events (one scene),
    the DCASE converter on their outputs and the scene timer (two scenes)."""
    from audiblelight_tpu_torch import acoustic_images, dcase_format, imaging, music_doa, random_events, scene_timing

    chain = []
    apgd = imaging.apgd_frames

    def timed_apgd(*a, **k):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        res = apgd(*a, **k)
        t1.record()
        t1.synchronize()
        chain.append(t0.elapsed_time(t1))
        return res

    imaging.apgd_frames = timed_apgd
    try:
        with prof.stage("acoustic_images CLI"):
            secs = acoustic_images.main(["--fg-dir", str(fg), "--output-dir", str(out / "aimg_cli"), *AIMG_CLI_FLAGS])
    finally:
        imaging.apgd_frames = apgd
    scenes = sorted(p for p in (out / "aimg_cli").iterdir() if p.is_dir())
    files = [sorted(p.name for p in d.iterdir()) for d in scenes]
    print(f"acoustic_images CLI: {len(secs)} scenes, {', '.join(f'{x:.3f}' for x in secs)} s each (host clock); APGD "
          f"chain {', '.join(f'{x:.1f}' for x in chain)} ms (CUDA events); files {files[0] if files else None}",
          flush=True)
    if len(secs) != 2 or any(f != ["acoustic_image_metadata_mic000.json", "acoustic_image_mic000.hdf",
                                   "audio_out_mic000.wav", "metadata_out.json", "metadata_out_mic000.csv"]
                             for f in files):
        fail("the acoustic_images CLI's scenes")

    with prof.stage("music_doa"):
        errors = music_doa.main(DOA_FLAGS)
    print(f"music_doa: errors {', '.join(f'{e:.1f}' for e in errors)} deg (mean {np.mean(errors):.2f}, max "
          f"{np.max(errors):.2f})", flush=True)
    if len(errors) != 8 or not np.isfinite(errors).all():
        fail("music_doa")

    with prof.stage("random_events"):
        secs = random_events.main(["--fg-dir", str(fg), "--output-dir", str(out / "random_events"),
                                   *RANDOM_EVENTS_FLAGS])
    written = sorted(p.relative_to(out).as_posix() for p in (out / "random_events").rglob("*") if p.is_file())
    print(f"random_events: {secs[0]:.3f} s (host clock), {written}", flush=True)
    if written != [f"random_events/scene_0000/{n}" for n in ("audio_out_mic000.wav", "metadata_out.json",
                                                             "metadata_out_mic000.csv")]:
        fail("random_events' files")

    with prof.stage("dcase_format"):
        n_cli = dcase_format.main(["--input-dir", str(OUT / "cli" / "mic"), "--output-dir", str(out / "dcase_cli"),
                                   *DCASE_FLAGS])
        n_img = dcase_format.main(["--input-dir", str(out / "aimg_cli"), "--output-dir", str(out / "dcase"),
                                   *DCASE_FLAGS])
        n_rand = dcase_format.main(["--input-dir", str(out / "random_events"), "--output-dir", str(out / "dcase"),
                                    "--room", "2", *DCASE_FLAGS])
    converted = sorted(p.relative_to(out / "dcase").as_posix() for p in (out / "dcase").rglob("*") if p.is_file())
    print(f"dcase_format: the SELD CLI's output {n_cli} (already the DCASE layout: its WAVs and CSVs in separate "
          f"folders, so the converter, as the reference's, pairs none); the acoustic-image and random-event scenes "
          f"{n_img} + {n_rand}: {converted}", flush=True)
    if n_cli != 0 or (n_img, n_rand) != (2, 1) or len(converted) != 6:
        fail("dcase_format")

    import contextlib
    import io as _io

    buf = _io.StringIO()
    with prof.stage("scene_timing"), contextlib.redirect_stdout(buf):
        total, done = scene_timing.main(["--output-dir", str(out / "scene_timing"), *SCENE_TIMING_FLAGS])
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"scene_timing: {line}", flush=True)
    if done != 2 or not re.fullmatch(r"total_seconds=\d+\.\d\d avg_seconds_per_scene=\d+\.\d\d\d", line):
        fail("scene_timing")


def video_check(mesh, renderer, fg: Path, pil: bool, prof, out: Path, dev) -> dict:
    """(d) The flagship room's panorama from the microphone at 640 x 320:
    one K1 big launch of 204,800 rays on the full 110,592-face mesh, held
    against K1's plain versions on the same rays (t and faces bit for bit,
    so the pixels equal the plain route's), timed with its bound; then, where
    PIL imports, `generate(compiled=True, video=True)` of a 10 s scene in the
    flagship room with an event image, its MP4, AVI and GIF of 100 frames,
    the MP4 decoded where the H.264 shim loads. Returns the video scene's
    launches (None without PIL)."""
    from audiblelight_tpu_torch.io.avi import read_avi_frame_count
    from audiblelight_tpu_torch.io.h264 import h264_available, read_video_frames
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.viz import panorama

    st = renderer.state
    table = st.first_hit_table(st.tris)
    width, height = 640, 320
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    with prof.stage("panorama"):
        img = panorama.render_equirect_panorama(st.tris, MIC_CENTRE, width, height, table=table)
    launches = dict(ck.launch_counts)
    print(f"panorama: {img.shape} {img.dtype}, {len(np.unique(img.reshape(-1, 3), axis=0))} tones; launches "
          f"{launches}", flush=True)
    check_first_hits(launches, 1, "the panorama")
    dirs = torch.as_tensor(panorama._equirect_dirs(width, height), device=dev)
    o = torch.tensor(MIC_CENTRE, dtype=torch.float32, device=dev).expand(dirs.shape[0], 3).contiguous()
    check_k1(f"panorama's {o.shape[0]} pixel rays on the full mesh", o, dirs, st.tris, table)
    t_p, i_p = ck.ray_first_hit_plain(o, dirs, st.tris, table)
    plain_img = panorama.shade(st.tris.cpu().numpy(), MIC_CENTRE, width, height, t_p.cpu().numpy(),
                               i_p.cpu().numpy())
    needed, _ = first_hit_pairs(o, dirs, t_p, i_p, face_boxes(st.tris))
    r, f = o.shape[0], st.tris.shape[0]
    b_ms, b_by = bound_ms(needed * FLOPS_BIG_PAIR, r * 24 + f * 64 + r * 8)
    k1_ms = time_ms(lambda: ck.ray_first_hit(o, dirs, st.tris, table))
    k1_dev = device_ms(lambda: ck.ray_first_hit(o, dirs, st.tris, table))
    whole = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        panorama.render_equirect_panorama(st.tris, MIC_CENTRE, width, height, table=table)
        whole.append(time.time() - t0)
    print(f"panorama K1: {k1_ms:.4f} ms per launch (device {k1_dev:.4f} ms), bound {b_ms:.5f} ms ({b_by}; {needed} "
          f"pairs this data needs, {needed / (r * f):.4%} of dense); pixels equal to the plain route's "
          f"{np.array_equal(img, plain_img)}; whole panorama {np.median(whole) * 1e3:.1f} ms (host clock, median of "
          f"3, shading included) on {card_line()}", flush=True)
    if not np.array_equal(img, plain_img):
        fail("the panorama differs from the plain route's")
    if not pil:
        print("scene video: skipped, PIL is absent", flush=True)
        return None

    scene = scene_in_flagship_room(mesh, fg, dev, 43, duration=VIDEO_SECONDS)
    event = scene.add_event(event_type="static", image_filepath=MEDIA_IMAGE, max_place_attempts=100)
    scene.add_event(event_type="moving", max_place_attempts=100)
    scene.add_ambience(noise="gaussian")
    (out / "video").mkdir(parents=True)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    with prof.stage("video scene"):
        t0 = time.time()
        scene.generate(output_dir=out / "video", compiled=True, video=True)
        torch.cuda.synchronize()
        video_s = time.time() - t0
    v_launches = dict(ck.launch_counts)
    files = sorted(p.name for p in (out / "video").iterdir())
    counts = dict(mp4=mp4_frames(out / "video/video_out.mp4"), avi=read_avi_frame_count(out / "video/video_out.avi"),
                  gif=gif_frames(out / "video/video_out.gif"))
    raw = (out / "video/video_out.mp4").read_bytes()
    codec = "H.264" if b"avc1" in raw else "MJPEG"
    decoded = None
    if h264_available():
        it, w, h, _ = read_video_frames(out / "video/video_out.mp4")
        frames = list(it)
        decoded = (len(frames), w, h, float(np.mean([fr.mean() for fr in frames])))
    print(f"scene video: a {VIDEO_SECONDS:.0f} s scene in the flagship room with the image {MEDIA_IMAGE.name} on "
          f"{event.alias}, generate(compiled=True, video=True) in {video_s:.3f} s (host clock); files {files}; frames {counts}; MP4 "
          f"{codec}, decoded {decoded}; launches {v_launches}", flush=True)
    n_frames = int(round(VIDEO_SECONDS * scene.video_fps))
    if set(counts.values()) != {n_frames} or (decoded is not None and decoded[:3] != (n_frames, width, height)):
        fail("the scene video's frames")
    for name in ("first_hit_big", "any_hit", "deposit_histogram"):
        if v_launches[name] <= 0:
            fail(f"the video scene never launched {name}")
    # One launch a bounce of the plan path's trace, one for the panorama
    check_first_hits(v_launches, int(ENGINE["indirect_ray_depth"]) + 1, "the video scene")
    return v_launches


def media_phase(mesh, renderer, scene_inputs: tuple, fg: Path, out: Path, dev) -> dict:
    """Stage timers, acoustic imaging, MUSIC DOA, the scene video and the
    Scene-API entries on the card (`timers_check`, `acoustic_image_check`,
    `video_check`, `entries_check`), their stages timed by a
    `Profiler(sync=True)` whose report is printed. Returns the panorama's
    and video scene's launches."""
    from audiblelight_tpu_torch.io.h264 import h264_available
    from audiblelight_tpu_torch.profiling import Profiler

    try:
        import PIL

        pil = PIL.__version__
    except ImportError:
        pil = None
    shim = h264_available()
    print(f"media: PIL {pil if pil else 'absent'}; H.264 shim {'built and loaded' if shim else 'unavailable'}",
          flush=True)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    prof = Profiler(sync=True)
    timers = timers_check(renderer, scene_inputs, prof, out, dev)
    acoustic_image_check(mesh, fg, prof, out, dev)
    entries_check(fg, prof, out)
    launches = video_check(mesh, renderer, fg, pil is not None, prof, out, dev)
    print("media phase stages (Profiler(sync=True)):\n" + prof.report(), flush=True)
    return dict(timers, video_launches=launches)



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "audiblelight_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the audiblelight_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
    from audiblelight_tpu_torch.micarrays import ambeovr_capsules
    from audiblelight_tpu_torch.ops import build
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.ops import star_occlusion as so
    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer, write_wav
    from audiblelight_tpu_torch.render import ScenePlan
    from audiblelight_tpu_torch.rir.raytracer import _sphere_directions
    from audiblelight_tpu_torch.utils import norm3

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # 1. Build every kernel (one nvcc per source, all at once)
    t0 = time.time()
    reports = build.build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, rep in reports.items():
        func = name
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                func = next(k for k in KERNELS if f"{k}_kernel" in line)
            if "registers" in line or "spill" in line:
                print(f"ptxas {func}: {line.strip()}")

    # 2. The flagship room and its device state
    t0 = time.time()
    mesh = scanned_like_room(extents=(7.0, 5.0, 3.0), seed=0)
    caps = ambeovr_capsules(MIC_CENTRE)
    t_scene = int(SCENE_SECONDS * SR)
    renderer = FusedSceneRenderer.from_mesh(mesh, ENGINE, caps, BUCKETS, N_SOURCES, t_scene, device=dev)
    st = renderer.state
    n_full, n_lod = st.tris.shape[0], st.acoustic_tris.shape[0]
    print(f"room: {n_full} faces, acoustic LOD {n_lod} faces, convex={st.convex}, "
          f"{time.time() - t0:.1f} s", flush=True)
    if n_full != 110592 or st.convex or not 3000 < n_lod <= 4096:
        fail("unexpected flagship room")
    listeners = torch.as_tensor(caps, dtype=torch.float32, device=dev)
    face_occ = renderer.rain_table(caps)
    rng = np.random.default_rng(0)
    results = {}

    elapsed(t_start, "kernels against their plain versions")
    # 3. Each kernel against its plain version at the flagship shapes
    # K1: one decimation phase's first bounce, 80k rays from interior points
    gen = torch.Generator(device=dev).manual_seed(1)
    src0, *_ = flagship_inputs(st.tris, np.random.default_rng(1), dev)
    origins = torch.as_tensor(src0, device=dev).repeat_interleave(5000, dim=0)
    dirs = _sphere_directions(gen, origins.shape[0], dev)
    table_lod = st.first_hit_table(st.acoustic_tris)
    build_lod_ms = table_build_ms(st.acoustic_tris)
    build_full_ms = table_build_ms(st.tris)
    print(f"first_hit_big face trees: LOD {table_lod[3]} built in {build_lod_ms:.3f} ms, full mesh "
          f"{st.first_hit_table(st.tris)[3]} in {build_full_ms:.3f} ms (host clock, synchronised)", flush=True)
    t_k, i_k = ck.ray_first_hit(origins, dirs, st.acoustic_tris, table_lod)
    r, f = origins.shape[0], n_lod
    needed, _ = first_hit_pairs(origins, dirs, t_k, i_k, face_boxes(st.acoustic_tris))
    b_ms, b_by = bound_ms(needed * FLOPS_BIG_PAIR, r * 24 + f * 64 + r * 8)
    print(f"first_hit_big: (ray, face) pairs this data needs {needed} ({needed / (r * f):.3%} of dense), bound "
          f"{b_ms:.5f} ms ({b_by})", flush=True)
    check_k1("interior rays on the LOD", origins, dirs, st.acoustic_tris, table_lod, results, (b_ms, b_by))
    # K1 small (F <= 512) on the same 80k rays against 500 faces of the LOD
    # (its path is the small-room phase below)
    small = st.acoustic_tris[:500].contiguous()
    t0 = time.time()
    table_small = ck.first_hit_table(small)
    torch.cuda.synchronize()
    print(f"first_hit_small face tree (the any-hit tree): {table_small[3]} built in {(time.time() - t0) * 1e3:.3f} "
          f"ms (host clock, first build)", flush=True)
    check_small("interior rays on 500 faces of the LOD", origins, dirs, small, table_small)

    # K2: the rain table's segments, 640k diffraction-like legs on the LOD,
    # and 64 direct-path segments on the full mesh
    centroids = st.acoustic_tris.mean(dim=1)
    lpt = listeners.mean(dim=0, keepdim=True)
    n_or = torch.where(((st.acoustic_normals * (lpt - centroids)).sum(-1) >= 0)[:, None],
                       st.acoustic_normals, -st.acoustic_normals)
    rain = (centroids + 1e-4 * n_or, lpt.expand(n_lod, 3).contiguous(), st.acoustic_tris)
    lo = torch.tensor([0.3, 0.3, 0.3], device=dev)
    span = torch.tensor([6.4, 4.4, 1.9], device=dev)
    g2 = torch.Generator(device=dev).manual_seed(2)
    legs = (lo + span * torch.rand(640_000, 3, generator=g2, device=dev),
            lo + span * torch.rand(640_000, 3, generator=g2, device=dev), st.acoustic_tris)
    src_t = torch.as_tensor(src0, device=dev)
    direct = (listeners.repeat(16, 1), src_t.repeat_interleave(4, dim=0), st.tris)
    tree_lod, tree_full = st.any_hit_tree(st.acoustic_tris), st.any_hit_tree(st.tris)
    print(f"any_hit face trees: LOD {tree_lod} built in {tree_build_ms(st.acoustic_tris):.3f} ms, full mesh "
          f"{tree_full} in {tree_build_ms(st.tris):.3f} ms (host clock, synchronised)", flush=True)
    for label, (s_, e_, tris_), tree in (("rain table", rain, tree_lod), ("640k random legs", legs, tree_lod),
                                         ("direct segments on the full mesh", direct, tree_full)):
        check_any_hit("any_hit", label, s_, e_, tris_, tree,
                      lambda s_=s_, e_=e_, tris_=tris_, tree=tree: ck.segments_occluded(s_, e_, tris_, tree))

    # K3: one bounce's worth, 16 sources x 5000 rays hitting the LOD
    t_h, face = ck.ray_first_hit(origins, dirs, st.acoustic_tris)
    ok = torch.isfinite(t_h)
    hit = (origins + torch.where(ok, t_h, 0.0)[:, None] * dirs).contiguous()
    normal = st.acoustic_normals[face.clamp_min(0).long()]
    normal = torch.where(((normal * dirs).sum(-1) > 0)[:, None], -normal, normal).contiguous()
    e_refl = (torch.rand(r, 4, generator=g2, device=dev) * 2e-4).contiguous()
    dist = (torch.where(ok, t_h, 0.0) + 300.0 * torch.rand(r, generator=g2, device=dev)).contiguous()
    occ = (face_occ[:, face.clamp_min(0).long()].expand(4, r) | ~ok[None]).contiguous()
    kw = dict(n_sources=16, n_bins=501, bin_dt=0.002, c_sound=343.0)
    dep_args = (hit, normal, e_refl, dist, occ, listeners)
    results["deposit_histogram"] = check_deposit("deposit_histogram", dep_args, kw,
                                                 "80k rays of one bounce, arrivals spread over 300 m")
    # K4: the same bounce at one FOA listener point (the rig's centre)
    lis1 = torch.tensor([MIC_CENTRE], dtype=torch.float32, device=dev)
    foa_args = (hit, normal, e_refl, dist, (face_occ[:, face.clamp_min(0).long()] | ~ok[None]).contiguous(), lis1)
    results["deposit_histogram_foa"] = check_deposit("deposit_histogram_foa", foa_args, kw,
                                                     "80k rays of one bounce, arrivals spread over 300 m")
    del legs, rain, foa_args

    # K6 in the exact rain mode's room state (the full mesh is the acoustic
    # mesh): 80k hit points of one bounce on the 110,592 faces, toward the
    # AmbeoVR centroid and toward one capsule; K1 timed there too
    from audiblelight_tpu_torch.worldstate.mesh_backend import MeshDeviceState

    st_x = MeshDeviceState.from_mesh(mesh, dict(ENGINE, mesh_simplification=False, rain_visibility="auto",
                                                ray_decimation=False), device=dev)
    table_x = ck.first_hit_table(st_x.tris)
    t_x, face_x = ck.ray_first_hit(origins, dirs, st_x.tris, table_x)
    ok_x = torch.isfinite(t_x)
    hit_x = origins + torch.where(ok_x, t_x, 0.0)[:, None] * dirs
    n_x = st_x.acoustic_normals[face_x.clamp_min(0).long()]
    n_x = torch.where(((n_x * dirs).sum(-1) > 0)[:, None], -n_x, n_x)
    starts_x = (hit_x + 1e-4 * n_x)[ok_x].contiguous()
    needed, _ = first_hit_pairs(origins, dirs, t_x, face_x, face_boxes(st_x.tris))
    b_ms, b_by = bound_ms(needed * FLOPS_BIG_PAIR, r * 24 + n_full * 64 + r * 8)
    k1_full_ms = time_ms(lambda: ck.ray_first_hit(origins, dirs, st_x.tris, table_x), reps=5)
    print(f"first_hit_big on the full mesh: {r} rays x {n_full} faces: {k1_full_ms:.3f} ms per launch, bound "
          f"{b_ms:.5f} ms ({b_by}, {needed} pairs this data needs, {needed / (r * n_full):.3%} of dense)",
          flush=True)
    centroid = caps.mean(axis=0)
    r_caps = float(np.linalg.norm(caps - centroid, axis=1).max()) + 0.02
    star_faces = torch.as_tensor(so.star_faces(st_x.tris.cpu().numpy()), device=dev)
    print(f"star_any_hit face tree: {st_x.star_accel_for(centroid, 0.02).tree} built in "
          f"{tree_build_ms(st_x.tris, star_faces):.3f} ms (host clock, synchronised)", flush=True)
    for label, end, r_pad in (("centroid", listeners.mean(dim=0), 0.02), ("capsule 0", listeners[0], r_caps)):
        star = st_x.star_accel_for(centroid, r_pad)
        if star is None:
            fail(f"no star layout toward the {label}")
        ends_x = end.expand(starts_x.shape[0], 3).contiguous()
        check_any_hit("star_any_hit", f"{starts_x.shape[0]} hit points toward the {label}", starts_x, ends_x,
                      st_x.tris, star.tree, lambda star=star, end=end: so.star_segments_occluded(star, starts_x, end),
                      results if "star_any_hit" not in results else None)
        tree_x = st_x.any_hit_tree(st_x.tris)
        print(f"any_hit on the same segments through the full mesh's tree: "
              f"{time_ms(lambda: ck.segments_occluded(starts_x, ends_x, st_x.tris, tree_x)):.4f} ms", flush=True)

    # K5 at the flagship bounce of the HOA3 (16 channels x 4 bands) and
    # binaural (2 x 4) rigs: 16 sources x 5,000 rays, 501 bins; bins from
    # that bounce's arrivals at the rig's centre, some rays out of range
    d_c = norm3(torch.tensor(MIC_CENTRE, device=dev) - hit)
    bins5 = ((dist + d_c) / 343.0 / 0.002).to(torch.int32).reshape(16, 5000)
    bins5 = torch.where(bins5 < 501, bins5, -1).contiguous()
    for label, k in (("hoa3", 64), ("binaural", 8)):
        dep5 = (torch.rand(16, 5000, k, generator=g2, device=dev) * 1e-6).contiguous()
        h_k = ck.bin_histogram(bins5, dep5, 501)
        h_p = ck.bin_histogram_plain(bins5, dep5, 501)
        bins_bad = int(((h_k != 0) != (h_p != 0)).sum())
        peak = h_p.abs().amax().clamp_min(1e-30)
        err = float((h_k - h_p).abs().max())
        ok5 = bool(((h_k - h_p).abs() <= 1e-5 * h_p.abs() + 1e-6 * peak).all())
        print(f"check bin_histogram {label}: (16, 5000, {k}) -> {tuple(h_k.shape)}: bin mismatches {bins_bad}, "
              f"max |diff| {err:.3e}, max |diff| / peak {err / float(peak):.3e}", flush=True)
        if bins_bad or not ok5:
            fail(f"bin_histogram disagrees with its plain version ({label})")
        flat5 = (torch.arange(16, device=dev)[:, None] * 501 + bins5.clamp_min(0)).reshape(-1).long()
        vals5 = torch.where((bins5 >= 0)[..., None], dep5, 0.0).reshape(-1, k)
        out5 = torch.zeros(16 * 501, k, device=dev)
        b_ms, b_by = bound_ms(16 * 5000 * k, 16 * 5000 * (4 * k + 4) + h_k.numel() * 4)
        res5 = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                    ms=time_ms(lambda: ck.bin_histogram(bins5, dep5, 501)),
                    plain_ms=time_ms(lambda: ck.bin_histogram_plain(bins5, dep5, 501), reps=3),
                    library_ms=time_ms(lambda: out5.index_add_(0, flat5, vals5)))
        print(f"bin_histogram {label}: {res5['ms']:.4f} ms per call (device "
              f"{device_ms(lambda: ck.bin_histogram(bins5, dep5, 501)):.4f}), plain {res5['plain_ms']:.4f} ms, "
              f"index_add_ {res5['library_ms']:.4f} ms (device {device_ms(lambda: out5.index_add_(0, flat5, vals5)):.4f}), "
              f"bound {b_ms:.5f} ms ({b_by}); deterministic {torch.equal(h_k, ck.bin_histogram(bins5, dep5, 501))}",
              flush=True)
        if label == "hoa3":
            results["bin_histogram"] = res5
    del t_x, face_x, hit_x, n_x, ends_x

    elapsed(t_start, "main path")
    # 4. The main path: three flagship scenes through the fused renderer
    OUT.mkdir(parents=True, exist_ok=True)
    scenes = [flagship_inputs(st.tris, np.random.default_rng(100 + i), dev) for i in range(3)]
    tree_builds, restore_builds = count_tree_builds()
    ck.reset_launch_counts()
    scene_s, payloads = [], []
    for i, (src, s_idx, m_idx, plan, amb) in enumerate(scenes):
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        torch.cuda.synchronize()
        t0 = time.time()
        wav = renderer.render_mix(
            gen, torch.as_tensor(src, device=dev), listeners, face_occ,
            torch.as_tensor(s_idx, device=dev), torch.as_tensor(m_idx, device=dev),
            ScenePlan.from_numpy(plan, dev), *amb,
        )
        torch.cuda.synchronize()
        scene_s.append(time.time() - t0)
        payloads.append(wav)
    launches = dict(ck.launch_counts)
    restore_builds()
    print(f"main path: 3 scenes in {sum(scene_s):.2f} s ({', '.join(f'{x:.3f}' for x in scene_s)} s); "
          f"launches {launches}; any-hit trees built {tree_builds}", flush=True)
    if tree_builds:
        fail("the main path built an any-hit tree: every query must walk the room's cached trees")
    for name in MIC_PATH:
        if launches[name] <= 0:
            fail(f"the main path never launched {name}")
    check_first_hits(launches, 60 * len(scenes), "the main path")

    # 5. Outputs: WAVs written, shaped and not silent; direct paths on time
    for i, wav in enumerate(payloads):
        if wav.dtype != torch.int16 or tuple(wav.shape) != (4, t_scene):
            fail(f"scene {i}: payload {wav.dtype} {tuple(wav.shape)}")
        peak = int(wav.abs().max())
        if peak < 100:
            fail(f"scene {i}: silent (peak {peak})")
        path = write_wav(OUT / f"scene{i}.wav", wav, SR)
        print(f"scene {i}: {path.relative_to(REPO)} {tuple(wav.shape)} int16, peak {peak}, "
              f"rms {float(wav.float().pow(2).mean().sqrt()):.1f}")
    src, *_ = scenes[0]
    src_t = torch.as_tensor(src, device=dev)
    # The trace keeps its first bounce's rays on the LOD for the K9/K10
    # phase, and its largest any-hit query (the diffraction graph's legs)
    from audiblelight_tpu_torch.rir import raytracer

    first_bounce, real_legs = [], []

    def keep_first_bounce(o, d, prev_face, tris, route):
        if not first_bounce:
            first_bounce.append((tris, o.clone(), d.clone()))
        return first_hit_route(o, d, prev_face, tris, route)

    def keep_legs(starts, ends, tris, tree=None):
        if not real_legs or starts.shape[0] > real_legs[0][0].shape[0]:
            real_legs[:] = [(starts.clone(), ends.clone(), tris, tree)]
        return ck.segments_occluded(starts, ends, tris, tree)

    first_hit_route, segments_occluded_query = raytracer._first_hit_route, raytracer.segments_occluded
    mic_bounces = {}
    raytracer._first_hit_route = keep_first_bounce
    raytracer.segments_occluded = keep_legs
    raytracer.deposit_histogram = keep_deposits("deposit_histogram", mic_bounces)
    try:
        irs = renderer.trace(torch.Generator(device=dev).manual_seed(7), src_t, listeners, face_occ)
    finally:
        raytracer._first_hit_route = first_hit_route
        raytracer.segments_occluded = segments_occluded_query
        raytracer.deposit_histogram = ck.deposit_histogram
    # K3 on the trace's own bounces: the first and last of each decimation phase
    check_deposit_bounces("deposit_histogram", mic_bounces, "flagship MIC trace")
    del mic_bounces
    # K2 on the scene's own diffraction legs, the largest query of its path
    l_s, l_e, l_tris, l_tree = real_legs[0]
    if l_tree is None or l_s.shape[0] < 100_000:
        fail(f"the trace's largest any-hit query had {l_s.shape[0]} segments and tree {l_tree}")
    check_any_hit("any_hit", "flagship scene's diffraction legs", l_s, l_e, l_tris, l_tree,
                  lambda: ck.segments_occluded(l_s, l_e, l_tris, l_tree), results)
    del real_legs
    blocked = ck.segments_occluded(listeners.repeat(N_SOURCES, 1),
                                   src_t.repeat_interleave(4, dim=0), st.tris).reshape(N_SOURCES, 4)
    dist_ec = torch.linalg.vector_norm(src_t[:, None] - listeners[None], dim=-1)
    expect = (dist_ec / 343.0 * SR).cpu().numpy()  # (E, C) samples
    ir_ec = irs.transpose(0, 1).abs().cpu().numpy()  # (E, C, L)
    free = ~blocked.cpu().numpy()
    # The peak of the IR within 2 ms of the direct arrival: reflections and
    # diffuse rain near the rig can top the direct path later in the IR
    win = 48
    off, global_hits = [], 0
    for e, c in zip(*np.nonzero(free)):
        lo = max(int(expect[e, c]) - win, 0)
        off.append(abs(lo + int(np.argmax(ir_ec[e, c, lo : int(expect[e, c]) + win])) - expect[e, c]))
        global_hits += abs(int(np.argmax(ir_ec[e, c])) - expect[e, c]) <= 2.0
    off = np.array(off)
    print(f"direct paths: {int(free.sum())} of {free.size} (source, capsule) pairs unoccluded; "
          f"max |peak within 2 ms - d/c| {off.max():.2f} samples; the direct path is the whole "
          f"IR's peak in {global_hits} of them")
    if not free.any() or off.max() > 2.0 or global_hits < 0.9 * len(off):
        fail("direct-path arrivals off their distance")

    elapsed(t_start, "scene time and profile")
    # 6. Where a scene's time goes: scene and trace time by CUDA events, the
    # cached rain table, and the device time per op and per kernel from the
    # profiler (busy time over wall time gives the device's idle share)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    src, s_idx, m_idx, plan, amb = scenes[0]
    src_t, s_idx_t, m_idx_t = (torch.as_tensor(x, device=dev) for x in (src, s_idx, m_idx))
    splan = ScenePlan.from_numpy(plan, dev)

    def scene():
        renderer.render_mix(torch.Generator(device=dev).manual_seed(5), src_t, listeners, face_occ,
                            s_idx_t, m_idx_t, splan, *amb)

    def trace():
        renderer.trace(torch.Generator(device=dev).manual_seed(5), src_t, listeners, face_occ)

    from audiblelight_tpu_torch.rir.raytracer import face_rain_occlusion

    scene_ms, trace_ms = time_ms(scene, reps=3), time_ms(trace, reps=3)
    rain_ms = time_ms(lambda: face_rain_occlusion(st.acoustic_tris, st.acoustic_normals, lpt), reps=3)
    print(f"scene time (CUDA events): median {scene_ms:.3f} ms; trace {trace_ms:.3f} ms "
          f"({trace_ms / scene_ms:.1%}); rain table (cached per room and rig, not in the scene) "
          f"{rain_ms:.3f} ms")

    avgs, busy = profiled(scene, "scene profile")
    _, busy_trace = profiled(trace, "trace profile")
    if busy > 0:
        print(f"device idle share: scene {1 - busy / scene_ms:.1%}, trace {1 - busy_trace / trace_ms:.1%} "
              f"(busy time from the profiler over the unprofiled CUDA-event time)")
    if not kernel_times(avgs, MIC_PATH, "per scene"):
        print("per scene: kernel times not measured (the profiler saw no device time)")
    print(f"scene time: median {np.median(scene_s):.3f} s (host clock) over 3 scenes of "
          f"{SCENE_SECONDS:.0f} s on {card}")

    elapsed(t_start, "K8 route")
    # 6b. The acoustic LOD through the bilinear first hit (K8)
    mxu_n = mxu_phase(renderer, (src_t, listeners, face_occ, s_idx_t, m_idx_t, splan, amb), t_scene, results)

    elapsed(t_start, "SELD CLI")
    # 7. The second main path: the SELD dataset CLI in the flagship room, MIC
    # then FOA, two scenes each; launches counted per run
    from audiblelight_tpu_torch import seld
    from audiblelight_tpu_torch.geometry.mesh import save_obj

    cli_root = OUT / "cli"
    shutil.rmtree(cli_root, ignore_errors=True)
    fg = cli_root / "fg"
    for wav in sorted((REPO / "tests" / "resources" / "soundevents").glob("*/*.wav")):
        (fg / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, fg / wav.parent.name / wav.name)
    room_obj = save_obj(mesh, cli_root / "room.obj")
    cli_launches, cli_seconds = {}, {}
    for layout, path in (("mic", MIC_PATH), ("foa", FOA_PATH)):
        argv = ["--fg-dir", str(fg), "--output-dir", str(cli_root / layout), "--mesh", str(room_obj),
                "--channel-layout", layout, *CLI_FLAGS]
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        cli_seconds[layout] = seld.main(argv)
        torch.cuda.synchronize()
        cli_launches[layout] = dict(ck.launch_counts)
        print(f"SELD CLI {layout}: {len(cli_seconds[layout])} scenes in {time.time() - t0:.2f} s, host clock "
              f"per scene (placement, render and writes) {', '.join(f'{x:.3f}' for x in cli_seconds[layout])} s; "
              f"launches {cli_launches[layout]}", flush=True)
        for name in path:
            if cli_launches[layout][name] <= 0:
                fail(f"the {layout} CLI run never launched {name}")
        check_first_hits(cli_launches[layout], 60 * len(cli_seconds[layout]), f"the {layout} CLI run")
        check_cli_outputs(cli_root / layout, layout, t_scene)

    # 8. FOA physics: one CLI scene, loaded from its JSON, traced again; each
    # unoccluded source's W direct path peaks at d/c and (X, Y, Z)/W there
    # points at the source
    from audiblelight_tpu_torch.core import Scene
    from audiblelight_tpu_torch.render import build_scene_plan

    fscene = Scene.from_json(sorted((cli_root / "foa" / "metadata_dev").rglob("*.json"))[0], device=dev)
    fplan = build_scene_plan(fscene, **seld.plan_kwargs(seld.build_parser().parse_args(
        ["--fg-dir", "-", "--output-dir", "-", *CLI_FLAGS])))
    frend = FusedSceneRenderer.from_scene(fscene, fplan)
    f_in = frend.scene_inputs(fscene)
    # The trace keeps K4's inputs at the first and the last bounce of each
    # decimation phase (keyed by ray count), to hold K4 at the shapes the
    # FOA scene gives it
    bounces = {}
    raytracer.deposit_histogram_foa = keep_deposits("deposit_histogram_foa", bounces)
    try:
        irs_f = frend.trace(f_in[0], *f_in[1:4]).cpu().numpy()  # (4, S, L)
    finally:
        raytracer.deposit_histogram_foa = ck.deposit_histogram_foa
    check_deposit_bounces("deposit_histogram_foa", bounces, "FOA scene")
    del bounces
    src_f, lis_f = f_in[1].cpu().numpy(), f_in[2].cpu().numpy()[0]
    n_real = fscene.state.num_emitters
    blocked_f = ck.segments_occluded(f_in[2].expand(n_real, 3).contiguous(), f_in[1][:n_real],
                                     frend.state.tris).cpu().numpy()
    offs, angles = [], []
    for e in np.flatnonzero(~blocked_f):
        vec = src_f[e] - lis_f
        expect_s = np.linalg.norm(vec) / 343.0 * SR
        lo = max(int(expect_s) - win, 0)
        peak_i = lo + int(np.argmax(np.abs(irs_f[0, e, lo : int(expect_s) + win])))
        offs.append(abs(peak_i - expect_s))
        xyz = irs_f[1:, e, peak_i] / irs_f[0, e, peak_i]
        cosang = float(xyz @ vec / (np.linalg.norm(xyz) * np.linalg.norm(vec)))
        angles.append(float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))))
    print(f"FOA direct paths: {len(offs)} of {n_real} sources unoccluded; max |W peak - d/c| "
          f"{max(offs, default=float('nan')):.2f} samples; max angle of (X, Y, Z)/W at the peak to the source "
          f"{max(angles, default=float('nan')):.2f} deg")
    if not offs or max(offs) > 2.0 or max(angles) > 5.0:
        fail("FOA direct paths off their arrival time or direction")

    # 9. Where an FOA scene's time goes, as section 6 for the MIC scene
    f_amb = FusedSceneRenderer.mix_args(fscene)

    def foa_scene():
        frend.render_mix(torch.Generator(device=dev).manual_seed(5), *f_in[1:], fplan, *f_amb)

    def foa_trace():
        frend.trace(torch.Generator(device=dev).manual_seed(5), *f_in[1:4])

    foa_ms, foa_trace_ms = time_ms(foa_scene, reps=5), time_ms(foa_trace, reps=5)
    print(f"FOA scene time (CUDA events): median {foa_ms:.3f} ms; trace {foa_trace_ms:.3f} ms "
          f"({foa_trace_ms / foa_ms:.1%}); {n_real} emitters in a bucket of {frend.n_sources}")
    avgs_f, busy_f = profiled(foa_scene, "FOA scene profile")
    if busy_f > 0:
        print(f"FOA device idle share: scene {1 - busy_f / foa_ms:.1%} (profiler busy over CUDA-event time)")
    kernel_times(avgs_f, FOA_PATH, "FOA per scene")
    print(f"CLI scene time: median {np.median(cli_seconds['mic'] + cli_seconds['foa']):.3f} s (host clock, "
          f"placement, render and writes) over {len(cli_seconds['mic'] + cli_seconds['foa'])} scenes on {card}")

    elapsed(t_start, "exact rain mode")
    # 10. The exact rain mode: one flagship-width scene through
    # Scene.generate(compiled=True) (the plan path) with the default engine config (no mesh
    # simplification: the full mesh, one star query per bounce), then one MIC
    # scene of the CLI with --no-mesh-simplification
    from audiblelight_tpu_torch import utils as tutils

    exact_dir = OUT / "exact"
    shutil.rmtree(exact_dir, ignore_errors=True)
    exact_dir.mkdir(parents=True)
    def exact_scene():
        """The exact-mode scene: the same seed, room, rig and events each call."""
        tutils.seed_everything(11)
        scene = Scene(duration=SCENE_SECONDS, sample_rate=SR, backend="rlr", fg_path=fg, max_overlap=2,
                      backend_kwargs=dict(mesh=str(room_obj), seed=11, add_to_context=False), device=dev)
        scene.add_microphone(microphone_type="ambeovr")
        for event_type in ["static"] * N_STATIC + ["moving"]:
            try:
                scene.add_event(event_type=event_type, max_place_attempts=100)
            except ValueError as err:
                print(f"exact scene: could not place a {event_type} event: {err}")
        scene.add_ambience(noise="gaussian")
        return scene

    t0 = time.time()
    xscene = exact_scene()
    xcfg = xscene.state.cfg
    print(f"exact scene: placed {len(xscene.events)} events ({xscene.state.num_emitters} emitters) in "
          f"{time.time() - t0:.2f} s; rain mode {xscene.state._rain_mode()}, {xcfg['indirect_ray_count']} rays x "
          f"{xcfg['indirect_ray_depth']} bounces, decimation {xcfg['ray_decimation']}", flush=True)
    if xscene.state._rain_mode() != "exact" or not xscene.events:
        fail("the default engine config did not give an exact-mode scene with events")
    tree_builds, restore_builds = count_tree_builds()
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    xscene.generate(output_dir=exact_dir, compiled=True)
    torch.cuda.synchronize()
    exact_s = time.time() - t0
    exact_launches = dict(ck.launch_counts)
    restore_builds()
    print(f"exact scene: any-hit trees built {tree_builds} (once per mesh: the full mesh, the star's faces, the "
          f"diffraction graph)", flush=True)
    if len(tree_builds) > 3:
        fail("the exact scene built more any-hit trees than it has meshes")
    exact_irs = xscene.state.trace_irs_device()["mic000"].clone()
    xaudio = xscene.audio["mic000"]
    print(f"exact scene: Scene.generate() in {exact_s:.3f} s (host clock, render and writes); launches "
          f"{exact_launches}; star_any_hit {exact_launches['star_any_hit']} per scene, one per bounce "
          f"({exact_launches['first_hit_big']} bounces); first_hit_big {k1_full_ms:.3f} ms per 80k-ray launch at "
          f"{n_full} faces; audio {xaudio.dtype} {xaudio.shape}, peak {float(np.abs(xaudio).max()):.4f}",
          flush=True)
    for name in EXACT_PATH:
        if exact_launches[name] <= 0:
            fail(f"the exact scene never launched {name}")
    if exact_launches["star_any_hit"] != exact_launches["first_hit_big"]:
        fail("the exact scene did not query the star once per bounce")
    check_first_hits(exact_launches, exact_launches["star_any_hit"], "the exact scene")
    if xaudio.shape != (4, t_scene) or float(np.abs(xaudio).max()) * 32768 < 100:
        fail("the exact scene's audio is misshapen or silent")
    want_files = ["audio_out_mic000.wav", "metadata_out.json", "metadata_out_mic000.csv"]
    if sorted(p.name for p in exact_dir.iterdir()) != want_files:
        fail(f"the exact scene wrote {sorted(p.name for p in exact_dir.iterdir())}")
    exact_main = dict(exact_launches)

    # Where the exact scene's trace goes: its trace again (a fresh seed from
    # the world state's walk), by CUDA events (Scene.generate() warmed it up)
    # and under the profiler
    def exact_trace():
        xscene.state._irs_device_cache = None
        xscene.state.trace_irs_device()

    exact_trace_ms = time_ms(exact_trace, reps=1, warm=False)
    avgs_x, busy_x = profiled(exact_trace, "exact trace profile")
    print(f"exact trace time (CUDA events): {exact_trace_ms:.3f} ms; device idle share "
          f"{1 - busy_x / exact_trace_ms:.1%} (profiler busy over CUDA-event time)")
    kernel_times(avgs_x, EXACT_PATH, "exact per trace")

    argv = ["--fg-dir", str(fg), "--output-dir", str(cli_root / "exact"), "--mesh", str(room_obj),
            "--channel-layout", "mic", *CLI_FLAGS, "--n-scenes", "1", "--no-mesh-simplification"]
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    x_cli_s = seld.main(argv)
    torch.cuda.synchronize()
    x_cli = dict(ck.launch_counts)
    print(f"SELD CLI mic --no-mesh-simplification: {len(x_cli_s)} scene in {time.time() - t0:.2f} s; host clock "
          f"per scene {', '.join(f'{x:.3f}' for x in x_cli_s)} s; launches {x_cli}", flush=True)
    for name in EXACT_PATH:
        if x_cli[name] <= 0:
            fail(f"the exact CLI run never launched {name}")
    check_cli_outputs(cli_root / "exact", "mic", t_scene, n_scenes=1)

    # K6 and K3 again on that CLI scene's own bounces: its trace, loaded from
    # the JSON, keeps their inputs at the first and the last bounce of each
    # decimation phase (keyed by ray count)
    xs = Scene.from_json(sorted((cli_root / "exact" / "metadata_dev").rglob("*.json"))[0], device=dev)
    kept_star = {}

    def keep_star(star, starts, end):
        keep_first_last(kept_star, starts.shape[0], (star, starts.clone(), end.clone()))
        return so.star_segments_occluded(star, starts, end)

    exact_bounces = {}
    raytracer.star_segments_occluded = keep_star
    raytracer.deposit_histogram = keep_deposits("deposit_histogram", exact_bounces)
    try:
        xs.state.trace_irs_device()
    finally:
        raytracer.star_segments_occluded = so.star_segments_occluded
        raytracer.deposit_histogram = ck.deposit_histogram
    check_deposit_bounces("deposit_histogram", exact_bounces, "exact CLI trace")
    del exact_bounces
    if len(kept_star) != 3:
        fail(f"the exact trace ran K6 at ray counts {sorted(kept_star)}, expected three decimation phases")
    for rays, kept in sorted(kept_star.items(), reverse=True):
        for which, (star, starts, end) in zip(("first", "last"), kept):
            check_any_hit("star_any_hit", f"exact scene's {which} bounce of {rays} segments", starts,
                          end.expand(rays, 3).contiguous(), xs.state.device_state.acoustic_tris, star.tree,
                          lambda star=star, starts=starts, end=end: so.star_segments_occluded(star, starts, end))
    del kept_star, xs

    elapsed(t_start, "K7 route")
    # 10b. The exact-mode scene again with config.USE_TILED_FIRST_HIT (K7)
    tiled_n, surface = tiled_phase(exact_scene, xscene, (exact_s, exact_launches, exact_irs, exact_trace_ms, busy_x,
                                                         launch_calls(avgs_x)), st_x, table_x, (origins, dirs), results)
    del exact_irs

    elapsed(t_start, "K1 on the full mesh")
    # 10c. K1 big against its plain version on the full mesh: surface,
    # interior and dead-ray wavefronts
    k1_phase(xscene, st_x, table_x, surface, (origins, dirs))

    elapsed(t_start, "K9 and K10")
    # 10d. The cone-sorted (K9) and pair-walk (K10) first hits on the full
    # mesh (the exact scene's surface rays, the interior rays, the surface
    # rays with 45 % of them dead) and on the LOD (the fused trace's first
    # bounce)
    lod_tris, lod_o, lod_d = first_bounce[0]
    if lod_o.shape[0] != 80000 or lod_tris.shape[0] != n_lod:
        fail(f"the fused trace's first bounce had {lod_o.shape[0]} rays on {lod_tris.shape[0]} faces")
    dead45 = torch.rand(surface[0].shape[0], generator=torch.Generator(device=dev).manual_seed(45), device=dev) >= 0.45
    sorted_pair_n = sorted_pair_phase([
        ("exact scene's surface rays", st_x.tris, *surface, None),
        ("interior rays", st_x.tris, origins, dirs, None),
        ("fused trace's first bounce on the LOD", lod_tris, lod_o, lod_d, None),
        ("exact scene's surface rays, 45 % dead", st_x.tris, *surface, dead45),
    ], results)
    del surface, first_bounce

    elapsed(t_start, "small room")
    # 10e. The rlr main path in a room of <= 512 faces: K1 small on every bounce
    small_n = small_room_phase(caps, listeners, t_scene, results)

    elapsed(t_start, "HOA3 and binaural rigs")
    # 11. The HOA3 and binaural rigs at the rig's centre: the first
    # flagship scene through the fused renderer (per-face rain table, K5 per
    # bounce), written as int16 WAVs; the direct paths of the unoccluded
    # sources checked for direction (HOA3: the order-1 channels at the W
    # peak of the traced IRs) and for the Woodworth ITD and the ILD's sign
    # (binaural: the traced IRs and their direct-path component)
    src, s_idx, m_idx, plan, amb = scenes[0]
    src_t, s_idx_t, m_idx_t = (torch.as_tensor(x, device=dev) for x in (src, s_idx, m_idx))
    lis_c = torch.tensor([MIC_CENTRE], dtype=torch.float32, device=dev)
    occ_c = st.rain_occlusion_for(np.array([MIC_CENTRE]))
    free_c = ~ck.segments_occluded(lis_c.expand(N_SOURCES, 3).contiguous(), src_t, st.tris).cpu().numpy()
    rig_main, rig_ms = {}, {}
    for layout, n_ch in (("hoa3", 16), ("binaural", 2)):
        rend = FusedSceneRenderer(st, 1, BUCKETS, N_SOURCES, t_scene, layout=layout)
        splan = ScenePlan.from_numpy(plan, dev)
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        wav = rend.render_mix(torch.Generator(device=dev).manual_seed(21), src_t, lis_c, occ_c, s_idx_t, m_idx_t,
                              splan, *amb)
        torch.cuda.synchronize()
        rig_s = time.time() - t0
        rig_main[layout] = dict(ck.launch_counts)
        peak = int(wav.abs().max())
        path = write_wav(OUT / f"{layout}.wav", wav, SR)
        print(f"{layout} scene: {path.relative_to(REPO)} {tuple(wav.shape)} {wav.dtype}, peak {peak}; "
              f"{rig_s:.3f} s (host clock, first); launches {rig_main[layout]}", flush=True)
        if wav.dtype != torch.int16 or tuple(wav.shape) != (n_ch, t_scene) or peak < 100:
            fail(f"{layout} scene: payload {wav.dtype} {tuple(wav.shape)}, peak {peak}")
        for name in RIG_PATH:
            if rig_main[layout][name] <= 0:
                fail(f"the {layout} scene never launched {name}")
        if rig_main[layout]["bin_histogram"] != rig_main[layout]["first_hit_big"]:
            fail(f"the {layout} scene did not fold with K5 once per bounce")
        check_first_hits(rig_main[layout], 60, f"the {layout} scene")
        rig_ms[layout] = time_ms(lambda: rend.render_mix(torch.Generator(device=dev).manual_seed(5), src_t, lis_c,
                                                          occ_c, s_idx_t, m_idx_t, splan, *amb), reps=3)
        kept5 = {}

        def keep_k5(bins, dep, n_bins):
            keep_first_last(kept5, bins.shape[1], (bins.clone(), dep.clone(), n_bins))
            return ck.bin_histogram(bins, dep, n_bins)

        raytracer.bin_histogram = keep_k5
        try:
            irs = rend.trace(torch.Generator(device=dev).manual_seed(7), src_t, lis_c, occ_c)
        finally:
            raytracer.bin_histogram = ck.bin_histogram
        if layout == "hoa3":
            check_k5_bounces(kept5)
            irs = irs.cpu().numpy()
            offs, worst = [], []
            for e in np.flatnonzero(free_c):
                vec = src[e] - np.array(MIC_CENTRE)
                dist_e = np.linalg.norm(vec)
                expect_s = dist_e / 343.0 * SR
                lo = max(int(expect_s) - win, 0)
                peak_i = lo + int(np.argmax(np.abs(irs[0, e, lo : int(expect_s) + win])))
                offs.append(abs(peak_i - expect_s))
                xyz = irs[[3, 1, 2], e, peak_i] / irs[0, e, peak_i]
                cosang = float(xyz @ vec / (np.linalg.norm(xyz) * dist_e))
                worst.append(float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))))
            print(f"HOA3 direct paths: {len(offs)} of {N_SOURCES} sources unoccluded; max |W peak - d/c| "
                  f"{max(offs, default=float('nan')):.2f} samples; max angle of the order-1 channels over W to the "
                  f"source {max(worst, default=float('nan')):.2f} deg")
            if not offs or max(offs) > 2.0 or max(worst) > 5.0:
                fail("HOA3 direct paths off their arrival time or direction")
        else:
            check_binaural(irs, raytracer.direct_paths_ir(st.tris, src_t, lis_c, irs.shape[-1], sr=SR,
                                                          encoding="binaural").transpose(0, 1),
                           src, free_c, win)
    print(f"rig scene time (CUDA events): HOA3 {rig_ms['hoa3']:.3f} ms, binaural {rig_ms['binaural']:.3f} ms on "
          f"{card}")

    elapsed(t_start, "Eigenmike rigs")
    # 12. The Eigenmike em32 and em64 rigs on the rlr main path (K3 at 32 and
    # 64 capsules)
    eigenmike_phase(st, scenes[0], t_scene, win)

    elapsed(t_start, "shoebox backend")
    # 13. The shoebox backend: the image-source engine, its direct paths, the
    # SELD CLI at its defaults and one MonoCapsule scene
    shoebox_phase(fg, OUT / "shoebox", win, dev)

    elapsed(t_start, "HDF5 fixtures and the SOFA backend")
    # 14. The port's HDF5 reader on h5py's files, then the SOFA backend
    # through the SELD CLI on two measured rooms written by the port
    fixture_phase()
    sofa_phase(fg, OUT / "sofa", dev)

    elapsed(t_start, "measured HRTFs")
    # 15. Measured HRTFs: the fused scene's binaural tail (K5), direct and
    # diffracted paths, and the shoebox's image sources
    hrtf_n = hrtf_phase(st, scenes[0], t_scene, win, fg, OUT / "hrtf", dev)
    print(f"measured-HRTF binaural scene: bin_histogram {hrtf_n['bin_histogram']} launches per scene")

    elapsed(t_start, "classic per-event render")
    # 16. The classic per-event render (Scene.generate()'s default): the
    # flagship MIC scene against the plan path, its dry stem, the card
    # against the CPU; one classic FOA CLI scene
    classic_phase(mesh, fg, room_obj, OUT / "classic", dev)

    elapsed(t_start, "SSSEG entry")
    # 17. The SSSEG dataset entry at its defaults: two scenes
    ssseg_phase(OUT / "ssseg", dev)

    elapsed(t_start, "augmentations")
    # 18. The 27 augmentations on the card; the shoebox CLI with and without
    # --augmentations
    augmentation_phase(fg, OUT / "augment", dev)

    elapsed(t_start, "pooled driver")
    # 19. The pooled SELD driver: the host BVH, the batched renders (K3 and
    # K4 with a scene axis), the serial CLI's host time by stage, the pooled
    # CLI with 1 and 4 workers
    pooled_n, pooled_w1 = pooled_phase(mesh, st, fg, room_obj, OUT / "pooled", dev)
    print(f"pooled CLI: launches {pooled_n}")

    elapsed(t_start, "multi-device rendering")
    # 20. Multi-device rendering: the CLI as rank 0 of a world of one, the
    # world of one's sharded renders, two gloo ranks sharing the card, a
    # scene with two microphones
    parallel_n = parallel_phase(renderer, st, fg, room_obj, OUT / "parallel", pooled_w1, dev)
    print(f"multi-device: the --coordinator CLI's launches {parallel_n}")

    elapsed(t_start, "real datasets' assets")
    # 21. Real datasets' assets: MP3 and FLAC, a GLB room and its repair, the
    # --assets room table at 1 and 2 prep workers, a file bed, a predefined
    # trajectory, transmission through faces
    assets_n = assets_phase(mesh, renderer, scenes[0], OUT / "assets", dev)
    print(f"--assets CLI: launches {assets_n}")

    elapsed(t_start, "media: stage timers, acoustic images, DOA, video, entries")
    # 22. The last modules: stage timers (peak memory, a trace), the flagship
    # acoustic image, the imaging and DOA entries, the panorama (K1 big on
    # 204,800 pixel rays) and a scene video, the scripts/generate entries
    media_n = media_phase(mesh, renderer, scenes[0], fg, OUT / "media", dev)
    print(f"media: {media_n}")

    main_launches = dict(launches, first_hit_small=small_n["first_hit_small"],
                         deposit_histogram_foa=cli_launches["foa"]["deposit_histogram_foa"],
                         star_any_hit=exact_main["star_any_hit"], bin_histogram=rig_main["hoa3"]["bin_histogram"],
                         first_hit_mxu=mxu_n["first_hit_mxu"], first_hit_tiled=tiled_n["first_hit_tiled"],
                         first_hit_sorted=sorted_pair_n["first_hit_sorted"],
                         first_hit_pair=sorted_pair_n["first_hit_pair"])
    sources = {"first_hit_big": "first_hit.cu", "first_hit_small": "first_hit.cu", "any_hit": "any_hit.cu",
               "deposit_histogram": "deposit_histogram.cu",
               "deposit_histogram_foa": "deposit_histogram_foa.cu", "bin_histogram": "bin_histogram.cu",
               "star_any_hit": "star_any_hit.cu", "first_hit_tiled": "tiled_first_hit.cu",
               "first_hit_mxu": "mxu_first_hit.cu", "first_hit_sorted": "sorted_first_hit.cu",
               "first_hit_pair": "pair_first_hit.cu"}
    replaces = {
        "first_hit_big": "audiblelight_tpu/ops/pallas_kernels.py:46",
        "first_hit_small": "audiblelight_tpu/ops/pallas_kernels.py:149",
        "any_hit": "audiblelight_tpu/ops/pallas_kernels.py:375",
        "deposit_histogram": "audiblelight_tpu/ops/pallas_kernels.py:594",
        "deposit_histogram_foa": "audiblelight_tpu/ops/pallas_kernels.py:738",
        "bin_histogram": "audiblelight_tpu/ops/pallas_kernels.py:509",
        "star_any_hit": "audiblelight_tpu/ops/star_occlusion.py:257",
        "first_hit_tiled": "audiblelight_tpu/ops/tiled_first_hit.py:141",
        "first_hit_mxu": "audiblelight_tpu/ops/mxu_first_hit.py:144",
        "first_hit_sorted": "audiblelight_tpu/ops/sorted_first_hit.py:231",
        "first_hit_pair": "audiblelight_tpu/ops/pair_first_hit.py:54",
    }
    line = {"kernels": [
        dict(name=name, route="cuda", source=f"audiblelight_tpu_torch/csrc/{sources[name]}",
             replaces=replaces[name], launches=int(main_launches[name]), max_abs_err=res["max_abs_err"],
             ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"], bound_by=res["bound_by"],
             library_ms=res["library_ms"])
        for name, res in results.items()
    ]}
    print(f"total: {time.time() - t_start:.1f} s on {card}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-breakdown"]:
        sys.exit(breakdown_main(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--gloo-rank"]:
        sys.exit(gloo_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
