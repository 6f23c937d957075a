"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the tracer's CUDA kernels from audiblelight_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card at the flagship
shapes (K1 big, the face-tree walk, bit for bit against the dense walk and
its own plain walk, visit counts included, with each face tree's build
time), then drives the port's two main paths:

- three 60 s flagship SELD scenes through the fused renderer (110,592-face
  scanned room, 4,071-face acoustic LOD, per-face rain visibility, order-10
  diffraction, 5,000 rays x 60 bounces with wavefront decimation, 16 padded
  sources, AmbeoVR, 24 kHz), written as int16 WAVs under smoke_out/, with
  their direct-path arrivals checked, timed and profiled;
- the port's SELD dataset CLI (`audiblelight_tpu_torch.seld.main`) in the
  same room, written as an OBJ, with the repo's WAVs as foreground audio:
  two scenes each in the MIC (AmbeoVR) and FOA formats at the flagship
  width, their WAVs, CSVs and JSONs checked; then one FOA scene traced
  again, K4 held against its plain version on that trace's own bounces, its
  direct paths checked for arrival time and direction, and the FOA scene
  timed and profiled;
- the exact rain mode (the default engine config: the full 110,592-face
  mesh, one star any-hit query per bounce): one flagship-width scene
  through `Scene.generate()`, one MIC scene of the CLI with
  `--no-mesh-simplification`, and K6 held against its plain version and the
  dense any-hit on that scene's own bounces;
- the HOA3 and binaural rigs: one flagship scene each through the fused
  renderer (the unfused deposit chain folded by K5), written as int16 WAVs
  of 16 and 2 channels, their direct paths checked for direction (HOA3)
  and for the Woodworth ITD and the ILD's sign (binaural), and K5 held
  against its plain version and timed beside `index_add_` on the HOA3
  trace's own bounces (first and last of each decimation phase);
- the tracer's two optional first-hit routes: the first flagship scene with
  config.USE_MXU_FIRST_HIT (K8 on the acoustic LOD) beside the default
  scene of the same inputs, their IRs held to 5 % in per-channel energy and
  per-band T30, K8 held against its plain version and K1 on that trace's own
  bounces; and the exact-mode scene again with config.USE_TILED_FIRST_HIT
  (K7 on the full mesh's tiles), its IRs held to 1 % and 2 % against the
  K1 scene's, K7 held against its plain version, the dense classic
  Moller-Trumbore first hit and K1 on that scene's bounce inputs and on
  interior rays;
- K1 big on the full mesh against its plain versions on the exact scene's
  second and third bounces, 80k interior rays and the exact trace's
  wavefront with the most dead rays;
- the cone-sorted (K9) and pair-walk (K10) first hits, which neither
  package wires into its tracer, through their own entry points
  (`build_sorted_tiles`, `sorted_first_hit`, `pair_first_hit`) on the exact
  scene's 80k surface rays and 80k interior rays on the full mesh, the fused
  trace's first bounce on the LOD, and the surface rays with 45 % of them
  dead: each kernel held against its plain version and each op against K1
  big over the Morton-sorted faces, bit for bit.

Each path's kernel launches are counted from zero just before it and read
just after; a kernel of the path that did not launch fails the run, and so
does a fused scene that launched K1 big other than 60 times, or any path
that launched another first-hit kernel than its own. It
prints one JSON line of kernel results; the last line is
{"ok": true, "device": {...}}.

Exits non-zero without printing a result when no CUDA card is present or the
port's package is not beside this file.
"""

from __future__ import annotations

import csv
import json
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
# The SELD CLI runs: the repo's WAVs of four DCASE2023 classes, the flagship
# width, 4 static and 1 moving event per scene, two scenes per format
CLI_CLASSES = {"femaleSpeech": 0, "maleSpeech": 1, "telephone": 3, "musicInstrument": 9}
CLI_FLAGS = ["--backend", "rlr", "--n-scenes", "2", "--duration", "60", "--rays", "5000",
             "--ray-depth", "60", "--ray-decimation", "--ir-seconds", "1.0",
             "--min-events-static", "4", "--max-events-static", "4",
             "--min-events-moving", "1", "--max-events-moving", "1", "--seed", "7"]
KERNELS = ("first_hit_big", "first_hit_small", "first_hit_tiled", "first_hit_mxu", "first_hit_sorted",
           "first_hit_pair", "star_any_hit", "any_hit", "deposit_histogram_foa", "deposit_histogram", "bin_histogram")
MIC_PATH = ("first_hit_big", "any_hit", "deposit_histogram")
FOA_PATH = ("first_hit_big", "any_hit", "deposit_histogram_foa")
EXACT_PATH = ("first_hit_big", "any_hit", "deposit_histogram", "star_any_hit")
RIG_PATH = ("first_hit_big", "any_hit", "bin_histogram")
MXU_PATH = ("first_hit_mxu", "any_hit", "deposit_histogram")
TILED_PATH = ("first_hit_tiled", "any_hit", "deposit_histogram", "star_any_hit")


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of the kernels `fn` launches, from the profiler
    over `reps` calls after a warm-up: `time_ms` without the host's time
    before each launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
                for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
    return total / reps / 1e3


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


def first_hit_pairs(o, d, t_hit, face, boxes: tuple, order=None, group: int = 256) -> tuple:
    """(pairs, in_groups): the (ray, face) pairs a first hit needs on this
    data. A ray needs each face whose box (`boxes`, from face_boxes, padded
    by BOX_PAD) its segment [0, t_hit] enters: a face whose box the segment
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
    f_lo, f_hi = (lo[safe] - BOX_PAD).view(-1, group, 3), (hi[safe] + BOX_PAD).view(-1, group, 3)
    g_lo = torch.where(real[..., None], f_lo, float("inf")).amin(1)
    g_hi = torch.where(real[..., None], f_hi, float("-inf")).amax(1)
    inv = 1.0 / torch.where(d.abs() < 1e-30, 1e-30, d)
    t_end = t_hit + BOX_PAD
    own = face.clamp_min(0).long()
    left_out = (face >= 0) & ~segment_enters(o, inv, t_end, lo[own] - BOX_PAD, hi[own] + BOX_PAD)
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


def any_hit_pairs(starts, ends, tris) -> int:
    """(segment, face) pairs the early-exit any-hit kernel tests on these
    segments: up to the first blocking face, or every face when free."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    o, d, length, tab = ck._any_hit_inputs(starts, ends, tris)
    r, f = o.shape[0], tab.shape[0]
    first = torch.full((r,), f, dtype=torch.int64, device=o.device)
    t_max = (length - 1e-4)[:, None]
    step = ck._face_chunk(r, f)
    for f0 in range(0, f, step):
        in_tri, t = ck._mt_pair(o, d, tab[f0 : f0 + step].T[:, None, :])
        hit = in_tri & (t > 1e-4) & (t < t_max)
        idx = torch.where(hit.any(1), hit.int().argmax(1) + f0, f)
        first = torch.minimum(first, idx)
    return int(torch.where(first < f, first + 1, f).sum())


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


def star_windows_on(star, tris: torch.Tensor) -> tuple:
    """(centres, padded half-widths) of the narrow faces' azimuth windows of
    `star`, built from `tris` (the acoustic mesh), on the card."""
    from audiblelight_tpu_torch.ops import star_occlusion as so

    _, _, cen, half = so.star_windows(tris.cpu().numpy(), star.center.cpu().numpy(), star.r_pad)
    return (torch.as_tensor(cen, dtype=torch.float32, device=tris.device),
            torch.as_tensor(half, dtype=torch.float32, device=tris.device))


def star_pairs(star, windows, starts, end, blocked) -> tuple:
    """(pairs the kernel's block x tile cull tests without its early exits,
    pairs this data needs): for each free segment, every narrow face whose
    own window (`windows`, from star_windows_on) holds the segment's azimuth
    and every wide face; one face for each blocked segment."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.ops import star_occlusion as so

    order, o, _, _, brange = so._star_inputs(star, starts, end)
    overlap = ck.star_tile_overlap(brange, star.tile_meta)
    tested = (int(overlap.sum()) * ck.STAR_TILE_FACES + brange.shape[1] * star.n_wide) * ck.STAR_BLOCK
    free = starts[~blocked]
    az = torch.atan2(free[:, 1] - star.center[1], free[:, 0] - star.center[0])
    cen, half = windows
    holds = 0
    for i0 in range(0, az.shape[0], 1024):
        d = cen[None, :] - az[i0 : i0 + 1024, None]
        d = d - 2.0 * np.pi * torch.floor(d / (2.0 * np.pi) + 0.5)
        holds += int((d.abs() <= half[None, :]).sum())
    needed = holds + free.shape[0] * star.n_wide + int(blocked.sum())
    return tested, needed


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


def check_binaural(irs: torch.Tensor, direct: torch.Tensor, src: np.ndarray, free: np.ndarray, win: int) -> None:
    """The binaural rig's direct paths against the Woodworth head, for each
    unoccluded source: on the traced IRs `irs` (2, E, L), the near ear peaks
    within 2 samples of d/c plus its Woodworth offset; on their direct
    component `direct` (2, E, L), both ears do, and the near ear is the
    louder for a source clearly to one side. Where the traced IRs' far-ear
    peak is off its arrival, or their ILD over the direct windows has the
    wrong sign, the rest of the IR (tail and diffraction, `irs - direct`)
    must outweigh the shadowed direct path there."""
    from audiblelight_tpu_torch.rir.sh import woodworth_itd

    irs, direct = irs.cpu().numpy(), direct.cpu().numpy()
    rest = irs - direct
    near_off, direct_off, far_off, ild_wrong, ild_wrong_direct, unexplained = [], [], [], [], 0, []
    for e in np.flatnonzero(free):
        vec = src[e] - np.array(MIC_CENTRE)
        dist_e = np.linalg.norm(vec)
        u = torch.as_tensor(vec / dist_e, dtype=torch.float32)[None]
        ear_s = dist_e / 343.0 * SR + woodworth_itd(u).numpy()[0] * SR  # (2,) per-ear arrivals
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
    n_lat = sum(abs(src[e][1] - MIC_CENTRE[1]) / np.linalg.norm(src[e] - np.array(MIC_CENTRE)) > 0.2
                for e in np.flatnonzero(free))
    print(f"binaural direct paths: {len(near_off)} of {N_SOURCES} sources unoccluded; traced IRs: max |near-ear "
          f"peak - (d/c + Woodworth ITD)| {max(near_off, default=float('nan')):.2f} samples, far-ear peak more than 2 "
          f"samples off: {far_off}, ILD sign over the direct windows wrong for {len(ild_wrong)} of "
          f"{n_lat} lateral sources {ild_wrong}, each held by the tail and diffraction outweighing the shadowed "
          f"direct path: {not unexplained}; direct component: max |ear peak - (d/c + Woodworth ITD)| "
          f"{max(direct_off, default=float('nan')):.2f} samples, ILD sign wrong for {ild_wrong_direct} of {n_lat}")
    if not near_off or max(near_off) > 2.0 or max(direct_off) > 2.0 or ild_wrong_direct or unexplained:
        fail(f"binaural direct paths off the Woodworth ITD or the ILD's sign {unexplained}")


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
                print(f"{label}: {name} {t_dev:.3f} ms over {ev.count} launches")
    return out


def mxu_phase(renderer, inputs: tuple, t_scene: int, results: dict) -> dict:
    """The acoustic LOD through the bilinear first hit (K8): the first
    flagship scene with config.USE_MXU_FIRST_HIT, beside the default scene
    of the same inputs and generator (K1's launches there less its bounces
    must be K8's scene's); their IRs traced again with one seed, held to 5 %
    in per-channel energy and per-band T30; K8 held against its plain
    version (bit for bit) and K1 (faces agreeing on at least the 0.78 of the
    reference's own test, t within its 5e-4 + 5e-4 |t| there) on the K8
    trace's own bounces, the first and the last of each decimation phase.
    `inputs` = (sources, listeners, rain table, s_idx, m_idx, plan,
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
    print(f"K8 scene time (CUDA events, median of 3 in turns): {mxu_ms:.3f} ms, device busy {busy[True][1]:.3f} ms; "
          f"the default scene's {k1_ms:.3f} ms, busy {busy[False][1]:.3f} ms", flush=True)
    for on, (avgs, _) in busy.items():
        kernel_times(avgs, ("first_hit_mxu", "first_hit_big"), f"{'K8' if on else 'default'} scene")

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
            t_k, i_k = mxu.mxu_first_hit(tables, o8, d8, prev8)
            t_p, i_p = mxu.mxu_first_hit_plain(tables, o8, d8, prev8)
            t_1, i_1 = ck.ray_first_hit(o8, d8, st.acoustic_tris, table_lod)
            torch.cuda.synchronize()
            exact = torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
            agree = i_k == i_1
            both = agree & torch.isfinite(t_k) & torch.isfinite(t_1)
            # The reference's own test of this route: rtol and atol 5e-4 where the faces agree
            close = bool(((t_k - t_1).abs() <= 5e-4 + 5e-4 * t_1.abs())[both].all())
            rel = float(((t_k - t_1).abs() / t_1.abs())[both].max()) if bool(both.any()) else 0.0
            share = float(agree.float().mean())
            _, _, rvec, prev_k = mxu.mxu_inputs(tables, o8, d8, prev8)
            t_sel, i_sel = ck.first_hit_mxu(rvec, prev_k, tables.packed)
            k_ms = time_ms(lambda: ck.first_hit_mxu(rvec, prev_k, tables.packed))
            p_ms = time_ms(lambda: ck.first_hit_mxu_plain(rvec, prev_k, tables.packed), reps=3)
            f_lod = tables.n_faces
            # Pairs this data needs: the faces whose window (with its slop)
            # the ray's segment up to the selected t could reach
            needed, _ = first_hit_pairs(o8, d8, t_sel, i_sel, face_boxes(st.acoustic_tris, ck.MXU_EPS_UV))
            b_ms, b_by = bound_ms(needed * FLOPS_MXU_PAIR, rays * 40 + f_lod * 76 + rays * 8)
            print(f"check first_hit_mxu at the K8 trace's {which} bounce of {rays} rays x {f_lod} faces: "
                  f"identical to its plain version {exact}; faces agree with K1 on {share:.4f} of the rays, t "
                  f"within 5e-4 + 5e-4 |t| there {close} (at most {rel:.3e} relative); kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, with its glue "
                  f"{time_ms(lambda: mxu.mxu_first_hit(tables, o8, d8, prev8)):.4f} ms, K1 "
                  f"{time_ms(lambda: ck.ray_first_hit(o8, d8, st.acoustic_tris, table_lod)):.4f} ms; (ray, face) "
                  f"pairs this data needs {needed} ({needed / (rays * f_lod):.3%} of dense), bound {b_ms:.5f} ms "
                  f"({b_by})", flush=True)
            if not exact:
                fail(f"first_hit_mxu disagrees with its plain version at {rays} rays")
            if share < 0.78 or not close:
                fail(f"first_hit_mxu strays from K1 at {rays} rays")
            if "first_hit_mxu" not in results:
                # Yardstick: the reference's four (R, 16) x (16, F_pad) fp32
                # products, their operands laid out from the packed rows
                rmat = torch.nn.functional.pad(torch.cat([rvec, torch.ones_like(rvec[:, :1])], dim=1), (0, 6))
                f_pad = tables.normal.shape[0]
                ops = []
                for row0, c0, c1 in ((0, 0, 6), (0, 6, 12), (3, 12, 15), (6, 15, 19)):
                    m = torch.zeros((16, f_pad), dtype=torch.float32, device=dev)
                    m[row0 : row0 + c1 - c0, :f_lod] = tables.packed[:, c0:c1].T
                    ops.append(m)
                results["first_hit_mxu"] = dict(
                    max_abs_err=float((t_k - t_p).abs().nan_to_num(0.0).max()), bound_ms=b_ms, bound_by=b_by,
                    ms=k_ms, plain_ms=p_ms, library_ms=time_ms(lambda: [torch.matmul(rmat, m) for m in ops]),
                )
                print(f"first_hit_mxu yardstick: the four ({rays}, 16) x (16, {f_pad}) fp32 "
                      f"products by torch.matmul {results['first_hit_mxu']['library_ms']:.4f} ms")
    return mxu_n


def tiled_phase(make_scene, xscene, k1_scene: tuple, st_x, table_x, interior: tuple, results: dict) -> tuple:
    """The exact-mode scene again with config.USE_TILED_FIRST_HIT: the same
    seed and placement (`make_scene`) through Scene.generate(), every
    bounce's first hit through K7 on the full mesh's tiles (K1's launches
    there must be the K1 scene's less its bounces); its IRs held to 1 % in
    per-channel energy and 2 % in per-band T30 against the K1 scene's; its
    trace timed and profiled. Then K7 at the flagship shapes on 80k of that
    scene's bounce rays (surface origins) and on the interior rays `interior`,
    against its plain version (bit for bit), the dense classic
    Moller-Trumbore first hit (K1 small's arithmetic, which is K7's; a
    difference only as a 1 ulp tie at the early exit's bound) and K1 big
    (faces may differ at edges, t within 1e-5 relative there). `k1_scene` =
    (the K1 scene's generate seconds, launches, IRs, trace ms). Returns the
    K7 scene's launch counts and the 80k surface rays (origins, dirs)."""
    from audiblelight_tpu_torch import config
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.ops import tiled_first_hit as tfh
    from audiblelight_tpu_torch.rir import raytracer

    exact_s, exact_launches, exact_irs, exact_trace_ms = k1_scene
    origins, dirs = interior
    n_full = st_x.tris.shape[0]

    kept_tiled = []

    def keep_tiled(tiles, o, d):
        if len(kept_tiled) < 3:
            kept_tiled.append((tiles, o.clone(), d.clone()))
        return tfh.tiled_first_hit(tiles, o, d)

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
        tscene.generate(output_dir=tiled_dir)
        torch.cuda.synchronize()
        tiled_s = time.time() - t0
        tiled_launches = dict(ck.launch_counts)
        tiled_irs = tscene.state.trace_irs_device()["mic000"]
    finally:
        raytracer.tiled_first_hit = tfh.tiled_first_hit
    print(f"K7 exact scene: Scene.generate() in {tiled_s:.3f} s (host clock, render and writes; the K1 scene "
          f"{exact_s:.3f} s); launches {tiled_launches}", flush=True)
    for name in TILED_PATH:
        if tiled_launches[name] <= 0:
            fail(f"the K7 exact scene never launched {name}")
    if tiled_launches["first_hit_tiled"] != tiled_launches["star_any_hit"]:
        fail("the K7 exact scene did not take K7 once per bounce")
    if tiled_launches["first_hit_big"] != exact_launches["first_hit_big"] - exact_launches["star_any_hit"]:
        fail("the K7 exact scene's K1 launches are not the K1 scene's less its bounces")
    compare_irs("K7 exact scene IRs against the K1 exact scene's", tiled_irs, exact_irs, 0.01, 0.02)

    def tiled_trace():
        tscene.state._irs_device_cache = None
        tscene.state.trace_irs_device()

    try:
        tiled_trace_ms = time_ms(tiled_trace, reps=1, warm=False)
        avgs_t, busy_t = profiled(tiled_trace, "K7 exact trace profile")
    finally:
        config.USE_TILED_FIRST_HIT = False
    print(f"K7 exact trace time (CUDA events): {tiled_trace_ms:.3f} ms against the K1 trace's {exact_trace_ms:.3f} "
          f"ms; device idle share {1 - busy_t / tiled_trace_ms:.1%} (profiler busy over CUDA-event time)")
    kernel_times(avgs_t, TILED_PATH, "K7 exact per trace")

    tiles = kept_tiled[0][0]
    tab_dense = ck.dense_mt_table(st_x.tris)
    boxes = face_boxes(st_x.tris)
    # The scene's bounces have 5,000 rays per padded source: its second and
    # third bounce together make the flagship's 80k surface-origin rays
    surface = [torch.cat([kept_tiled[1][k], kept_tiled[2][k]])[:80000].contiguous() for k in (1, 2)]
    for label, o7, d7 in (("exact scene's second and third bounces", *surface), ("interior rays", origins, dirs)):
        _, o_s, d_s, bmeta, perm, dlo = tfh.tiled_inputs(tiles, o7, d7)
        kargs = (o_s, d_s, bmeta, perm, dlo, tiles.face_tab, tiles.tile_aabb)
        t_k, i_k = ck.first_hit_tiled(*kargs)
        walk = []  # the plain walk, timed on the call that is checked
        plain_ms = time_ms(lambda: walk.append(ck.tiled_walk_plain(*kargs)), reps=1, warm=False)
        t_p, i_p, visited = walk[0]
        exact = torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
        t7, i7 = tfh.tiled_first_hit(tiles, o7, d7)
        t_d, i_d = ck.ray_first_hit(o7, d7, st_x.tris, tab_dense)
        differ = torch.nonzero((i7 != i_d) | (t7 != t_d)).flatten()
        ulps = ulp_distance(t7[differ], t_d[differ])
        for j, u in zip(differ.tolist()[:20], ulps.tolist()[:20]):
            print(f"  K7 against the dense first hit, ray {j}: faces {int(i7[j])} / {int(i_d[j])}, t "
                  f"{float(t7[j]):.9g} / {float(t_d[j]):.9g}, {u} ulp")
        t_1, i_1 = ck.ray_first_hit(o7, d7, st_x.tris, table_x)
        mis = (i7 != i_1) & torch.isfinite(t7) & torch.isfinite(t_1)
        rel1 = float(((t7 - t_1).abs() / t_1.abs())[mis].max()) if bool(mis.any()) else 0.0
        miss1 = int((torch.isfinite(t7) != torch.isfinite(t_1)).sum())
        # Pairs this data needs: each face whose box the ray's segment
        # [0, t_hit] enters (a slab test, the tiles' boxes first); beside it,
        # every face of each tile whose box the segment enters
        needed, in_tiles = first_hit_pairs(o7, d7, t7, i7, boxes, order=tiles.face_tab[:, 9].long(),
                                           group=tfh.TILE_FACES)
        n_rays, nb = o7.shape[0], visited.shape[0]
        tested = int(visited.sum())
        k7_ms = time_ms(lambda: ck.first_hit_tiled(*kargs))
        glue_ms = time_ms(lambda: tfh.tiled_first_hit(tiles, o7, d7))
        k1_ms = time_ms(lambda: ck.ray_first_hit(o7, d7, st_x.tris, table_x), reps=3)
        nbytes = o_s.shape[0] * 32 + nb * (48 + 8 * tiles.n_tiles) + tiles.n_tiles * (256 * 40 + 24)
        b_ms, b_by = bound_ms(needed * FLOPS_MT_PAIR, nbytes)
        print(f"check first_hit_tiled on the {label}: {n_rays} rays x {n_full} faces ({tiles}): identical to its "
              f"plain version {exact}; {differ.numel()} rays differ from the dense first hit, max "
              f"{int(ulps.max()) if differ.numel() else 0} ulp; against K1 big {int(mis.sum())} faces differ (t "
              f"within {rel1:.3e} relative there), {miss1} hit/miss differ; (block, tile) pairs tested {tested} of "
              f"{nb * tiles.n_tiles} ({tested / (nb * tiles.n_tiles):.2%}); (ray, face) pairs this data needs "
              f"{needed} ({needed / (n_rays * n_full):.4%} of dense; the faces of the tiles entered {in_tiles}, "
              f"{in_tiles / (n_rays * n_full):.3%}); kernel {k7_ms:.3f} ms, with its glue {glue_ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, K1 big {k1_ms:.3f} ms on the same rays; bound {b_ms:.5f} ms ({b_by})",
              flush=True)
        if not exact:
            fail(f"first_hit_tiled disagrees with its plain version on the {label}")
        if differ.numel() and int(ulps.max()) > 1:
            fail(f"first_hit_tiled differs from the dense first hit by more than a rounding tie ({label})")
        if rel1 > 1e-5 or miss1:
            fail(f"first_hit_tiled differs from K1 big by more than an edge tie ({label})")
        if "first_hit_tiled" not in results:
            results["first_hit_tiled"] = dict(
                max_abs_err=float((t7 - t_d)[torch.isfinite(t_d)].abs().max()), bound_ms=b_ms, bound_by=b_by,
                ms=k7_ms, library_ms=None, plain_ms=plain_ms,
            )
    return tiled_launches, surface


def sorted_pair_phase(wavefronts: list, results: dict) -> dict:
    """The cone-sorted (K9) and pair-walk (K10) first hits, which neither
    package wires into its tracer, through their own entry points: the
    Morton tiles of each mesh (`build_sorted_tiles`), then `sorted_first_hit`
    and `pair_first_hit` on every wavefront of `wavefronts` ((label, tris,
    origins, dirs, alive or None)), launches counted from zero around that
    run. Then, per wavefront: each kernel against its plain version on the
    same inputs (bit for bit: K9 on the sorted rays, K10 on every round's
    lanes, and the whole K10 walk through both); each op against K1
    big over the sentinel-padded sorted faces (bit for bit, the same table)
    and, through `order`, against K1 big over the mesh as it is (t identical,
    faces differing only at a tie); K9's (block, tile) pairs, K10's tiles
    per ray, rounds and rays unresolved after round 1; the kernels', glue's,
    plain versions' and K1's times (K10's kernel and plain times summed over
    the op's rounds) and the bound of the first hit: the pairs this data
    needs, the rays and the table read once, the result written once; on
    the first wavefront, the K10 op under the profiler. Returns
    the phase's launch counts."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck
    from audiblelight_tpu_torch.ops import pair_first_hit as pfh
    from audiblelight_tpu_torch.ops import sorted_first_hit as sfh

    built, tables = {}, {}
    for _, tris, *_ in wavefronts:
        if id(tris) not in built:
            t0 = time.time()
            tiles, order = sfh.build_sorted_tiles(tris.cpu().numpy(), device=tris.device)
            built[id(tris)] = (tiles, order, time.time() - t0)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    outs = []
    for _, tris, o, d, alive in wavefronts:
        tiles = built[id(tris)][0]
        outs.append((sfh.sorted_first_hit(tiles, o, d, alive), pfh.pair_first_hit(tiles, o, d, alive)))
    torch.cuda.synchronize()
    launches = dict(ck.launch_counts)
    print(f"K9 and K10 on {len(wavefronts)} wavefronts through their entry points in {time.time() - t0:.3f} s "
          f"(host clock); launches {launches}; host builds "
          f"{', '.join(f'{b[0]} {b[2]:.2f} s' for b in built.values())}", flush=True)
    for name in ("first_hit_sorted", "first_hit_pair"):
        if launches[name] <= 0:
            fail(f"the K9/K10 path never launched {name}")
    if launches["first_hit_sorted"] != len(wavefronts):
        fail("sorted_first_hit did not launch K9 once per wavefront")

    for (label, tris, o, d, alive), ((t9, i9), (t10, i10)) in zip(wavefronts, outs):
        tiles, order, _ = built[id(tris)]
        r, dev = o.shape[0], o.device
        live = torch.ones(r, dtype=torch.bool, device=dev) if alive is None else alive
        n_live = int(live.sum())
        # K9 against its plain version on the same sorted rays, orders and bounds
        _, o_s, d_s, live_s, perm, dlo, nv = sfh.sorted_inputs(tiles, o, d, live)
        kargs = (o_s, d_s, live_s, perm, dlo, nv, tiles.face_tab)
        t_k, i_k = ck.first_hit_sorted(*kargs)
        walk = []
        k9_plain_ms = time_ms(lambda: walk.append(ck.sorted_walk_plain(*kargs)), reps=1, warm=False)
        t_p, i_p, visited = walk[0]
        exact9 = torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
        # K10's whole walk through the kernel, each round's lanes kept, and
        # through the plain version; the kernel against its plain version on
        # every round's lanes
        round_args = []

        def k10_kept(*args):
            round_args.append(args)
            return ck.first_hit_pair(*args)

        t_kw, i_kw, stats = pfh.pair_walk(tiles, o, d, live, kernel=k10_kept)
        t_pw, i_pw, stats_p = pfh.pair_walk(tiles, o, d, live)
        exact10 = (torch.equal(t_kw, t_pw) and torch.equal(i_kw, i_pw) and stats["rounds"] == stats_p["rounds"]
                   and len(round_args) == stats["rounds"] and torch.equal(t_kw, t10) and torch.equal(i_kw, i10))
        k10_plain_ms, k10_err = 0.0, 0.0
        for args in round_args:
            t_kr, i_kr = ck.first_hit_pair(*args)
            lanes = []
            k10_plain_ms += time_ms(lambda: lanes.append(ck.pair_tile_plain(*args)), reps=1, warm=False)
            t_pr, i_pr = lanes[0]
            exact10 = exact10 and torch.equal(t_kr, t_pr) and torch.equal(i_kr, i_pr)
            k10_err = max(k10_err, float((t_kr - t_pr).abs().nan_to_num(0.0).max()))
        # Each op against K1 big over the sentinel-padded sorted faces: the same table
        st = torch.from_numpy(sfh.padded_sorted_tris(tris.cpu().numpy(), order, tiles.n_tiles)).to(dev)
        table_s = ck.first_hit_table(st)
        same_table = torch.equal(table_s[1], tiles.center) and torch.equal(table_s[2], tiles.face_tab)
        t_d, i_d = ck.ray_first_hit(o, d, st, table_s)
        t_d = torch.where(live, t_d, torch.inf)
        i_d = torch.where(live, i_d, -1)
        equal9 = torch.equal(t9, t_d) and torch.equal(i9, i_d)
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
        # Times, and the bound of the (ray, face) pairs this data needs
        k9_ms = time_ms(lambda: ck.first_hit_sorted(*kargs))
        k9_glue_ms = time_ms(lambda: sfh.sorted_first_hit(tiles, o, d, alive))
        # K10's kernel time in one op call: the sum of its rounds' launches
        k10_round_ms = [time_ms(lambda: ck.first_hit_pair(*args)) for args in round_args]
        k10_ms = sum(k10_round_ms)
        k10_glue_ms = time_ms(lambda: pfh.pair_first_hit(tiles, o, d, alive), reps=5)
        k1_ms = time_ms(lambda: ck.ray_first_hit(o, d, st, table_s), reps=3)
        boxes = face_boxes(tris)
        pad_order = torch.nn.functional.pad(order_t, (0, tiles.n_tiles * sfh.TILE_FACES - order_t.numel()), value=-1)
        needed, _ = first_hit_pairs(o[live], d[live], t9[live], i9_orig[live], boxes, order=pad_order,
                                    group=sfh.TILE_FACES)
        nb, n_t = perm.shape[0], tiles.n_tiles
        tab_bytes = n_t * sfh.TILE_FACES * 64
        b9_ms, b9_by = bound_ms(needed * FLOPS_BIG_PAIR, o_s.shape[0] * 28 + nb * (8 * n_t + 4) + tab_bytes
                                + o_s.shape[0] * 8)
        # K10's op computes the same first hit: the rays (and their flags)
        # read once, the table read once, t and face written once
        b10_ms, b10_by = bound_ms(needed * FLOPS_BIG_PAIR, r * 25 + tab_bytes + r * 8)
        n_lanes = round_args[0][0].shape[0]
        visits = int(visited.sum())
        pairs, ideal = int(stats["pairs"]), int(stats["needed"])
        unres = int(stats["unresolved_first"])
        print(f"check K9/K10 on the {label}: {r} rays ({n_live} live) x {tiles.n_faces} faces ({tiles}); K9 "
              f"identical to its plain version {exact9}; K10 identical to its plain version (every round's "
              f"lanes, {n_lanes} in the first, and the whole walk) {exact10}; the dense big table over the sorted faces is the "
              f"tiles' {same_table}; K9 equals K1 big over the sorted faces {equal9}, K10 {equal10}; against K1 big "
              f"over the mesh as it is t identical {orig_ok}, faces differ at {ties} ties; K9 visits {visits} of "
              f"{nb * n_t} (block, tile) pairs ({visits / (nb * n_t):.2%}), {visits / max(nb, 1):.1f} tiles per "
              f"block of 512; K10 {stats['rounds']} rounds, tests {pairs / max(n_live, 1):.2f} tiles per live ray "
              f"({pairs} pairs; entered before the hit {ideal / max(n_live, 1):.2f}), "
              f"{unres / max(n_live, 1):.2%} of live rays unresolved after round 1; (ray, face) pairs this data "
              f"needs {needed}; K9 kernel {k9_ms:.3f} ms, with its glue {k9_glue_ms:.3f} ms, plain "
              f"{k9_plain_ms:.3f} ms, bound {b9_ms:.5f} ms ({b9_by}); K10 kernel {k10_ms:.3f} ms over its "
              f"{len(round_args)} rounds ({', '.join(f'{t:.3f}' for t in k10_round_ms)}), the op {k10_glue_ms:.3f} "
              f"ms, plain {k10_plain_ms:.3f} ms (all rounds), bound {b10_ms:.5f} ms ({b10_by}); K1 big "
              f"{k1_ms:.3f} ms on the same rays", flush=True)
        if not exact9 or not exact10:
            fail(f"K9 or K10 disagrees with its plain version on the {label}")
        if not (same_table and equal9 and equal10):
            fail(f"K9 or K10 differs from K1 big over the sorted faces on the {label}")
        if not orig_ok:
            fail(f"K9 or K10 differs from K1 big over the mesh beyond a tie on the {label}")
        if "first_hit_sorted" not in results:
            # Where the K10 op's time goes besides its kernel (the first wavefront only)
            _, busy10 = profiled(lambda: pfh.pair_first_hit(tiles, o, d, alive), "K10 op profile")
            print(f"K10 op on the {label}: device busy {busy10:.3f} ms of {k10_glue_ms:.3f} ms, "
                  f"{stats['rounds']} kernel launches, {k10_ms:.3f} ms in all")
            results["first_hit_sorted"] = dict(max_abs_err=float((t_k - t_p).abs().nan_to_num(0.0).max()),
                                               bound_ms=b9_ms, bound_by=b9_by, ms=k9_ms, plain_ms=k9_plain_ms,
                                               library_ms=None)
            results["first_hit_pair"] = dict(max_abs_err=k10_err, bound_ms=b10_ms, bound_by=b10_by, ms=k10_ms, plain_ms=k10_plain_ms,
                                             library_ms=None)
    return launches


def check_k5_bounces(kept: dict) -> None:
    """K5 on a trace's own bounces (`kept`: rays per source -> the first and
    last bounce's (bins, deposits, n_bins)): against its plain version (bins
    identical, sums within 1e-5 relative plus 1e-6 of the peak), timed
    beside one `index_add_` of the same fold."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    if len(kept) != 3:
        fail(f"the HOA3 trace ran K5 at ray counts {sorted(kept)}, expected three decimation phases")
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
            print(f"check bin_histogram at the HOA3 trace's {which} bounce of {rays} rays per source ({tuple(dep.shape)}, "
                  f"{int((dep != 0).any(-1).sum())} rays deposit, in {int(torch.unique(bins[keep]).numel())} bins; "
                  f"{warps} warps a CTA, clusters of {cluster}): bin mismatches {bins_bad}, within tolerance {ok}; "
                  f"{time_ms(lambda: ck.bin_histogram(bins, dep, n_bins)):.4f} ms per call (device "
                  f"{device_ms(lambda: ck.bin_histogram(bins, dep, n_bins)):.4f}), index_add_ "
                  f"{time_ms(lambda: out.index_add_(0, flat.long(), vals)):.4f} ms (device "
                  f"{device_ms(lambda: out.index_add_(0, flat.long(), vals)):.4f}), bound {b_ms:.5f} ms ({b_by})",
                  flush=True)
            if bins_bad or not ok:
                fail(f"bin_histogram disagrees with its plain version at the HOA3 trace's bounce of {rays} rays")


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


def table_build_ms(tris) -> float:
    """Milliseconds to build `first_hit_table(tris)` (the big table and its
    face tree) on the card, host clock around a synchronised build."""
    from audiblelight_tpu_torch.ops import cuda_kernels as ck

    ck.first_hit_table(tris)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        ck.first_hit_table(tris)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return float(np.median(times))


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
    # The small (F <= 512) variant is off the flagship path; held all the same
    small = st.acoustic_tris[:500].contiguous()
    t_k, i_k = ck.ray_first_hit(origins, dirs, small)
    t_p, i_p = ck.ray_first_hit_plain(origins, dirs, small)
    fin = torch.isfinite(t_p)
    ulp_s = int(ulp_distance(t_k[fin], t_p[fin]).max()) if fin.any() else 0
    small_bad = int((i_k != i_p).sum()) + int((torch.isfinite(t_k) != fin).sum())
    print(f"check first_hit_small: {r} rays x 500 faces: mismatches {small_bad}, max ulp {ulp_s}")
    if small_bad or ulp_s > 1:
        fail("first_hit_small disagrees with its plain version")
    # Off the flagship path (launched 0 times there), so timed on its own line
    needed, _ = first_hit_pairs(origins, dirs, t_k, i_k, face_boxes(small))
    b_ms, b_by = bound_ms(needed * FLOPS_MT_PAIR, r * 24 + 500 * 36 + r * 8)
    small_ms = time_ms(lambda: ck.ray_first_hit(origins, dirs, small))
    small_plain_ms = time_ms(lambda: ck.ray_first_hit_plain(origins, dirs, small), reps=3)
    print(f"first_hit_small (off the main paths): {r} rays x 500 faces: {small_ms:.4f} ms, plain "
          f"{small_plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}, {needed} pairs this data needs), max |dt| "
          f"{float((t_k[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0:.3e}")

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
    any_rows = []
    for label, args in (("rain table", rain), ("diffraction legs", legs), ("direct on full mesh", direct)):
        k = ck.segments_occluded(*args)
        p = ck.segments_occluded_plain(*args)
        bad = int((k != p).sum())
        print(f"check any_hit {label}: {args[0].shape[0]} segments x {args[2].shape[0]} faces: "
              f"mismatches {bad}, blocked {float(k.float().mean()):.3f}", flush=True)
        if bad:
            fail(f"any_hit disagrees with its plain version ({label})")
        any_rows.append(args)
    n_seg, n_f = legs[0].shape[0], legs[2].shape[0]
    pairs = any_hit_pairs(*legs)
    b_ms, b_by = bound_ms(pairs * FLOPS_MT_PAIR, n_seg * 24 + n_f * 36 + n_seg)
    print(f"any_hit diffraction legs: {pairs} pairs tested of {n_seg * n_f}")
    results["any_hit"] = dict(
        max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms=time_ms(lambda: ck.segments_occluded(*legs)),
        plain_ms=time_ms(lambda: ck.segments_occluded_plain(*legs), reps=3),
    )

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
    h_k = ck.deposit_histogram(*dep_args, **kw)
    h_p = ck.deposit_histogram_plain(*dep_args, **kw)
    bins_bad = int(((h_k != 0) != (h_p != 0)).sum())
    peak = h_p.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    rel = float(((h_k - h_p).abs() / peak).max())
    err = float((h_k - h_p).abs().max())
    print(f"check deposit_histogram: {r} rays x 4 capsules -> {tuple(h_k.shape)}: bin mismatches "
          f"{bins_bad}, max |diff| {err:.3e}, max |diff| / histogram peak {rel:.3e}", flush=True)
    if bins_bad or rel > 1e-5:
        fail("deposit_histogram disagrees with its plain version")
    # Yardstick: the fold alone as one PyTorch call, on the plain version's deposits
    n_bins_pad = 512
    lis_v = listeners[:, None, :] - hit[None]
    d_l = norm3(lis_v)
    arrival = (dist[None] + d_l) * ck._f32(1.0 / 343.0)
    flat = ((torch.arange(4, device=dev)[:, None] * 16 + torch.arange(r, device=dev)[None] // 5000)
            * n_bins_pad + (arrival * 500.0).to(torch.int64).clamp(0, n_bins_pad - 1)).reshape(-1)
    deps = (e_refl[None] * torch.rand(4, r, 1, device=dev)).reshape(-1, 4)
    hist = torch.zeros(4 * 16 * n_bins_pad, 4, device=dev)
    b_ms, b_by = bound_ms(r * 4 * FLOPS_DEPOSIT, r * 44 + 4 * r + h_k.numel() * 4)
    results["deposit_histogram"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=time_ms(lambda: ck.deposit_histogram(*dep_args, **kw)),
        plain_ms=time_ms(lambda: ck.deposit_histogram_plain(*dep_args, **kw), reps=3),
        library_ms=time_ms(lambda: hist.index_add_(0, flat, deps)),
    )
    # K4: the same bounce at one FOA listener point (the rig's centre)
    lis1 = torch.tensor([MIC_CENTRE], dtype=torch.float32, device=dev)
    foa_args = (hit, normal, e_refl, dist, (face_occ[:, face.clamp_min(0).long()] | ~ok[None]).contiguous(), lis1)
    h_k = ck.deposit_histogram_foa(*foa_args, **kw)
    h_p = ck.deposit_histogram_foa_plain(*foa_args, **kw)
    bins_bad = int(((h_k != 0) != (h_p != 0)).sum())
    peak = h_p.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    rel = float(((h_k - h_p).abs() / peak).max())
    err = float((h_k - h_p).abs().max())
    print(f"check deposit_histogram_foa: {r} rays x 1 listener -> {tuple(h_k.shape)}: bin mismatches "
          f"{bins_bad}, max |diff| {err:.3e}, max |diff| / histogram peak {rel:.3e}", flush=True)
    if bins_bad or rel > 1e-5 or tuple(h_k.shape) != (16, 4, 4, 501):
        fail("deposit_histogram_foa disagrees with its plain version")
    # Yardstick: the fold alone (16 channel-bands per ray) as one index_add_
    d_1 = norm3(lis1 - hit)
    flat1 = (torch.arange(r, device=dev) // 5000 * n_bins_pad
             + ((dist + d_1) * ck._f32(1.0 / 343.0) * 500.0).to(torch.int64).clamp(0, n_bins_pad - 1))
    deps1 = torch.rand(r, 16, device=dev) * 1e-6
    hist1 = torch.zeros(16 * n_bins_pad, 16, device=dev)
    b_ms, b_by = bound_ms(r * FLOPS_DEPOSIT_FOA, r * 45 + h_k.numel() * 4)
    results["deposit_histogram_foa"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=time_ms(lambda: ck.deposit_histogram_foa(*foa_args, **kw)),
        plain_ms=time_ms(lambda: ck.deposit_histogram_foa_plain(*foa_args, **kw), reps=3),
        library_ms=time_ms(lambda: hist1.index_add_(0, flat1, deps1)),
    )
    del any_rows, legs, rain, h_k, h_p, foa_args

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
    for label, end, r_pad in (("centroid", listeners.mean(dim=0), 0.02), ("capsule 0", listeners[0], r_caps)):
        star = st_x.star_accel_for(centroid, r_pad)
        if star is None:
            fail(f"no star layout toward the {label}")
        seg_k = so.star_segments_occluded(star, starts_x, end)
        seg_p = so.star_segments_occluded_plain(star, starts_x, end)
        ends_x = end.expand(starts_x.shape[0], 3).contiguous()
        seg_d = ck.segments_occluded(starts_x, ends_x, st_x.tris)
        torch.cuda.synchronize()
        bad_p, bad_d = int((seg_k != seg_p).sum()), int((seg_k != seg_d).sum())
        tested, needed = star_pairs(star, star_windows_on(star, st_x.tris), starts_x, end, seg_k)
        n_seg = starts_x.shape[0]
        print(f"check star_any_hit toward the {label} ({star}): {n_seg} segments x {n_full} faces: mismatches "
              f"{bad_p} against its plain version, {bad_d} against any_hit; blocked {float(seg_k.float().mean()):.3f}; "
              f"pairs tested by the block cull {tested} ({tested / (n_seg * n_full):.2%} of {n_seg * n_full} "
              f"dense), needed by this data {needed}", flush=True)
        if bad_p or bad_d:
            fail(f"star_any_hit disagrees toward the {label}")
        k6_ms = time_ms(lambda: so.star_segments_occluded(star, starts_x, end))
        k2_ms = time_ms(lambda: ck.segments_occluded(starts_x, ends_x, st_x.tris), reps=3)
        b_ms, b_by = bound_ms(needed * FLOPS_MT_PAIR, n_seg * 12 + n_full * 36 + n_seg)
        print(f"star_any_hit toward the {label}: {k6_ms:.4f} ms; any_hit on the same segments {k2_ms:.4f} ms; "
              f"bound {b_ms:.5f} ms ({b_by})", flush=True)
        if "star_any_hit" not in results:
            results["star_any_hit"] = dict(
                max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, ms=k6_ms, library_ms=k2_ms,
                plain_ms=time_ms(lambda: so.star_segments_occluded_plain(star, starts_x, end), reps=3),
            )

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
    del t_x, face_x, hit_x, n_x, seg_k, seg_p, seg_d, ends_x

    elapsed(t_start, "main path")
    # 4. The main path: three flagship scenes through the fused renderer
    OUT.mkdir(parents=True, exist_ok=True)
    scenes = [flagship_inputs(st.tris, np.random.default_rng(100 + i), dev) for i in range(3)]
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
    print(f"main path: 3 scenes in {sum(scene_s):.2f} s ({', '.join(f'{x:.3f}' for x in scene_s)} s); "
          f"launches {launches}", flush=True)
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
    # The trace keeps its first bounce's rays on the LOD for the K9/K10 phase
    from audiblelight_tpu_torch.rir import raytracer

    first_bounce = []

    def keep_first_bounce(o, d, prev_face, tris, route):
        if not first_bounce:
            first_bounce.append((tris, o.clone(), d.clone()))
        return first_hit_route(o, d, prev_face, tris, route)

    first_hit_route = raytracer._first_hit_route
    raytracer._first_hit_route = keep_first_bounce
    try:
        irs = renderer.trace(torch.Generator(device=dev).manual_seed(7), src_t, listeners, face_occ)
    finally:
        raytracer._first_hit_route = first_hit_route
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

    def keep_inputs(*args, **kwargs):
        keep_first_last(bounces, args[0].shape[0], ([a.clone() for a in args], kwargs))
        return ck.deposit_histogram_foa(*args, **kwargs)

    raytracer.deposit_histogram_foa = keep_inputs
    try:
        irs_f = frend.trace(f_in[0], *f_in[1:4]).cpu().numpy()  # (4, S, L)
    finally:
        raytracer.deposit_histogram_foa = ck.deposit_histogram_foa
    if len(bounces) != 3:
        fail(f"the FOA trace ran K4 at ray counts {sorted(bounces)}, expected three decimation phases")
    for rays, kept in sorted(bounces.items(), reverse=True):
        for which, (args, kwargs) in zip(("first", "last"), kept):
            h_k = ck.deposit_histogram_foa(*args, **kwargs)
            h_p = ck.deposit_histogram_foa_plain(*args, **kwargs)
            bins_bad = int(((h_k != 0) != (h_p != 0)).sum())
            rel = float(((h_k - h_p).abs() / h_p.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
            b_ms, b_by = bound_ms(rays * FLOPS_DEPOSIT_FOA, rays * 45 + h_k.numel() * 4)
            print(f"check deposit_histogram_foa at the FOA scene's {which} bounce of {rays} rays "
                  f"({kwargs['n_sources']} sources): bin mismatches {bins_bad}, max |diff| / histogram peak "
                  f"{rel:.3e}; {time_ms(lambda: ck.deposit_histogram_foa(*args, **kwargs)):.4f} ms, plain "
                  f"{time_ms(lambda: ck.deposit_histogram_foa_plain(*args, **kwargs), reps=3):.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by})", flush=True)
            if bins_bad or rel > 1e-5:
                fail(f"deposit_histogram_foa disagrees with its plain version at {rays} rays")
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
    # Scene.generate() with the default engine config (no mesh
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
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    xscene.generate(output_dir=exact_dir)
    torch.cuda.synchronize()
    exact_s = time.time() - t0
    exact_launches = dict(ck.launch_counts)
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

    # K6 again on that CLI scene's own bounces: its trace, loaded from the
    # JSON, keeps the star's inputs at the first and the last bounce of each
    # decimation phase (keyed by ray count)
    xs = Scene.from_json(sorted((cli_root / "exact" / "metadata_dev").rglob("*.json"))[0], device=dev)
    kept_star, windows = {}, {}

    def keep_star(star, starts, end):
        keep_first_last(kept_star, starts.shape[0], (star, starts.clone(), end.clone()))
        return so.star_segments_occluded(star, starts, end)

    raytracer.star_segments_occluded = keep_star
    try:
        xs.state.trace_irs_device()
    finally:
        raytracer.star_segments_occluded = so.star_segments_occluded
    if len(kept_star) != 3:
        fail(f"the exact trace ran K6 at ray counts {sorted(kept_star)}, expected three decimation phases")
    for rays, kept in sorted(kept_star.items(), reverse=True):
        for which, (star, starts, end) in zip(("first", "last"), kept):
            seg_k = so.star_segments_occluded(star, starts, end)
            seg_p = so.star_segments_occluded_plain(star, starts, end)
            ends = end.expand(rays, 3).contiguous()
            seg_d = ck.segments_occluded(starts, ends, xs.state.device_state.tris)
            bad_p, bad_d = int((seg_k != seg_p).sum()), int((seg_k != seg_d).sum())
            if id(star) not in windows:
                windows[id(star)] = star_windows_on(star, xs.state.device_state.acoustic_tris)
            tested, needed = star_pairs(star, windows[id(star)], starts, end, seg_k)
            b_ms, b_by = bound_ms(needed * FLOPS_MT_PAIR, rays * 12 + n_full * 36 + rays)
            print(f"check star_any_hit at the exact scene's {which} bounce of {rays} segments: mismatches {bad_p} "
                  f"against its plain version, {bad_d} against any_hit; blocked {float(seg_k.float().mean()):.3f}; "
                  f"{time_ms(lambda: so.star_segments_occluded(star, starts, end)):.4f} ms, any_hit "
                  f"{time_ms(lambda: ck.segments_occluded(starts, ends, xs.state.device_state.tris), reps=3):.4f} ms, "
                  f"pairs tested {tested} of {rays * n_full}, needed {needed}, bound {b_ms:.5f} ms ({b_by})",
                  flush=True)
            if bad_p or bad_d:
                fail(f"star_any_hit disagrees at the exact scene's bounce of {rays} segments")
    del kept_star, windows, xs

    elapsed(t_start, "K7 route")
    # 10b. The exact-mode scene again with config.USE_TILED_FIRST_HIT (K7)
    tiled_n, surface = tiled_phase(exact_scene, xscene, (exact_s, exact_launches, exact_irs, exact_trace_ms), st_x,
                                   table_x, (origins, dirs), results)
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

    main_launches = dict(launches, deposit_histogram_foa=cli_launches["foa"]["deposit_histogram_foa"],
                         star_any_hit=exact_main["star_any_hit"], bin_histogram=rig_main["hoa3"]["bin_histogram"],
                         first_hit_mxu=mxu_n["first_hit_mxu"], first_hit_tiled=tiled_n["first_hit_tiled"],
                         first_hit_sorted=sorted_pair_n["first_hit_sorted"],
                         first_hit_pair=sorted_pair_n["first_hit_pair"])
    sources = {"first_hit_big": "first_hit.cu", "any_hit": "any_hit.cu", "deposit_histogram": "deposit_histogram.cu",
               "deposit_histogram_foa": "deposit_histogram_foa.cu", "bin_histogram": "bin_histogram.cu",
               "star_any_hit": "star_any_hit.cu", "first_hit_tiled": "tiled_first_hit.cu",
               "first_hit_mxu": "mxu_first_hit.cu", "first_hit_sorted": "sorted_first_hit.cu",
               "first_hit_pair": "pair_first_hit.cu"}
    replaces = {
        "first_hit_big": "audiblelight_tpu/ops/pallas_kernels.py:46",
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
    sys.exit(main())
