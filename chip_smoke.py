"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the tracer's CUDA kernels from audiblelight_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card at the flagship
shapes, then drives the port's two main paths:

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
  timed and profiled.

Each path's kernel launches are counted from zero just before it and read
just after; a kernel of the path that did not launch fails the run. It
prints one JSON line of kernel results; the last line is
{"ok": true, "device": {...}}.

Exits non-zero without printing a result when no CUDA card is present or the
port's package is not beside this file.
"""

from __future__ import annotations

import csv
import json
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
# The SELD CLI runs: the repo's WAVs of four DCASE2023 classes, the flagship
# width, 4 static and 1 moving event per scene, two scenes per format
CLI_CLASSES = {"femaleSpeech": 0, "maleSpeech": 1, "telephone": 3, "musicInstrument": 9}
CLI_FLAGS = ["--backend", "rlr", "--n-scenes", "2", "--duration", "60", "--rays", "5000",
             "--ray-depth", "60", "--ray-decimation", "--ir-seconds", "1.0",
             "--min-events-static", "4", "--max-events-static", "4",
             "--min-events-moving", "1", "--max-events-moving", "1", "--seed", "7"]
KERNELS = ("first_hit_big", "first_hit_small", "any_hit", "deposit_histogram_foa", "deposit_histogram")
MIC_PATH = ("first_hit_big", "any_hit", "deposit_histogram")
FOA_PATH = ("first_hit_big", "any_hit", "deposit_histogram_foa")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of `fn()` on the card, by CUDA events, after a warm-up."""
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


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(least time in ms, what bounds it) for `flops` fp32 operations and `nbytes` moved."""
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(torch.int64)).abs()


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


def check_cli_outputs(out: Path, layout: str, t_scene: int) -> None:
    """The CLI's DCASE layout for two train scenes: a 4-channel 24 kHz int16
    WAV each, not silent; a CSV each with frames in 0-600 and the four
    classes' ids; a JSON each."""
    from audiblelight_tpu_torch.io.audio import _read_header, wav_read

    stems = [f"dev-train-alight/fold1_scene1_{i:03d}" for i in range(2)]
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

    # 3. Each kernel against its plain version at the flagship shapes
    # K1: one decimation phase's first bounce, 80k rays from interior points
    gen = torch.Generator(device=dev).manual_seed(1)
    src0, *_ = flagship_inputs(st.tris, np.random.default_rng(1), dev)
    origins = torch.as_tensor(src0, device=dev).repeat_interleave(5000, dim=0)
    dirs = _sphere_directions(gen, origins.shape[0], dev)
    t_k, i_k = ck.ray_first_hit(origins, dirs, st.acoustic_tris)
    t_p, i_p = ck.ray_first_hit_plain(origins, dirs, st.acoustic_tris)
    torch.cuda.synchronize()
    fin = torch.isfinite(t_p)
    idx_bad = int((i_k != i_p).sum())
    ulp = int(ulp_distance(t_k[fin], t_p[fin]).max()) if fin.any() else 0
    inf_bad = int((torch.isfinite(t_k) != fin).sum())
    err = float((t_k[fin] - t_p[fin]).abs().max())
    print(f"check first_hit_big: {origins.shape[0]} rays x {n_lod} faces: face mismatches {idx_bad}, "
          f"miss mismatches {inf_bad}, max ulp {ulp}, max |dt| {err:.3e}", flush=True)
    if idx_bad or inf_bad or ulp > 1:
        fail("first_hit_big disagrees with its plain version")
    r, f = origins.shape[0], n_lod
    b_ms, b_by = bound_ms(r * f * FLOPS_BIG_PAIR, r * 24 + f * 64 + r * 8)
    results["first_hit_big"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms=time_ms(lambda: ck.ray_first_hit(origins, dirs, st.acoustic_tris)),
        plain_ms=time_ms(lambda: ck.ray_first_hit_plain(origins, dirs, st.acoustic_tris), reps=3),
    )
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
    b_ms, b_by = bound_ms(r * 500 * FLOPS_MT_PAIR, r * 24 + 500 * 36 + r * 8)
    small_ms = time_ms(lambda: ck.ray_first_hit(origins, dirs, small))
    small_plain_ms = time_ms(lambda: ck.ray_first_hit_plain(origins, dirs, small), reps=3)
    print(f"first_hit_small (off the main paths): {r} rays x 500 faces: {small_ms:.4f} ms, plain "
          f"{small_plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max |dt| "
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
    irs = renderer.trace(torch.Generator(device=dev).manual_seed(7), src_t, listeners, face_occ)
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

    def profiled(fn, label):
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

    avgs, busy = profiled(scene, "scene profile")
    _, busy_trace = profiled(trace, "trace profile")
    if busy > 0:
        print(f"device idle share: scene {1 - busy / scene_ms:.1%}, trace {1 - busy_trace / trace_ms:.1%} "
              f"(busy time from the profiler over the unprofiled CUDA-event time)")
    per_scene = {}
    for ev in avgs:
        t_dev = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0)) / 1e3
        for name in MIC_PATH:
            if f"{name}_kernel" in ev.key and t_dev > 0:
                per_scene[name] = (t_dev, ev.count)
    for name, (t_ms, n) in sorted(per_scene.items()):
        print(f"per scene: {name} {t_ms:.3f} ms over {n} launches")
    if not per_scene:
        print("per scene: kernel times not measured (the profiler saw no device time)")
    print(f"scene time: median {np.median(scene_s):.3f} s (host clock) over 3 scenes of "
          f"{SCENE_SECONDS:.0f} s on {card}")

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
        check_cli_outputs(cli_root / layout, layout, t_scene)

    # 8. FOA physics: one CLI scene, loaded from its JSON, traced again; each
    # unoccluded source's W direct path peaks at d/c and (X, Y, Z)/W there
    # points at the source
    from audiblelight_tpu_torch.core import Scene
    from audiblelight_tpu_torch.render import build_scene_plan

    from audiblelight_tpu_torch.rir import raytracer

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
        kept = bounces.setdefault(args[0].shape[0], [])
        kept[min(len(kept), 1):] = [([a.clone() for a in args], kwargs)]
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
    for ev in avgs_f:
        t_dev = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0)) / 1e3
        for name in FOA_PATH:
            if f"{name}_kernel" in ev.key and t_dev > 0:
                print(f"FOA per scene: {name} {t_dev:.3f} ms over {ev.count} launches")
    print(f"CLI scene time: median {np.median(cli_seconds['mic'] + cli_seconds['foa']):.3f} s (host clock, "
          f"placement, render and writes) over {len(cli_seconds['mic'] + cli_seconds['foa'])} scenes on {card}")

    main_launches = dict(launches, deposit_histogram_foa=cli_launches["foa"]["deposit_histogram_foa"])
    sources = {"first_hit_big": "first_hit.cu", "any_hit": "any_hit.cu", "deposit_histogram": "deposit_histogram.cu",
               "deposit_histogram_foa": "deposit_histogram_foa.cu"}
    replaces = {
        "first_hit_big": "audiblelight_tpu/ops/pallas_kernels.py:46",
        "any_hit": "audiblelight_tpu/ops/pallas_kernels.py:375",
        "deposit_histogram": "audiblelight_tpu/ops/pallas_kernels.py:594",
        "deposit_histogram_foa": "audiblelight_tpu/ops/pallas_kernels.py:738",
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
