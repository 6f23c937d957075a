"""Generate a DCASE2023-Task3-style SELD dataset with the PyTorch/CUDA port.

    python -m audiblelight_tpu_torch.seld --fg-dir <folder of WAVs> --output-dir <out> \\
        [--backend shoebox] [--ism-order 12] --channel-layout foa [--device cpu]
    python -m audiblelight_tpu_torch.seld --fg-dir <folder of WAVs> --output-dir <out> \\
        --backend rlr --mesh room.obj --channel-layout foa [--device cpu]
    python -m audiblelight_tpu_torch.seld --fg-dir <folder of WAVs> --output-dir <out> \\
        --backend sofa --sofa room.sofa --channel-layout mic [--device cpu]
    python -m audiblelight_tpu_torch.seld --fg-dir <folder of WAVs> --output-dir <out> \\
        --backend rlr --mesh room.obj --placement-workers 4 --fused-batch 4 [--device cpu]
    python -m audiblelight_tpu_torch.seld ... --backend rlr --mesh room.obj --mesh-devices 2 [--device cpu]
    python -m audiblelight_tpu_torch.seld ... --backend rlr --mesh room.obj \\
        --coordinator host:port --num-processes P --process-id i
    python -m audiblelight_tpu_torch.seld --fg-dir <folder> --output-dir <out> \\
        --backend rlr --assets 9A [--mesh-dir <folder of .glb>] [--scapes-per-room 1] [--device cpu]
    python -m audiblelight_tpu_torch.seld --fg-dir <folder> --output-dir <out> \\
        --backend sofa --assets 9A --sofa-dir <folder of .sofa> --channel-layout mic [--device cpu]

The port's counterpart of scripts/seld/generate_dataset.py, with the same
flags, defaults, seeding and file layout: N one-minute 24 kHz scenes in the
FOA ("foalistener") or MIC ("ambeovr") format, static and moving events
placed in a shoebox room of random size (the default backend, its IRs from
the image-source engine, rendered through the plan path), a ray-traced
mesh room (the fused renderer) or a measured room read from a SOFA file
(its IRs read by the port's own HDF5 reader, the plan path), written as

    <output>/<fmt>_dev/dev-<split>-alight/fold<k>_scene<i>_<j>_mic000.wav
    <output>/metadata_dev/dev-<split>-alight/fold<k>_scene<i>_<j>_mic000.csv
    <output>/metadata_dev/dev-<split>-alight/fold<k>_scene<i>_<j>.json

Scenes whose outputs exist are skipped (resume), and a scene in which no
event placed is built again. The same --seed places the same events as the
reference script. `--device` (default cuda) selects where the placement
queries and the render run; without a card the default raises.

With `--backend shoebox`, `--pipeline` defaults to `compiled`: every scene
renders through the plan path, one `Scene.generate(compiled=True)` at a
time (IR banks, device stems, host mix). On rlr, `--no-mesh-simplification`
traces the full mesh with the exact rain mode (the star any-hit per
bounce); such scenes, and every scene under `--no-device-mix`, render
through the plan path too. The rlr fused path is dispatch-ahead
(`pipeline.render_scenes_pipelined`): `--fused-batch` scenes of one
renderer trace in one bounce loop (`FusedSceneRenderer.render_mix_batch`),
and the writes run on a completion thread.

`--placement-workers N` with N > 0 selects the pooled driver (rlr only,
`generate_pooled`): N spawned worker processes, which never see the card,
place and pack the scenes (`prep.ScenePrepPool`, placement on the host BVH,
the rain table on the CPU), and the main process renders them in batches of
`--fused-batch` and writes them (`prep.render_prepped_scenes`). Each job
draws its own seed from --seed (skipped jobs too) and seeds the global
streams with it, so the outputs do not depend on N. At the default, 0, the
serial loop runs, whose scenes share one stream as the reference script's
do, so its scenes are not the pooled driver's.

Several ranks (one process, one card each) share a run: `--mesh-devices N`
spawns N rank processes on this host (rank r on `cuda:r`; gloo ranks on the
CPU with `--device cpu`), and `--coordinator host:port --num-processes P
--process-id i` makes this process rank i of a group that the other
processes join (`parallel.init_distributed`, NCCL between cards). Every rank
runs the pooled driver on its share of the jobs (`generate_pooled`) and of
`--placement-workers` (the total, split over the spawned ranks); the outputs
do not depend on the number of ranks. A host with fewer cards than
`--mesh-devices` exits with the reference's message.

The fused pipeline and the pooled driver run on rlr only: `--pipeline
fused`, `--placement-workers` or `--mesh-devices` on another backend exits
with the reference script's message before anything is written.

`--pipeline classic`, on every backend, renders each scene as
`Scene.generate()` does by default: the classic per-event render (each event
convolved on its own, the mix on the host).

`--augmentations <names>` gives each event one augmentation drawn from the
named entries of the reference script's table (`AUGMENTATIONS`), with its
draws: the same --seed gives the same augmentation parameters. The
augmentations run where the scene renders: their time stretch and pitch
shift in torch on a card, on the host with `--device cpu`.

On the sofa backend the file defines the rig (its ListenerShortName and
receiver positions), so no microphone is added; `--channel-layout` names
the output folder only. As in the reference script, the SOFA world state
gets no seed: `--seed` fixes the scenes' counts and timings, not where
events snap on the measured grid.

`--assets <split>` generates the reference's room table
(`seld_assets.MESHES`, or `SOFAS` on the sofa backend): each train and test
room of the split, `--scapes-per-room` scenes each (default the table's:
1,200 scenes over a split), written as fold<1|2>_scene<room index>_<scape>.
A room is its `<room>.glb` under `--mesh-dir` where that file exists, else
the table's deterministic stand-in room; on the sofa backend
`tau_<room>_<fmt>.sofa` or `<room>_<fmt>.sofa` under `--sofa-dir`. The
fused loop keeps a renderer per room (its LRU), and the pooled driver
drives the jobs room by room, each room's renderers built from a template
scene of its own (the room's first live job), as the reference does; the
prep workers build each job's own room. Outputs still do not depend on the
worker or rank count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from scipy import stats

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.augmentation import Distortion, Invert, PitchShift, Reverse, SpeedUp
from audiblelight_tpu_torch.core import Scene, write_outputs
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.pipeline import render_scene_audio_compiled, render_scenes_pipelined
from audiblelight_tpu_torch.render import _bucket
from audiblelight_tpu_torch.synthesize import render_scene_classic
from audiblelight_tpu_torch.utils import logger

DURATION = 60
SAMPLE_RATE = 24000
AUGMENTATIONS = {
    # The reference script's table, its PitchShift entry included:
    # stats.uniform(loc=-7, scale=0) always draws -7 semitones
    "pitchshift": (PitchShift, dict(semitones=stats.uniform(-7, 0))),
    "speedup": (SpeedUp, dict(stretch_factor=stats.uniform(0.9, 0.2))),
    "reverse": Reverse,
    "invert": Invert,
    "distortion": (Distortion, dict(drive_db=stats.uniform(0.0, 10.0))),
}


def get_augmentations(names) -> list:
    """Resolve augmentation names into (cls, kwargs) entries."""
    out = []
    for name in names:
        if name not in AUGMENTATIONS:
            raise ValueError(f"Augmentation {name} is not a valid parameter for this script!")
        entry = AUGMENTATIONS[name]
        if isinstance(entry, tuple):
            cls, kws = entry
            out.append((cls, dict(kws, sample_rate=SAMPLE_RATE)))
        else:
            out.append((entry, dict(sample_rate=SAMPLE_RATE)))
    return out


def build_parser() -> argparse.ArgumentParser:
    """The reference script's flags and defaults, plus --device."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--fg-dir", type=str, required=True, help="foreground audio root")
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--backend", choices=["shoebox", "rlr", "sofa"], default="shoebox")
    p.add_argument("--mesh", type=str, default=None, help="mesh file (rlr backend)")
    p.add_argument("--sofa", type=str, default=None, help="SOFA file (sofa backend)")
    p.add_argument("--assets", type=str, default=None,
                   help="room split of the asset table (e.g. 9A, 12, 144): train/test rooms x scapes per room")
    p.add_argument("--mesh-dir", type=str, default=None, help="folder of the rooms' .glb meshes (with --assets)")
    p.add_argument("--sofa-dir", type=str, default=None, help="folder of the rooms' .sofa files (with --assets)")
    p.add_argument("--scapes-per-room", type=int, default=None,
                   help="scenes per room, in place of the asset table's counts")
    p.add_argument("--channel-layout", choices=["foa", "mic"], default="mic")
    p.add_argument("--n-scenes", type=int, default=10, help="scenes per split")
    p.add_argument("--train-frac", type=float, default=0.75)
    p.add_argument("--max-overlap", type=int, default=config.MAX_OVERLAP)
    p.add_argument("--min-events-static", type=int, default=config.MIN_STATIC_EVENTS)
    p.add_argument("--max-events-static", type=int, default=config.MAX_STATIC_EVENTS)
    p.add_argument("--min-events-moving", type=int, default=config.MIN_MOVING_EVENTS)
    p.add_argument("--max-events-moving", type=int, default=config.MAX_MOVING_EVENTS)
    p.add_argument("--augmentations", nargs="*", default=[], choices=list(AUGMENTATIONS),
                   help="augmentation pool; one random augmentation per event")
    p.add_argument("--materials", action="store_true", help="use acoustic materials")
    p.add_argument("--material", type=str, default="Default")
    p.add_argument("--ism-order", type=int, default=12, help="shoebox image order")
    p.add_argument("--rays", type=int, default=None, help="indirect ray count (rlr)")
    p.add_argument("--ray-depth", type=int, default=None, help="indirect ray depth (rlr)")
    p.add_argument("--ir-seconds", type=float, default=config.MAX_IR_SECONDS)
    p.add_argument("--fused-batch", type=int, default=4,
                   help="scenes per batched fused render (one bounce loop for the batch)")
    p.add_argument("--duration", type=float, default=DURATION)
    p.add_argument("--seed", type=int, default=utils.SEED)
    p.add_argument("--pipeline", choices=["fused", "compiled", "classic"], default=None)
    p.add_argument("--mesh-simplification", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--ray-decimation", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--diffraction", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--device-mix", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--placement-workers", type=int, default=0,
                   help="scene-prep worker processes of the pooled driver (rlr; 0 = the serial loop); "
                        "outputs do not depend on the count")
    p.add_argument("--mesh-devices", type=int, default=1,
                   help="rank processes to spawn on this host, one card each (rlr); 1 = this process alone")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port (or an init URL) of the ranks' rendezvous; this process is rank --process-id "
                        "of --num-processes")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="where placement queries and renders run (cuda, or cpu)")
    return p


def _mesh_for(args, room: Optional[str], meshes: dict):
    """The TriMesh of a job: its table room (the `.glb` under --mesh-dir,
    loaded once, else the stand-in), or --mesh."""
    from audiblelight_tpu_torch.geometry.mesh import TriMesh, load_mesh
    from audiblelight_tpu_torch.seld_assets import resolve_room

    if room is not None:
        mesh = resolve_room(room, args.mesh_dir)
    elif args.mesh is not None:
        mesh = args.mesh
    else:
        raise ValueError("--mesh or --assets is required for the rlr backend")
    if isinstance(mesh, TriMesh):
        return mesh
    if str(mesh) not in meshes:
        meshes[str(mesh)] = load_mesh(mesh)
    return meshes[str(mesh)]


def _sofa_for(args, room: Optional[str]):
    """The SOFA file of a job: its table room's under --sofa-dir (the
    converter's `tau_<room>_<fmt>.sofa`, else `<room>_<fmt>.sofa`), or --sofa."""
    if room is None:
        if args.sofa is None:
            raise ValueError("--sofa or --assets is required for the sofa backend")
        return args.sofa
    if args.sofa_dir is None:
        raise SystemExit("--sofa-dir is required with --assets on the sofa backend")
    cands = [Path(args.sofa_dir) / f"tau_{room}_{args.channel_layout}.sofa",
             Path(args.sofa_dir) / f"{room}_{args.channel_layout}.sofa"]
    return next((c for c in cands if c.is_file()), cands[0])


def build_backend_kwargs(args, rng: np.random.Generator, meshes: dict, room: Optional[str] = None) -> dict:
    """The world state's constructor kwargs for one scene, with the
    reference's draws of `rng`: a shoebox's dimensions, then its seed; an
    rlr room's seed; none for a SOFA file. `room` is the job's asset-table
    room (None: --mesh or --sofa)."""
    if args.backend == "sofa":
        return dict(sofa=_sofa_for(args, room))
    if args.backend == "shoebox":
        dims = rng.uniform([5.0, 4.0, 2.6], [10.0, 8.0, 3.5])
        return dict(
            dimensions=dims.tolist(),
            absorption=args.material if args.materials else 0.3,
            max_order=args.ism_order,
            max_ir_length=args.ir_seconds,
            seed=int(rng.integers(2**31)),
        )
    mesh = _mesh_for(args, room, meshes)
    rlr_kwargs = dict(
        max_ir_length=args.ir_seconds,
        mesh_simplification=args.mesh_simplification,
        ray_decimation=args.ray_decimation,
        diffraction=args.diffraction,
    )
    if args.rays is not None:
        rlr_kwargs["indirect_ray_count"] = args.rays
    if args.ray_depth is not None:
        rlr_kwargs["indirect_ray_depth"] = args.ray_depth
    return dict(
        mesh=mesh,
        material=args.material if args.materials else None,
        add_to_context=False,
        rlr_kwargs=rlr_kwargs,
        seed=int(rng.integers(2**31)),
    )


def asset_jobs(args) -> list:
    """The run's jobs (split, scene number, scape, room): with --assets the
    table's rooms x scapes (the scene number is the room's index in its
    split), else --n-scenes scenes of scene 1 in the one --mesh/--sofa room
    (None), split by --train-frac."""
    if args.assets is None:
        n_train = round(args.n_scenes * args.train_frac)
        return ([("train", 1, i, None) for i in range(n_train)]
                + [("test", 1, i, None) for i in range(args.n_scenes - n_train)])
    from audiblelight_tpu_torch.seld_assets import get_assets

    chosen = get_assets(args.backend, args.assets)
    jobs = []
    for split in ("train", "test"):
        per_room = args.scapes_per_room if args.scapes_per_room is not None else chosen[f"scapes_per_{split}_mesh"]
        for room_idx, room in enumerate(chosen[split]):
            jobs.extend((split, room_idx, scape, room) for scape in range(per_room))
    return jobs


def job_paths(args, split: str, scene_num: int, scape_num: int) -> tuple:
    """(audio path, metadata path) stems of one job, the reference's layout."""
    fold = 1 if split == "train" else 2
    common = f"dev-{split}-alight/fold{fold}_scene{scene_num}_{str(scape_num).zfill(3)}"
    out = Path(args.output_dir)
    return out / f"{args.channel_layout}_dev/{common}", out / f"metadata_dev/{common}"


def outputs_exist(audio_path: Path, metadata_path: Path) -> bool:
    """A job's first WAV and CSV are written (resume skips it)."""
    return ((audio_path.parent / f"{audio_path.name}_mic000.wav").is_file()
            and (metadata_path.parent / f"{metadata_path.name}_mic000.csv").is_file())


def build_scene(args, split: str, scene_num: int, scape_num: int, rng: np.random.Generator,
                depth: int = 0, meshes: Optional[dict] = None, room: Optional[str] = None):
    """Construct and place one scene in the job's room (`room`, an asset
    table entry, or None for --mesh/--sofa): (scene, audio path, metadata
    path), or None when its outputs exist (resume). Builds again when no
    event placed."""
    meshes = {} if meshes is None else meshes
    audio_path, metadata_path = job_paths(args, split, scene_num, scape_num)
    common = f"{audio_path.parent.name}/{audio_path.name}"
    if outputs_exist(audio_path, metadata_path):
        logger.warning(f"Skipping existing scene {common}")
        return None

    audio_path.parent.mkdir(parents=True, exist_ok=True)
    metadata_path.parent.mkdir(parents=True, exist_ok=True)

    scene = Scene(
        duration=args.duration,
        sample_rate=SAMPLE_RATE,
        backend=args.backend,
        backend_kwargs=build_backend_kwargs(args, rng, meshes, room=room),
        fg_path=args.fg_dir,
        max_overlap=args.max_overlap,
        event_augmentations=get_augmentations(args.augmentations) if args.augmentations else None,
        class_mapping="DCASE2023Task3",
        device=args.device,
    )
    if args.backend != "sofa":  # a SOFA file defines its own rig
        scene.add_microphone(microphone_type="foalistener" if args.channel_layout == "foa" else "ambeovr")

    n_static = int(rng.integers(args.min_events_static, args.max_events_static + 1))
    n_moving = int(rng.integers(args.min_events_moving, args.max_events_moving + 1))
    placed = 0
    for event_type, n in (("static", n_static), ("moving", n_moving)):
        for _ in range(n):
            try:
                scene.add_event(event_type=event_type, augmentations=1 if args.augmentations else None,
                                max_place_attempts=100)
                placed += 1
            except (ValueError, FileNotFoundError) as e:
                logger.warning(f"Could not place {event_type} event: {e}")

    if placed == 0:
        if depth >= 5:
            raise RuntimeError(f"Could not place any events for scene {common}")
        logger.warning(f"No events placed for {common}; retrying...")
        return build_scene(args, split, scene_num, scape_num, rng, depth + 1, meshes=meshes, room=room)

    scene.add_ambience(noise="gaussian")
    return scene, audio_path, metadata_path


def plan_kwargs(args) -> dict:
    """Pinned plan buckets of a run, as the reference script pins them on its fused path."""
    return dict(
        max_static=_bucket(max(args.max_events_static, 1)),
        max_moving=_bucket(max(args.max_events_moving, 1)),
        max_traj=32,
        pad_audio_seconds=config.MAX_EVENT_DURATION,
    )


def generate_fused(args, jobs: list, rng: np.random.Generator, stats: dict) -> list[float]:
    """Place, render and write every job in order: through
    `render_scenes_pipelined` (the fused renderer, `--fused-batch` scenes a
    batch, or the plan path where it refuses a scene), or, for
    `--pipeline compiled`, each scene through the plan path, or, for
    `--pipeline classic`, each scene through the classic per-event render.
    Returns each rendered scene's host-clock seconds, from the start of its
    placement to the end of its writes; `stats` gets the run's wall time
    ("wall_s"), its scene count ("n_scenes") and the host's core count
    ("cpu_count")."""
    t_start = time.perf_counter()
    paths, meshes, seconds = {}, {}, []

    def factory():
        for idx, (split, scene_num, scape, room) in enumerate(jobs):
            logger.warning(f"[{idx + 1}/{len(jobs)}] {split} scene {scene_num} scape {scape}")
            t0 = time.perf_counter()
            built = build_scene(args, split, scene_num, scape, rng, meshes=meshes, room=room)
            if built is None:
                continue
            scene, audio_path, metadata_path = built
            paths[id(scene)] = (audio_path, metadata_path, t0)
            yield scene

    def complete(scene, audio):
        scene.audio = audio
        audio_path, metadata_path, t0 = paths.pop(id(scene))
        write_outputs(scene, audio_path, metadata_path)
        seconds.append(time.perf_counter() - t0)
        logger.warning(f"wrote {audio_path.name} in {seconds[-1]:.3f} s")

    if args.pipeline == "compiled":
        for scene in factory():
            complete(scene, render_scene_audio_compiled(scene))
    elif args.pipeline == "classic":
        for scene in factory():
            render_scene_classic(scene)
            complete(scene, scene.audio)
    else:
        render_scenes_pipelined(factory(), complete, max_in_flight=4, plan_kwargs=plan_kwargs(args),
                                fused_batch=args.fused_batch, device_mix=args.device_mix)
    stats.update(wall_s=time.perf_counter() - t_start, n_scenes=len(seconds), cpu_count=os.cpu_count())
    return seconds


def make_pooled_prep(args_dict: dict, jobs: list, plan_kwargs: dict):
    """The pooled driver's worker-side builder (`prep.ScenePrepPool`): each
    task places and packs one job's scene on the CPU with the job's own
    seed, which also seeds the global streams (the scipy placement
    distributions draw from numpy's), so a run places the same scenes
    whatever its worker count."""
    from audiblelight_tpu_torch.prep import prep_scene

    args = argparse.Namespace(**dict(args_dict, device="cpu"))
    meshes: dict = {}

    def prep(index: int, seed: int):
        split, scene_num, scape, *room = jobs[index]  # (split, scene, scape[, room])
        room = room[0] if room else None
        utils.seed_everything(int(seed) % (2**31))
        built = build_scene(args, split, scene_num, scape, np.random.default_rng(seed), meshes=meshes, room=room)
        if built is None:  # its outputs appeared since the main process's scan
            return None
        return prep_scene(built[0], index, plan_kwargs)

    return prep


def _world() -> tuple:
    """(world size, rank) of the run's process group, (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def generate_pooled(args, jobs: list, rng: np.random.Generator, stats: dict) -> list[float]:
    """The pooled driver (`--placement-workers`, `--mesh-devices`): worker
    processes place and pack the scenes (`make_pooled_prep`), the rank
    renders them in batches of `--fused-batch` through one renderer per
    source bucket of a room's template scene and writes them
    (`prep.render_prepped_scenes`). The counterpart of the reference
    script's generate_pooled; rlr only.

    In a process group of W ranks (`--coordinator`, or the ranks that
    `--mesh-devices` spawns) every rank scans for finished jobs and draws
    every job's seed, a barrier follows (so that no rank's scan sees
    another's writes), and rank r renders and writes the live jobs j with
    j % W == r. The jobs are driven room by room (`--assets` names a room
    per job): every rank builds a room's template scene alike, from the
    room's first live job. Each job carries its own seed and a batch gives each scene its
    one-scene bits, so the outputs do not depend on W.

    Returns the seconds of the world's scenes (rank by rank; each the
    host-clock seconds since its rank's previous writes ended, the first
    since the driver started); `stats` gets this rank's
    `render_prepped_scenes` stages, the world's scene count ("n_scenes"),
    the wall time ("wall_s"), the host's core count ("cpu_count") and the
    world size ("world_size")."""
    import torch.distributed as dist

    from audiblelight_tpu_torch.pipeline import FusedSceneRenderer
    from audiblelight_tpu_torch.prep import ScenePrepPool, render_prepped_scenes
    from audiblelight_tpu_torch.render import build_scene_plan

    world, rank = _world()
    t_start = time.perf_counter()
    pk = plan_kwargs(args)
    live_jobs, paths, seeds = [], {}, {}
    for job in jobs:  # the resume filter; a seed is drawn for every job, skipped ones too
        audio_path, metadata_path = job_paths(args, *job[:3])
        seed = int(rng.integers(2**31))
        if outputs_exist(audio_path, metadata_path):
            logger.warning(f"Skipping existing scene {audio_path.parent.name}/{audio_path.name}")
            continue
        audio_path.parent.mkdir(parents=True, exist_ok=True)
        metadata_path.parent.mkdir(parents=True, exist_ok=True)
        paths[len(live_jobs)] = (audio_path, metadata_path)
        seeds[len(live_jobs)] = seed
        live_jobs.append(job)
    if world > 1:
        dist.barrier()
    mine = [i for i in range(len(live_jobs)) if i % world == rank]
    total = {"prep_wait_s": 0.0, "dispatch_s": 0.0, "pull_s": 0.0, "complete_s": 0.0, "n_scenes": 0}
    seconds: list = []
    last = [t_start]
    if not live_jobs:
        stats.update(total, wall_s=time.perf_counter() - t_start, cpu_count=os.cpu_count(), world_size=world)
        return seconds

    def complete(prepped, wav):
        audio_path, metadata_path = paths[prepped.index]
        wav_write(audio_path.parent / f"{audio_path.name}_{prepped.mic_alias}.wav", wav, SAMPLE_RATE,
                  subtype="int16")
        for mic, text in prepped.csv_texts.items():
            (metadata_path.parent / f"{metadata_path.name}_{mic}.csv").write_text(text, encoding="utf-8")
        metadata_path.with_suffix(".json").write_text(prepped.scene_json, encoding="utf-8")
        now = time.perf_counter()
        seconds.append(now - last[0])
        last[0] = now

    # A renderer holds one room, so the jobs are driven room by room (in
    # the order of their first live job), each room's renderers built from
    # a template scene of its own: the room's first live job, which every
    # rank builds alike
    rooms: dict = {}
    for i, job in enumerate(live_jobs):
        rooms.setdefault(job[3], []).append(i)
    if mine:
        with ScenePrepPool("audiblelight_tpu_torch.seld:make_pooled_prep",
                           dict(args_dict=vars(args), jobs=live_jobs, plan_kwargs=pk),
                           workers=args.placement_workers) as pool:
            meshes: dict = {}
            for room, indices in rooms.items():
                todo = [i for i in indices if i % world == rank]
                if not todo:
                    continue
                first = indices[0]
                split, scene_num, scape, _ = live_jobs[first]
                utils.seed_everything(seeds[first] % (2**31))
                built = build_scene(args, split, scene_num, scape, np.random.default_rng(seeds[first]),
                                    meshes=meshes, room=room)
                if built is None:
                    raise RuntimeError(f"the template scene of room {room or args.mesh} was not built")
                template = built[0]
                template_plan = build_scene_plan(template, **pk)
                renderers: dict = {}

                def renderer_for(bucket: int, _t=template, _p=template_plan, _r=renderers) -> FusedSceneRenderer:
                    if bucket not in _r:
                        _r[bucket] = FusedSceneRenderer.from_scene(_t, _p, bucket)
                    return _r[bucket]

                room_stats: dict = {}
                prepped = (p for p in pool.imap([(i, seeds[i]) for i in todo]) if p is not None)
                render_prepped_scenes(renderer_for, prepped, complete, fused_batch=args.fused_batch,
                                      stats=room_stats)
                for k, v in room_stats.items():
                    total[k] += v
    n_scenes = total["n_scenes"]
    if world > 1:  # the world's count and seconds, rank by rank
        from audiblelight_tpu_torch.parallel import rank_device

        count = torch.tensor([n_scenes], dtype=torch.int64, device=rank_device())
        dist.all_reduce(count, op=dist.ReduceOp.SUM)
        n_scenes = int(count.item())
        per_rank: list = [None] * world
        dist.all_gather_object(per_rank, seconds)
        seconds = [x for part in per_rank for x in part]
    if rank == 0:
        logger.warning(f"Pooled driver rendered {n_scenes} scenes")
    stats.update(total, n_scenes=n_scenes, wall_s=time.perf_counter() - t_start, cpu_count=os.cpu_count(),
                 world_size=world)
    return seconds


def _rank_main(rank: int, argv: list, world: int, init_method: str, workers: list, result_dir: str,
               threads: int) -> None:
    """One rank spawned by `spawn_ranks`: the CLI as rank `rank` of the
    group that `init_method` gathers, with its share of the prep workers;
    rank 0 writes the world's seconds and its stats to `result_dir`."""
    torch.set_num_threads(max(1, threads // world))
    stats: dict = {}
    seconds = main(argv + ["--coordinator", init_method, "--num-processes", str(world), "--process-id", str(rank),
                           "--placement-workers", str(workers[rank])], stats=stats)
    if rank == 0:
        (Path(result_dir) / "rank0.json").write_text(json.dumps(dict(seconds=seconds, stats=stats)))


def spawn_ranks(args, argv: list, stats: dict) -> list[float]:
    """`--mesh-devices N` without `--coordinator`: N rank processes
    ("spawn"), rank r on `cuda:r` (gloo ranks on the CPU with `--device
    cpu`), gathered through a file in a fresh temporary directory, each
    running the pooled driver on its share of the jobs and of
    `--placement-workers` (the total, split over the ranks). Returns and
    fills what rank 0's `generate_pooled` does."""
    import tempfile

    import torch.multiprocessing as tmp

    n = args.mesh_devices
    if torch.device(args.device).type == "cuda" and torch.cuda.device_count() < n:
        raise SystemExit(f"--mesh-devices {n} but only {torch.cuda.device_count()} devices")
    workers = [args.placement_workers // n + (r < args.placement_workers % n) for r in range(n)]
    with tempfile.TemporaryDirectory() as result_dir:
        init_method = (Path(result_dir) / "rendezvous").as_uri()
        tmp.start_processes(_rank_main, args=(argv, n, init_method, workers, result_dir, torch.get_num_threads()),
                            nprocs=n, join=True, start_method="spawn")
        result = json.loads((Path(result_dir) / "rank0.json").read_text())
    stats.update(result["stats"])
    return result["seconds"]


def main(argv: Optional[list] = None, stats: Optional[dict] = None) -> list[float]:
    """Run the generator on `argv` (default: the command line). Returns each
    rendered scene's host-clock seconds (`generate_fused`,
    `generate_pooled`: the world's scenes); `stats`, where given, gets the
    run's wall time, scene count and host core count, and the pooled
    driver's stages and world size. With `--coordinator` this process joins
    the group before anything touches the card and leaves it on its way
    out, on error too."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.pipeline is None:
        args.pipeline = "fused" if args.backend == "rlr" else "compiled"
    if args.backend == "sofa" and args.assets is None and args.sofa is None:
        raise ValueError("--sofa or --assets is required for the sofa backend")
    if args.backend == "sofa" and args.assets is not None and args.sofa_dir is None:
        raise SystemExit("--sofa-dir is required with --assets on the sofa backend")
    if args.assets is not None:
        from audiblelight_tpu_torch.seld_assets import get_assets

        get_assets(args.backend, args.assets)  # an unknown split raises before anything is written
    dev = utils.resolve_device(args.device)
    stats = {} if stats is None else stats
    if args.coordinator is None:
        return _generate(args, argv, stats)
    # A rank of a multi-process run: join the group before anything touches
    # the card, and leave it on the way out, on error too
    import torch.distributed as dist

    from audiblelight_tpu_torch.parallel import init_distributed

    owned = not dist.is_initialized()
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     None if dev.index is None else [dev.index], backend="gloo" if dev.type == "cpu" else "nccl")
    try:
        return _generate(args, argv, stats)
    finally:
        if owned:
            dist.destroy_process_group()


def _generate(args, argv: list, stats: dict) -> list[float]:
    """`main` once its process group, if any, is up: the pooled driver
    (where `--placement-workers` > 0, `--mesh-devices` > 1, or the group has
    several ranks, whose jobs the serial loop could not split), else the
    serial loop."""
    world = _world()[0]
    pooled = args.placement_workers > 0 or args.mesh_devices > 1 or world > 1
    if pooled and args.backend != "rlr":
        raise SystemExit("--placement-workers/--mesh-devices require --backend rlr")
    if not pooled and args.pipeline == "fused" and args.backend != "rlr":
        raise SystemExit("--pipeline fused requires the rlr backend")
    if args.mesh_devices > 1 and args.coordinator is None:
        return spawn_ranks(args, argv, stats)
    if args.mesh_devices > world:
        raise SystemExit(f"--mesh-devices {args.mesh_devices} but only {world} devices")
    # Seed the global streams too: the scipy placement distributions draw
    # from numpy's global RNG
    utils.seed_everything(args.seed)
    rng = np.random.default_rng(args.seed)
    return (generate_pooled if pooled else generate_fused)(args, asset_jobs(args), rng, stats)


if __name__ == "__main__":
    main()
