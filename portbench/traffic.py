"""The one traffic generator: a ring of scene descriptions from a
configuration, a mix and a seed.

A configuration (`configs/<name>.json`) fixes the deployment: the backend,
its room, the rig, the scene length and rate, the engine settings. A
mix (`mixes/<name>.json`) fixes the events of a scene: how many static and
moving, their lengths, trajectory points and lengths, SNRs, the margins
and gaps of their places, and the ring's size. Every draw comes from
`numpy.random.default_rng([seed, ...])`, so the same seed gives the same
ring, and every seed gives the same counts and shapes in another
arrangement.

The room is one of two kinds:

* a shoebox, `"room": {"min_m": [...], "max_m": [...]}`: each scene draws
  its size, and a place is free inside it by `wall_margin_m`;
* a mesh, `"room": {"mesh": "<name>"}`: the closed triangle mesh
  `meshes/<name>.npz`, the same in every scene. A place is free inside it
  and `wall_margin_m` or more from every face (`meshroom.MeshSpace`), and
  no leg of a trajectory crosses a face. Nothing asks a source to see the
  rig: furniture between them is part of the room. A trajectory's
  direction and length are drawn before its start, which is uniform among
  the starts that keep the whole path in the drawing box.

A scene description is plain data (lists and numbers), the only thing both
the program and the reference receive:

    {"duration", "sample_rate", "ref_db", "state_seed", "bed_seed",
     "room": [Lx, Ly, Lz] | {"mesh": "<name>"},
     "mic": {"type", "position"},
     "events": [{"moving", "position" | "trajectory", "scene_start",
                 "duration", "snr", "class_id", "clip"}]}

Positions are rounded to the micrometre.
"""

from __future__ import annotations

import numpy as np

from portbench import meshroom

# Seed streams of one run, so that each kind of draw has its own
_CLIPS, _SCENE = 1, 2
# Draws of a place, a scene's in all, before it is given up
ATTEMPTS = 100_000


def clips(mix: dict, sample_rate: int, seed: int) -> list:
    """The run's dry audio clips, float32 at `sample_rate`, each
    mix["clip_seconds"] long: a decaying harmonic tone of a random
    fundamental with a few partials, and a little noise."""
    rng = np.random.default_rng([seed, _CLIPS])
    n = round(float(mix["clip_seconds"]) * sample_rate)
    t = np.arange(n) / sample_rate
    out = []
    for _ in range(int(mix["clips"])):
        f0 = rng.uniform(110.0, 1760.0)
        partials = rng.uniform(0.1, 1.0, 4)
        tone = sum(a * np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 2 * np.pi))
                   for k, a in enumerate(partials))
        x = tone * np.exp(-t * rng.uniform(0.1, 1.0)) + 0.05 * rng.standard_normal(n)
        out.append((x / np.max(np.abs(x))).astype(np.float32))
    return out


class FreeSpace:
    """Where sources and the rig may stand in a shoebox: inside the room by
    `margin`. A box is convex, so every path between free points is clear."""

    def __init__(self, room, margin: float):
        self.lo, self.hi = np.full(3, margin), np.asarray(room, float) - margin

    def ok(self, pts: np.ndarray) -> bool:
        pts = np.atleast_2d(pts)
        return bool(np.all((pts >= self.lo) & (pts <= self.hi)))

    def clear(self, pts) -> bool:
        return True

    def point(self, rng, z_range=None) -> np.ndarray:
        lo, hi = self.lo.copy(), self.hi.copy()
        if z_range is not None:
            lo[2], hi[2] = max(lo[2], z_range[0]), min(hi[2], z_range[1])
        return rng.uniform(lo, hi)


def _far(p, placed, d: float) -> bool:
    return not placed or bool(np.min(np.linalg.norm(np.asarray(placed) - np.atleast_2d(p)[:, None], axis=-1)) >= d)


def _tenths(rng, lo: float, hi: float) -> float:
    """A length in whole tenths of a second in [lo, hi]."""
    return round(float(rng.integers(round(lo * 10), round(hi * 10) + 1)) / 10.0, 1)


def scene(config: dict, mix: dict, seed: int, index: int) -> dict:
    """The `index`-th scene of the ring for `seed`."""
    rng = np.random.default_rng([seed, _SCENE, index])
    dur = float(config["duration_s"])
    margin = float(mix["wall_margin_m"])
    in_mesh = "mesh" in config["room"]
    if in_mesh:
        room = dict(mesh=config["room"]["mesh"])
        space = meshroom.space(room["mesh"], margin)
    else:
        room = rng.uniform(config["room"]["min_m"], config["room"]["max_m"])
        space = FreeSpace(room, margin)
        room = room.round(4).tolist()
    tries = iter(range(ATTEMPTS))

    def attempt():
        if next(tries, None) is None:
            raise ValueError(f"scene {index}: no free place found in {ATTEMPTS} attempts")

    mic = space.point(rng, mix["mic_height_m"])
    while not space.ok(mic):
        attempt()
        mic = space.point(rng, mix["mic_height_m"])
    placed = [mic]
    gap, near = float(mix["min_source_gap_m"]), float(mix["min_mic_distance_m"])

    def source():
        while True:
            attempt()
            p = space.point(rng)
            if np.linalg.norm(p - mic) >= near and _far(p, placed[1:], gap) and space.ok(p):
                return p

    def line(n: int) -> np.ndarray:
        """n points on a straight path from the origin, mostly level, of the mix's length."""
        step = rng.standard_normal(3) * np.array([1.0, 1.0, 0.1])
        length = rng.uniform(*mix["trajectory_length_m"])
        return np.linspace(0.0, length, n)[:, None] * step / np.linalg.norm(step)

    def trajectory(n: int):
        while True:
            if in_mesh:
                # The path first, then its start, uniform among those that
                # keep it in the drawing box: in a room of this size most
                # paths from a start drawn first leave it, and each start
                # drawn costs a test against the faces
                path = line(n)
                lo, hi = space.lo - path.min(axis=0), space.hi - path.max(axis=0)
                attempt()
                if np.any(lo > hi):
                    continue
                traj = rng.uniform(lo, hi) + path
            else:
                traj = source() + line(n)
            if (space.ok(traj) and np.all(np.linalg.norm(traj - mic, axis=1) >= near)
                    and _far(traj, placed[1:], gap) and space.clear(traj)):
                return traj

    kinds = [False] * int(mix["static"]) + [True] * int(mix["moving"])
    events = []
    for moving in kinds:
        ev = dict(moving=moving, snr=round(float(rng.uniform(*mix["snr_db"])), 3),
                  class_id=int(rng.integers(0, int(config["classes"]))), clip=int(rng.integers(0, int(mix["clips"]))))
        if moving:
            traj = trajectory(int(mix["trajectory_points"]))
            placed.extend(traj)
            ev.update(trajectory=traj.round(6).tolist(), duration=float(mix["moving_seconds"]))
        else:
            p = source()
            placed.append(p)
            ev.update(position=p.round(6).tolist(), duration=_tenths(rng, *mix["static_seconds"]))
        events.append(ev)
    # Onsets on `max_overlap` lanes, each lane's events one after another
    # with random gaps, so that no more than max_overlap events sound at once
    lanes = int(config["max_overlap"])
    order = rng.permutation(len(events))
    for lane in range(lanes):
        mine = [events[i] for i in order[lane::lanes]]
        slack = dur - 0.1 * (len(mine) + 1) - sum(e["duration"] for e in mine)
        if slack < 0:
            raise ValueError("the mix's events do not fit the scene on its lanes")
        cuts = np.sort(rng.uniform(0.0, slack, len(mine)))
        t = 0.1
        prev = 0.0
        for e, c in zip(mine, cuts):
            t += c - prev
            prev = c
            e["scene_start"] = round(t, 3)
            t += e["duration"] + 0.1
    # In onset order: a scene admits an event that overlaps fewer than
    # max_overlap of the events already added, which lanes added in onset
    # order always do
    events.sort(key=lambda e: e["scene_start"])
    return dict(duration=dur, sample_rate=int(config["sample_rate"]), ref_db=int(config["ref_db"]),
                state_seed=int(rng.integers(2**31)), bed_seed=int(rng.integers(2**31)),
                room=room,
                mic=dict(type=config["rig"]["microphone_type"], position=mic.round(6).tolist()), events=events)


def ring(config: dict, mix: dict, seed: int) -> list:
    """The run's ring of scene descriptions, mix["ring"] of them."""
    return [scene(config, mix, seed, i) for i in range(int(mix["ring"]))]
