"""Traffic in a mesh room, on the CPU: the places and paths it draws against
every face by brute force in float64, the port's Scene API accepting every
event through the rlr backend's settings, and shoebox rings unchanged.

    python -m pytest portbench/tests -p no:cacheprovider
"""

from __future__ import annotations

import hashlib
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest

from portbench import manifest, meshroom, program, traffic

# Digests of shoebox rings, frozen from the generator before it took mesh
# rooms: a shoebox configuration keeps every draw and its order
SHOEBOX_RINGS = {
    ("dcase5", 7): "d7266b22e893689da1cc7c612fc0fd74f961d3c48b99cb4cd9711afd178c517e",
    ("dcase5", 2**31 + 12345): "eb95183bf2a3fbfeee3e2ad96f927335611bbf669b1e13cb28112919675bc856",
    ("dense16", 7): "a7ff21bc0d1fa4959abb7068be9a7510f7903ac3040662030bd2fa2fe9705621",
    ("dense16", 2**31 + 12345): "09ac03c81397659b3f4fab8f503565842ab90c92db62bee0fa52bb5379ec6a55",
}
# Not PARITY_DIR: the brute force counts crossings along another ray
OTHER_DIR = np.array([-0.4830, 0.2241, 0.8466]) / np.linalg.norm([-0.4830, 0.2241, 0.8466])
# Positions are rounded to the micrometre, which moves a point up to
# sqrt(3) micrometres from where its place was tested
ROUNDING_M = 2e-6
# A box of furniture, 1.5 x 1 x 0.8 m, on the floor of a 6 x 5 x 3 m room
FURNITURE = ([2.0, 1.5, 0.0], [3.5, 2.5, 0.8])


def _box(lo, hi, inward: bool) -> tuple:
    """(vertices, faces) of an axis-aligned box, its faces wound outward
    (inward for a room's shell)."""
    v = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])], float)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f[:, ::-1].copy() if inward else f


def tiny_mesh() -> tuple:
    """A 6 x 5 x 3 m room with one box of furniture on its floor, 24 faces."""
    (v0, f0), (v1, f1) = _box([0, 0, 0], [6, 5, 3], True), _box(*FURNITURE, False)
    return np.concatenate([v0, v1]), np.concatenate([f0, f1 + len(v0)])


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """A copy of the benchmark's meshes beside the tiny one, as files."""
    base = tmp_path_factory.mktemp("bench")
    (base / "meshes").mkdir()
    for path in (manifest.HERE / "meshes").glob("*.npz"):
        (base / "meshes" / path.name).write_bytes(path.read_bytes())
    v, f = tiny_mesh()
    np.savez(base / "meshes" / "tiny_room.npz", vertices=v, faces=f)
    return base


def _config(mesh: str) -> dict:
    """The shoebox configuration with a mesh room and the rlr backend at
    small tracer settings (the Scene API places; no test here renders)."""
    return dict(manifest.load_config("shoebox_foa"), backend="rlr", room=dict(mesh=mesh), device="cpu",
                rig=dict(microphone_type="ambeovr", encoding="omni"),
                engine=dict(max_ir_length=0.1, mesh_simplification=True, ray_decimation=False, diffraction=True))


# The tiny room's mix: legs of 1.5-2.25 m, longer than two margins, so
# that the test of a leg against the faces decides
TINY_MIX = dict(trajectory_points=3, ring=12)


@pytest.fixture
def mesh_room(meshes, monkeypatch):
    """Mesh rooms read from the fixture's folder."""
    load = manifest.load_mesh
    monkeypatch.setattr(manifest, "load_mesh", lambda name, base=meshes: load(name, base))
    meshroom.space.cache_clear()
    yield
    meshroom.space.cache_clear()


class Faces:
    """Every face of a mesh, for tests by brute force. Each test bounds each
    face by its centre and radius and takes the exact test where the bound
    does not decide."""

    def __init__(self, vertices, faces):
        tri = np.asarray(vertices, float)[faces]
        self.a, self.b, self.c = tri[:, 0], tri[:, 1], tri[:, 2]
        self.centre = tri.mean(axis=1)
        self.radius = np.linalg.norm(tri - self.centre[:, None], axis=2).max(axis=1)

    def _on(self, f):
        return self.a[f], self.b[f], self.c[f]

    def distance(self, p) -> float:
        lower = np.linalg.norm(self.centre - p, axis=1) - self.radius
        f = lower <= lower.min() + 2 * self.radius.max()
        return float(np.sqrt(meshroom.point_triangle_dist2(p, *self._on(f)).min()))

    def crossed(self, p, d, t_max=np.inf) -> int:
        """Faces that p + t d, 0 < t < t_max, crosses."""
        v = self.centre - p
        t = v @ d / (d @ d)
        off = np.linalg.norm(v - t[:, None] * d, axis=1)
        reach = self.radius / np.sqrt(d @ d)
        f = (off <= self.radius) & (t >= -reach) & (t <= t_max + reach)
        return int(meshroom.ray_crosses(p, d, *self._on(f), t_max).sum())


def _check_ring(ring, vertices, faces, margin: float) -> None:
    every = Faces(vertices, faces)
    for spec in ring:
        assert spec["room"] == {"mesh": spec["room"]["mesh"]}
        for p in [spec["mic"]["position"]] + [p for e in spec["events"]
                                               for p in (e["trajectory"] if e["moving"] else [e["position"]])]:
            p = np.asarray(p)
            assert every.crossed(p, OTHER_DIR) % 2 == 1 and every.distance(p) >= margin - ROUNDING_M, (spec, p)
        for e in spec["events"]:
            traj = np.asarray(e["trajectory"] if e["moving"] else [])
            assert not any(every.crossed(p, q - p, 1.0) for p, q in zip(traj[:-1], traj[1:])), e


@pytest.mark.parametrize("mix,seed", list(SHOEBOX_RINGS))
def test_shoebox_rings_are_unchanged(mix, seed):
    ring = traffic.ring(manifest.load_config("shoebox_foa"), manifest.load_mix(mix), seed)
    assert hashlib.sha256(json.dumps(ring, sort_keys=True).encode()).hexdigest() == SHOEBOX_RINGS[(mix, seed)]


@pytest.mark.parametrize("mesh", ["tiny_room", "scanned_room_0"])
def test_free_space_agrees_with_every_face(mesh, mesh_room):
    v, f = manifest.load_mesh(mesh)
    space = meshroom.space(mesh, 0.35)
    rng = np.random.default_rng(5)
    # Points all over the box, and points just either side of the margin
    # from faces: a face's point moved along the face's normal
    tri = v[f][rng.integers(0, len(f), 150)]
    on = tri[:, 0] + rng.uniform(0, 0.5, (150, 1)) * (tri[:, 1] - tri[:, 0]) + rng.uniform(0, 0.5, (150, 1)) * (tri[:, 2] - tri[:, 0])
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    pts = np.concatenate([rng.uniform(space.lo - 0.2, space.hi + 0.2, (250, 3)),
                          on + normal * rng.choice([-1, 1], (150, 1)) * rng.uniform(0.3, 0.4, (150, 1))])
    every = Faces(v, f)
    dist = np.array([every.distance(p) for p in pts])
    inside = np.array([every.crossed(p, OTHER_DIR) % 2 == 1 for p in pts])
    in_box = np.all((pts >= space.lo) & (pts <= space.hi), axis=1)
    expect = in_box & inside & (dist >= 0.35)
    assert expect.sum() > 50 and (~expect).sum() > 50
    assert [space.ok(p) for p in pts] == expect.tolist()
    assert space.ok(pts[expect]) and not space.ok(pts[expect | (np.arange(len(pts)) == np.argmin(expect))])


def test_a_leg_through_furniture_is_not_clear(mesh_room):
    space = meshroom.space("tiny_room", 0.35)
    a, b, beside = [1.2, 2.0, 0.5], [4.3, 2.0, 0.5], [4.3, 3.4, 0.5]
    assert space.ok(np.array([a, b, beside]))
    assert not space.clear(np.array([a, b])) and space.clear(np.array([a, [1.2, 3.4, 0.5], beside]))


def test_tiny_room_rings_keep_clear_of_every_face(mesh_room):
    v, f = tiny_mesh()
    mix = dict(manifest.load_mix("dcase5"), **TINY_MIX)
    for seed in (1, 2**33 + 3):
        _check_ring(traffic.ring(_config("tiny_room"), mix, seed), v, f, mix["wall_margin_m"])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_scanned_room_rings_keep_clear_of_every_face(seed):
    v, f = manifest.load_mesh("scanned_room_0")
    mix = manifest.load_mix("dcase5")
    _check_ring(traffic.ring(_config("scanned_room_0"), mix, seed), v, f, mix["wall_margin_m"])


def test_a_room_with_no_free_place_names_the_scene(mesh_room):
    mix = dict(manifest.load_mix("dcase5"), min_mic_distance_m=20.0)  # farther than the room is long
    with pytest.raises(ValueError, match="scene 4"):
        traffic.scene(_config("tiny_room"), mix, 1, 4)


@pytest.mark.parametrize("mesh,mix,seed", [("tiny_room", TINY_MIX, 2), ("scanned_room_0", {}, 1)],
                         ids=["tiny_room", "scanned_room_0"])
def test_the_scene_api_accepts_every_event(mesh, mix, seed, mesh_room):
    """Every event of a ring placed by the port's Scene API through the rlr
    backend's settings, on the CPU: none refused, none dropped."""
    from portbench.backends import rlr

    rlr.mesh.cache_clear()
    config, mix = _config(mesh), dict(manifest.load_mix("dcase5"), **mix)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, clip in enumerate(traffic.clips(mix, int(config["sample_rate"]), seed)):
            paths.append(str(Path(tmp) / f"clip{i}.wav"))
            program.write_clip(paths[-1], clip, int(config["sample_rate"]))
        for spec in traffic.ring(config, mix, seed):
            scene = program.build_scene(config, spec, paths)
            assert len(scene.events) == len(spec["events"])
            assert scene.state.mesh is rlr.mesh(mesh)
    rlr.mesh.cache_clear()


def test_the_rlr_settings_are_the_clis():
    from portbench.backends import rlr

    config = _config("scanned_room_0")
    config["engine"] = dict(config["engine"], indirect_ray_count=5000, indirect_ray_depth=200)
    spec = dict(room=dict(mesh="scanned_room_0"), state_seed=77)
    kw = rlr.backend_kwargs(config, spec)
    assert kw["mesh"] is rlr.backend_kwargs(config, dict(spec, state_seed=5))["mesh"]
    assert len(kw["mesh"].faces) == 110_592 and kw["mesh"].vertices.dtype == np.float64
    assert (kw["material"], kw["add_to_context"], kw["seed"]) == (None, False, 77)
    assert kw["rlr_kwargs"] == dict(max_ir_length=0.1, mesh_simplification=True, ray_decimation=False,
                                    diffraction=True, indirect_ray_count=5000, indirect_ray_depth=200)
