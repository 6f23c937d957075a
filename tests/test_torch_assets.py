"""The port's asset room tables (audiblelight_tpu_torch/seld_assets.py) and the
SELD CLI's `--assets`, `--mesh-dir` and `--sofa-dir`, against the reference
script's.

- The tables (`MESHES`, `SOFAS`), `room_seed` and every stand-in room of
  split 9A (`synthetic_room`: vertices and faces) equal the reference
  script's; `sanity_check` passes; `resolve_room` prefers a real file.
- `--assets 9A --scapes-per-room 1` on rlr at a tiny size (one static
  event, 128 rays x 4 bounces, 0.1 s IRs, 4 s scenes), with a
  hand-packed `Haymarket.glb` under `--mesh-dir` and stand-ins for the other
  eight rooms, writes 9 WAVs, 9 CSVs and 9 JSONs under the reference's names
  (fold<1|2>_scene<room index>_000); each scene's CSV bytes and JSON equal
  the reference script's `build_scene` for the same jobs and --seed (the
  reference render is not run: the metadata depends only on placement).
- The pooled driver over the same table (one room at a time, a template
  scene per room) writes the same files with one and with two prep workers.
- On the sofa backend each room's file is found under `--sofa-dir` in both
  name layouts (`tau_<room>_<fmt>.sofa` and `<room>_<fmt>.sofa`); without
  `--sofa-dir` the CLI exits with the reference's message.
"""

import importlib
import json
import random
import shutil
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audiblelight_tpu import utils as jutils
from audiblelight_tpu.synthesize import generate_dcase2024_metadata
from audiblelight_tpu_torch import seld, seld_assets
from audiblelight_tpu_torch.geometry.mesh import scanned_like_room
from audiblelight_tpu_torch.io.audio import wav_read

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


def _reference_module(name: str):
    sys.path.insert(0, str(REPO / "scripts" / "seld"))
    try:
        sys.modules.pop(name, None)
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(REPO / "scripts" / "seld"))


def pack_glb(path: Path, vertices: np.ndarray, faces: np.ndarray) -> None:
    """A minimal GLB: one float32 position accessor, uint32 indices."""
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


def test_tables_and_stand_ins_match_reference():
    ref = _reference_module("seld_dataset_assets")
    assert seld_assets.MESHES == ref.MESHES and seld_assets.SOFAS == ref.SOFAS
    assert seld_assets.TOTAL_SCAPES == ref.TOTAL_SCAPES
    seld_assets.sanity_check()
    for split in ("9A", "144"):
        for room in seld_assets.MESHES[split]["train"] + seld_assets.MESHES[split]["test"]:
            assert seld_assets.room_seed(room) == ref.room_seed(room)
            if split == "9A":
                got, want = seld_assets.synthetic_room(room), ref.synthetic_room(room)
                np.testing.assert_array_equal(got.vertices, want.vertices)
                np.testing.assert_array_equal(got.faces, want.faces)
                assert got.metadata == want.metadata
                assert not got.is_convex and got.is_watertight
    for backend, split in (("rlr", "9A"), ("sofa", "9A"), ("rlr", "36")):
        assert seld_assets.get_assets(backend, split) == ref.get_assets(backend, split)
    with pytest.raises(ValueError, match="Expected assets in"):
        seld_assets.get_assets("rlr", "10")
    assert seld_assets.resolve_room("Helix.glb", None) is seld_assets.resolve_room("Helix.glb", "/nonexistent")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / "fg" / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / "fg" / wav.parent.name / wav.name)
    (root / "meshes").mkdir()
    room = scanned_like_room((7.0, 5.0, 3.0), subdivision_levels=1, seed=0)
    pack_glb(root / "meshes" / "Haymarket.glb", room.vertices, room.faces)
    assert seld_assets.resolve_room("Haymarket.glb", root / "meshes") == root / "meshes" / "Haymarket.glb"
    return root


def _argv(root: Path, out: str, *flags) -> list:
    return ["--fg-dir", str(root / "fg"), "--output-dir", str(root / out), "--backend", "rlr",
            "--assets", "9A", "--mesh-dir", str(root / "meshes"), "--scapes-per-room", "1",
            "--min-events-static", "1", "--max-events-static", "1", "--min-events-moving", "0",
            "--max-events-moving", "0", "--rays", "128", "--ray-depth", "4", "--ir-seconds", "0.1",
            "--duration", "4", "--seed", str(SEED), "--device", "cpu", *flags]


def _names() -> list:
    out = []
    for split, fold, n in (("train", 1, 6), ("test", 2, 3)):
        for i in range(n):
            stem = f"dev-{split}-alight/fold{fold}_scene{i}_000"
            out += [f"mic_dev/{stem}_mic000.wav", f"metadata_dev/{stem}.json", f"metadata_dev/{stem}_mic000.csv"]
    return sorted(out)


def _files(out: Path) -> dict:
    """Every WAV and CSV's bytes, and every JSON without its creation time."""
    got = {}
    for p in sorted(out.rglob("*")):
        if p.suffix in (".wav", ".csv"):
            got[str(p.relative_to(out))] = p.read_bytes()
        elif p.suffix == ".json":
            d = json.loads(p.read_text())
            d.pop("creation_time")
            got[str(p.relative_to(out))] = d
    return got


@pytest.fixture
def threads():
    """A few torch threads for the CLI runs (nine scenes each), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def serial(assets):
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        seconds = seld.main(_argv(assets, "serial"))
    finally:
        torch.set_num_threads(before)
    return assets, seconds


def test_assets_cli_writes_the_reference_layout(serial):
    root, seconds = serial
    out = root / "serial"
    assert len(seconds) == 9
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) == _names()
    for wav in out.rglob("*.wav"):
        data, sr = wav_read(wav)
        assert sr == 24000 and data.shape == (4, 4 * 24000) and np.abs(data).max() > 100 / 32768
    meshes = {}
    for meta in out.rglob("*.json"):
        meshes[meta.stem] = json.loads(meta.read_text())["state"]["mesh"]
    assert meshes["fold1_scene0_000"]["fpath"] == str(root / "meshes" / "Haymarket.glb")
    assert meshes["fold1_scene0_000"]["ftype"] == ".glb"
    assert meshes["fold1_scene1_000"]["fpath"] == "synthetic://Swisshome"
    assert meshes["fold2_scene2_000"]["fname"] == "Vails" and meshes["fold2_scene2_000"]["synthetic_stand_in"]


def test_assets_metadata_matches_reference_script(serial):
    """The reference script's build_scene over the same table and --seed
    places the same scenes, room by room: the same CSV bytes and JSON."""
    root, _ = serial
    gd = _reference_module("generate_dataset")
    args = seld.build_parser().parse_args(_argv(root, "ref"))
    args.pipeline = "fused"
    jutils.seed_everything(SEED)
    rng = np.random.default_rng(SEED)
    sys.path.insert(0, str(REPO / "scripts" / "seld"))  # its build_backend_kwargs imports the asset module
    try:
        for split, room_idx, scape, room in seld.asset_jobs(args):
            scene, _, _ = gd.build_scene(args, split, room_idx, scape, rng, room=room)
            fold = 1 if split == "train" else 2
            stem = root / f"serial/metadata_dev/dev-{split}-alight/fold{fold}_scene{room_idx}_000"
            want = json.loads(json.dumps(scene.to_dict()))
            got = json.loads(stem.with_suffix(".json").read_text())
            want.pop("creation_time"), got.pop("creation_time")
            assert got == want, room
            csv = generate_dcase2024_metadata(scene)["mic000"].to_csv(sep=",", encoding="utf-8", header=None)
            assert Path(f"{stem}_mic000.csv").read_text() == csv, room
    finally:
        sys.path.remove(str(REPO / "scripts" / "seld"))


def test_pooled_assets_do_not_depend_on_the_worker_count(assets, threads):
    """The pooled driver drives the table room by room; one and two prep
    workers (each building its jobs' own rooms) write the same files."""
    stats1, stats2 = {}, {}
    s1 = seld.main(_argv(assets, "pooled1", "--placement-workers", "1"), stats=stats1)
    s2 = seld.main(_argv(assets, "pooled2", "--placement-workers", "2"), stats=stats2)
    assert len(s1) == len(s2) == 9 and stats1["n_scenes"] == stats2["n_scenes"] == 9
    one, two = _files(assets / "pooled1"), _files(assets / "pooled2")
    assert sorted(one) == [n for n in _names()]
    assert one == two


def test_sofa_assets_find_both_layouts(tmp_path):
    """Each TAU-SRIR room's file under --sofa-dir, in either name layout; the
    CLI exits with the reference's message without --sofa-dir."""
    from audiblelight_tpu.io.sofa import write_sofa

    listener = np.array([2.6, 2.1, 1.3])
    rng = np.random.default_rng(0)
    grid = np.stack(np.meshgrid(np.arange(1, 4, 0.5), np.arange(1, 3, 0.5), [1.0, 1.5], indexing="ij"),
                    -1).reshape(-1, 3)
    irs = rng.standard_normal((len(grid), 4, 200)) * 0.02 * np.exp(-np.arange(200) / 40.0)
    for m, p in enumerate(grid):
        irs[m, :, int(np.linalg.norm(p - listener) / 343 * 24000)] += 1.0
    src = tmp_path / "room.sofa"
    write_sofa(src, irs, grid, listener, rng.uniform(-0.02, 0.02, (4, 3)), 24000)
    table = seld_assets.SOFAS["9A"]
    (tmp_path / "sofas").mkdir()
    expected = {}
    for i, room in enumerate(table["train"] + table["test"]):
        name = f"tau_{room}_mic.sofa" if i % 2 == 0 else f"{room}_mic.sofa"
        shutil.copy(src, tmp_path / "sofas" / name)
        expected[room] = tmp_path / "sofas" / name
    for room, path in expected.items():
        args = seld.build_parser().parse_args(["--fg-dir", ".", "--output-dir", ".", "--backend", "sofa",
                                               "--assets", "9A", "--sofa-dir", str(tmp_path / "sofas")])
        assert seld.build_backend_kwargs(args, np.random.default_rng(0), {}, room=room) == dict(sofa=path)

    fg = tmp_path / "fg"
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (fg / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, fg / wav.parent.name / wav.name)
    argv = ["--fg-dir", str(fg), "--output-dir", str(tmp_path / "out"), "--backend", "sofa", "--assets", "9A",
            "--sofa-dir", str(tmp_path / "sofas"), "--scapes-per-room", "1", "--channel-layout", "mic",
            "--duration", "4", "--max-events-static", "1", "--max-events-moving", "0", "--seed", "5",
            "--device", "cpu"]
    assert len(seld.main(argv)) == 9
    for split, fold, rooms in (("train", 1, table["train"]), ("test", 2, table["test"])):
        for i, room in enumerate(rooms):
            state = json.loads((tmp_path / f"out/metadata_dev/dev-{split}-alight/fold{fold}_scene{i}_000.json")
                               .read_text())["state"]
            assert state["sofa"] == str(expected[room])
    with pytest.raises(SystemExit, match="--sofa-dir is required with --assets on the sofa backend"):
        seld.main([a for a in argv if a not in ("--sofa-dir", str(tmp_path / "sofas"))]
                  + ["--output-dir", str(tmp_path / "none")])
    assert not (tmp_path / "none").exists()
