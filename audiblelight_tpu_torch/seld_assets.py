"""Room tables of SELD dataset generation (the DCASE2023-Task3 layout).

The port's copy of the reference script's asset module (scripts/seld/), with
the same tables and draws: `MESHES`, train/test Gibson room lists keyed by
split ("9", "9A"-"9D", "12", "18", "36", "72", "144"), each with its scapes
per room totalling 1,200 scenes; `SOFAS`, the TAU-SRIR rooms of the measured
variant; `room_seed` and `synthetic_room`, a deterministic stand-in room
seeded by the room's name (built with the port's `box_mesh`), which
`resolve_room` returns where the room's `.glb` is not under the mesh folder;
`get_assets` and `sanity_check`. The SELD CLI's `--assets` iterates these
tables (`seld.asset_jobs`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

# ---------------------------------------------------------------------------
# Canonical room orderings (Gibson environment names, public dataset facts).
# Split "N" takes the first train_count(N) / test_count(N) entries of each.
# ---------------------------------------------------------------------------

GIBSON_TRAIN_ROOMS = [
    "Haymarket", "Swisshome", "Siren", "Traver", "Hercules", "Halfway",
    "Eagan", "Baneberry", "Quantico", "Superior", "Hambleton", "Tyler",
    "Glenmoor", "Hallettsville", "Voorhees", "Pocopson", "Almena", "Fleming",
    "Frontenac", "Andover", "Westerville", "Tolstoy", "Hordville", "Holcut",
    "Ballantine", "Howie", "Kremlin", "Sultan", "Everton", "Markleeville",
    "Pettigrew", "Ogilvie", "Sagerton", "Carpio", "Irvine", "Woonsocket",
    "Woodbine", "Tokeland", "Grainola", "Peden", "Mazomanie", "Harkeyville",
    "Bonnie", "Fedora", "Spread", "Oyens", "Angiola", "Orangeburg",
    "Hennepin", "Broseley", "Mullica", "Bolton", "Bettendorf", "Kirksville",
    "Corder", "Adrian", "Mifflintown", "Mosinee", "Beach", "Stilwell",
    "Readsboro", "Seatonville", "Crandon", "Noonday", "Wilkinsburg", "Branford",
    "Mahtomedi", "Kopperl", "Clive", "Kendall", "Frankton", "Cooperstown",
    "Mifflinburg", "Carpendale", "Rutherford", "Neibert", "Micanopy", "Model",
    "Inkom", "Merom", "Lindsborg", "Galatia", "Arbutus", "Calmar",
    "Kobuk", "Lacon", "Martinville", "Corozal", "Ruckersville", "McKeesport",
    "Shauck", "Touhy", "Mashulaville", "Cornville", "Coronado", "Tomkins",
]

GIBSON_TEST_ROOMS = [
    "Helix", "Peacock", "Vails", "Assinippi", "Maiden", "Grangeville",
    "Anaheim", "Tansboro", "Funkstown", "Portola", "Emmaus", "Edgemere",
    "Silva", "Kingdom", "Goodfield", "Bonesteel", "Crugers", "Macedon",
    "Collierville", "Yankeetown", "Cisne", "Fonda", "Trail", "Ophir",
    "Mesic", "Seward", "Seiling", "Haaswood", "Annona", "Bohemia",
    "Judith", "Munsons", "Wyldwood", "Wainscott", "Elmira", "Whitethorn",
    "Barranquitas", "Hindsboro", "Sugarville", "Gratz", "Circleville", "Monson",
    "Mogadore", "Kettle", "Roane", "Bethlehem", "Hartline", "Maida",
]

# TAU-SRIR rooms (measured-RIR variant; reference SOFAS table).
TAU_SRIR_TRAIN_ROOMS = ["pb132", "pc226", "sa203", "sc203", "se203", "tb103"]
TAU_SRIR_TEST_ROOMS = ["tc352", "bomb_shelter", "gym"]

TOTAL_SCAPES = 1200

# split -> (n_train_rooms, n_test_rooms, scapes_per_train_room, scapes_per_test_room)
_SPLIT_SIZES = {
    "9": (6, 3, 150, 100),
    "12": (8, 4, 120, 60),
    "18": (12, 6, 75, 50),
    "36": (24, 12, 40, 20),
    "72": (48, 24, 20, 10),
    "144": (96, 48, 10, 5),
}


def _glb(names: list[str]) -> list[str]:
    return [f"{n}.glb" for n in names]


def _split(n_train, n_test, per_train, per_test, train=None, test=None) -> dict:
    return {
        "train": _glb(train if train is not None else GIBSON_TRAIN_ROOMS[:n_train]),
        "test": _glb(test if test is not None else GIBSON_TEST_ROOMS[:n_test]),
        "scapes_per_train_mesh": per_train,
        "scapes_per_test_mesh": per_test,
    }


MESHES = {name: _split(*sizes) for name, sizes in _SPLIT_SIZES.items()}
# Alternate disjoint 9-room folds (for cross-validation over rooms): the "A"
# fold is the canonical 9, "B"/"C"/"D" step through the next ordered rooms.
MESHES["9A"] = _split(6, 3, 150, 100)
MESHES["9B"] = _split(
    6, 3, 150, 100,
    train=GIBSON_TRAIN_ROOMS[6:12], test=GIBSON_TEST_ROOMS[3:6],
)
MESHES["9C"] = _split(
    6, 3, 150, 100,
    train=GIBSON_TRAIN_ROOMS[12:18], test=GIBSON_TEST_ROOMS[6:9],
)
MESHES["9D"] = _split(
    6, 3, 150, 100,
    train=GIBSON_TRAIN_ROOMS[18:24],
    test=[GIBSON_TEST_ROOMS[10], GIBSON_TEST_ROOMS[22], GIBSON_TEST_ROOMS[23]],
)

SOFAS = {
    "9A": {
        "train": list(TAU_SRIR_TRAIN_ROOMS),
        "test": list(TAU_SRIR_TEST_ROOMS),
        "scapes_per_train_mesh": 150,
        "scapes_per_test_mesh": 100,
    }
}


# ---------------------------------------------------------------------------
# Room resolution: real Gibson mesh when present, procedural stand-in when not
# ---------------------------------------------------------------------------


def room_seed(room_name: str) -> int:
    """Deterministic per-room seed (stable across runs/processes/machines)."""
    import hashlib

    stem = Path(room_name).stem
    return int.from_bytes(hashlib.sha256(stem.encode()).digest()[:4], "big")


def synthetic_room(room_name: str):
    """A deterministic procedural stand-in room for a missing Gibson mesh.

    Seeded by the room name: an outer shoebox shell (5-12 m x 4-9 m x 2.6-3.4 m)
    with 1-3 interior boxes (partition walls / furniture masses), so the room is
    nonconvex and exercises real occlusion like a scanned interior would.

    Returns a geometry.TriMesh whose metadata records the stand-in status.
    """
    import numpy as np

    from audiblelight_tpu_torch.geometry.mesh import TriMesh, box_mesh

    rng = np.random.default_rng(room_seed(room_name))
    dims = rng.uniform([5.0, 4.0, 2.6], [12.0, 9.0, 3.4])
    shell = box_mesh(extents=dims, center=dims / 2)
    parts = [shell]
    for _ in range(int(rng.integers(1, 4))):
        if rng.uniform() < 0.5:
            # Partial partition wall: full height, anchored to one wall
            length = rng.uniform(0.3, 0.6) * dims[1]
            ext = np.array([rng.uniform(0.1, 0.25), length, dims[2] * 0.98])
            center = np.array(
                [rng.uniform(0.25, 0.75) * dims[0], length / 2, dims[2] / 2]
            )
        else:
            # Furniture mass on the floor
            ext = rng.uniform([0.4, 0.4, 0.4], [1.5, 2.0, 1.2])
            center = np.array(
                [
                    rng.uniform(0.15, 0.85) * dims[0],
                    rng.uniform(0.15, 0.85) * dims[1],
                    ext[2] / 2,
                ]
            )
        parts.append(box_mesh(extents=ext, center=center, inward_normals=False))

    vertices = np.concatenate([p.vertices for p in parts])
    faces_list, offset = [], 0
    for p in parts:
        faces_list.append(p.faces + offset)
        offset += len(p.vertices)
    stem = Path(room_name).stem
    return TriMesh(
        vertices=vertices,
        faces=np.concatenate(faces_list),
        metadata=dict(fname=stem, fpath=f"synthetic://{stem}", synthetic_stand_in=True),
    )


_ROOM_CACHE: dict = {}


def resolve_room(room_name: str, mesh_dir: Union[str, Path, None]):
    """Resolve a room table entry to a renderable mesh.

    Returns the real `.glb` Path when it exists under `mesh_dir`, otherwise the
    deterministic synthetic stand-in room (see synthetic_room). Stand-ins are
    cached per name so consecutive scapes in one room share the TriMesh object
    (and with it the room's device state and fused renderers).
    """
    if mesh_dir is not None:
        candidate = Path(mesh_dir) / room_name
        if candidate.is_file():
            return candidate
    if room_name not in _ROOM_CACHE:
        _ROOM_CACHE[room_name] = synthetic_room(room_name)
    return _ROOM_CACHE[room_name]


def get_assets(backend: str, asset_split: str) -> dict:
    """The train/test room table of this backend and split."""
    table = SOFAS if backend == "sofa" else MESHES
    if str(asset_split) not in table:
        raise ValueError(
            f"Expected assets in {list(table.keys())} but got {asset_split}"
        )
    return table[str(asset_split)]


def sanity_check() -> None:
    """The reference __main__'s invariants, as an importable function."""
    for k, v in MESHES.items():
        n_rooms = len(v["train"]) + len(v["test"])
        assert n_rooms == int("".join(c for c in k if c.isdigit())), k
        total = (
            len(v["train"]) * v["scapes_per_train_mesh"]
            + len(v["test"]) * v["scapes_per_test_mesh"]
        )
        assert total == TOTAL_SCAPES, (k, total)
        assert len(set(v["train"] + v["test"])) == n_rooms, f"duplicates in {k}"
    # Prefix/superset property along the main chain
    chain = ["9", "12", "18", "36", "72", "144"]
    for a, b in zip(chain, chain[1:]):
        for part in ("train", "test"):
            assert MESHES[b][part][: len(MESHES[a][part])] == MESHES[a][part], (a, b)
    # Alternate folds are room-disjoint from each other and from the canonical 9
    alt_rooms = [set(MESHES[k]["train"] + MESHES[k]["test"]) for k in ("9", "9B", "9C", "9D")]
    for i, a in enumerate(alt_rooms):
        for b in alt_rooms[i + 1 :]:
            assert not (a & b), "alternate folds overlap"
    for k, v in SOFAS.items():
        total = (
            len(v["train"]) * v["scapes_per_train_mesh"]
            + len(v["test"]) * v["scapes_per_test_mesh"]
        )
        assert total == TOTAL_SCAPES, (k, total)
