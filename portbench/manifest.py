"""The benchmark's manifest and the files it names, found by name.

`BENCHMARK.json` (at the root of the checkout) lists the cells; each names
a configuration (`configs/<config>.json`) and a traffic mix
(`mixes/<mix>.json`), and each per-layer metric has its reader
(`metrics/<metric>.py`, a `read(run)` function). Adding a configuration,
a mix, a cell or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load_manifest(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def load_config(name: str, base: Path = HERE) -> dict:
    with open(Path(base) / "configs" / f"{name}.json") as f:
        return json.load(f)


def load_mix(name: str, base: Path = HERE) -> dict:
    with open(Path(base) / "mixes" / f"{name}.json") as f:
        return json.load(f)


def load_mesh(name: str, base: Path = HERE) -> tuple:
    """(vertices (V, 3) float64, faces (F, 3) int32) of `meshes/<name>.npz`."""
    with np.load(Path(base) / "meshes" / f"{name}.npz") as f:
        return f["vertices"].astype(np.float64), f["faces"].astype(np.int32)


def mixes(base: Path = HERE) -> list:
    """The names of every mix on disk."""
    return sorted(p.stem for p in (Path(base) / "mixes").glob("*.json"))


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(manifest: dict, workload: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metric entries this cell reports."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The `read(run)` function of a per-layer metric."""
    return importlib.import_module(f"portbench.metrics.{name}").read
