"""The benchmark's own CPU tests: the manifest and the files it finds by
name, the yardstick's counts against hand-worked shapes, the traffic
generator, and the import rules.

    python -m pytest portbench/tests -p no:cacheprovider
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import counts, manifest, traffic
from portbench.trace import DeviceTrace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "audiblelight_tpu"}


def test_manifest_names_its_files():
    man = manifest.load_manifest(ROOT)
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for c in man["configs"]:
        assert (ROOT / c["file"]).is_file() and manifest.load_config(c["name"])["name"] == c["name"]
    for w in man["workloads"]:
        assert manifest.load_config(w["config"]) and manifest.load_mix(w["traffic"])["name"] == w["traffic"]
    for m in man["per_layer"]:
        assert callable(manifest.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    assert [e["name"] for e in man["end_to_end"]] == ["audio_s_per_s", "setup_s"]


def test_every_cell_reports_setup_and_a_layer():
    man = manifest.load_manifest(ROOT)
    for w in man["workloads"]:
        assert {m["name"] for m in manifest.metrics_for(man, w["name"], "end_to_end")} >= {"setup_s", "audio_s_per_s"}
        assert manifest.metrics_for(man, w["name"], "per_layer")
        assert w["chips"] == 1


def test_a_mix_added_by_file_alone_is_listed_and_generated(tmp_path):
    shutil.copytree(BENCH / "configs", tmp_path / "configs")
    shutil.copytree(BENCH / "mixes", tmp_path / "mixes")
    dummy = dict(manifest.load_mix("dcase5"), name="dummy3", static=2, moving=1, ring=2)
    (tmp_path / "mixes" / "dummy3.json").write_text(json.dumps(dummy))
    assert "dummy3" in manifest.mixes(tmp_path) and "dummy3" not in manifest.mixes()
    ring = traffic.ring(manifest.load_config("shoebox_foa", tmp_path), manifest.load_mix("dummy3", tmp_path), 7)
    assert len(ring) == 2 and all(len(s["events"]) == 3 for s in ring)


# Configurations by name: the benchmark's, and its shoebox one in the mesh room
CONFIGS = {"shoebox_foa": lambda: manifest.load_config("shoebox_foa"),
           "scanned_room_0": lambda: dict(manifest.load_config("shoebox_foa"), room=dict(mesh="scanned_room_0"))}


@pytest.mark.parametrize("config,mix", [("shoebox_foa", "dcase5"), ("shoebox_foa", "dense16"),
                                        ("scanned_room_0", "dcase5")])
def test_traffic_is_fixed_by_the_seed_and_keeps_its_shapes(config, mix):
    cfg, mx = CONFIGS[config](), manifest.load_mix(mix)
    seed = 2**31 + 12345  # seeds past 32 bits, as the benchmark is given
    a, b = traffic.scene(cfg, mx, seed, 3), traffic.scene(cfg, mx, seed, 3)
    assert a == b and a != traffic.scene(cfg, mx, seed + 1, 3)
    assert a["room"] == cfg["room"] if "mesh" in cfg["room"] else len(a["room"]) == 3
    n_moving = sum(e["moving"] for e in a["events"])
    assert (len(a["events"]) - n_moving, n_moving) == (mx["static"], mx["moving"])
    # Onset order, and never more than max_overlap events sounding at once
    starts = [e["scene_start"] for e in a["events"]]
    assert starts == sorted(starts)
    for t in np.arange(0.0, cfg["duration_s"], 0.05):
        assert sum(e["scene_start"] <= t < e["scene_start"] + e["duration"] for e in a["events"]) <= cfg["max_overlap"]
    assert max(e["scene_start"] + e["duration"] for e in a["events"]) <= cfg["duration_s"]
    mic = np.asarray(a["mic"]["position"])
    for e in a["events"]:
        pts = np.atleast_2d(e["trajectory"] if e["moving"] else e["position"])
        assert np.all(np.linalg.norm(pts - mic, axis=1) >= mx["min_mic_distance_m"])
        if e["moving"]:  # the port's velocity range for a predefined trajectory
            assert 0.5 <= np.linalg.norm(pts[-1] - pts[0]) / e["duration"] <= 2.0


def test_counts_against_hand_worked_shapes():
    # One FOA row, 15 emitters, order 12 (25^3 = 15,625 offsets, 8 parities), 1 s at 24 kHz (12,001 bins)
    assert counts.ism_terms(1, 15, 24000, 12) == 1 * 15 * 8 * 15625 * 12001 == 22_501_875_000
    # PERF.md's MIC scene: 4 capsules x 6 emitters -> 3.6e10 terms, 16.12 ms at 67 TFLOP/s
    terms = counts.ism_terms(4, 6, 24000, 12)
    assert terms == 36_003_000_000
    assert abs(counts.bound_s(30 * terms, 0) - 0.016121) < 1e-5
    assert counts.bound_s(0, 3.35e12) == 1.0


def test_device_trace_union_and_breakdown():
    tr = DeviceTrace([("k1", 0, 10), ("Memcpy HtoD", 5, 22), ("k2", 30, 40), ("k1", 45, 50)])
    assert tr.busy_ns() == 22 + 10 + 5 and len(tr.kernels) == 3
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["Memcpy HtoD", 17e-9] and bd["idle_gaps"] == [["after Memcpy HtoD", 8e-9],
                                                                                 ["after k2", 5e-9]]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "audiblelight_tpu_torch" not in _imports(path), path


def test_a_run_loads_no_jax_and_the_reference_none_of_the_program():
    code = (
        "import sys; import portbench.run, portbench.check, portbench.control, portbench.reference.shoebox;"
        "from portbench import manifest;"
        "[manifest.reader(m['name']) for m in manifest.load_manifest('.')['per_layer']];"
        "import audiblelight_tpu_torch, audiblelight_tpu_torch.pipeline, audiblelight_tpu_torch.core;"
        "top = {m.split('.')[0] for m in sys.modules};"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'audiblelight_tpu'}))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    code = ("import sys; import portbench.reference.audio, portbench.reference.shoebox, portbench.traffic;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'audiblelight_tpu_torch', 'audiblelight_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    assert run.main(["--workload", "shoebox_foa.dcase5", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_the_run_refuses_in_a_folder_of_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "shoebox_foa.dcase5", "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
