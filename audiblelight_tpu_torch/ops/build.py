"""Build the CUDA kernels in `csrc/` with nvcc and load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), at first use, into
`audiblelight_tpu_torch/_build/<hash>/`, keyed by a hash of the source, the
shared headers (`csrc/*.cuh`) and the flags. `build_all` starts one nvcc per
source at once and waits for all of them. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCES = {
    "first_hit": "first_hit.cu",
    "any_hit": "any_hit.cu",
    "deposit_histogram": "deposit_histogram.cu",
    "deposit_histogram_foa": "deposit_histogram_foa.cu",
    "bin_histogram": "bin_histogram.cu",
    "star_any_hit": "star_any_hit.cu",
    "tiled_first_hit": "tiled_first_hit.cu",
    "mxu_first_hit": "mxu_first_hit.cu",
    "sorted_first_hit": "sorted_first_hit.cu",
    "pair_first_hit": "pair_first_hit.cu",
    "shoebox_ism": "shoebox_ism.cu",
}
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# --fmad=false: the Pallas kernels and eager PyTorch never contract a product
# into a fused multiply-add; the kernels must not either, or t and the
# arrival bins move by an ULP and near-ties flip.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
]

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin/nvcc, else the one on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / digest / f"lib{name}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every named kernel that is not built yet, all nvcc runs at
    once. Returns {name: ptxas report} (registers, spills) for every name;
    raises with nvcc's output if any build fails."""
    names = list(SOURCES if names is None else names)
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"lib{name}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        lib.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _lib_path(name).with_suffix(".ptxas.txt").read_text() for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = _LOADED[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
