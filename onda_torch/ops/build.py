"""Build the hand-written CUDA kernels of `onda_torch/csrc` at first use.

Each `.cu` source is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface (one `nvcc` per source, all started together)
under `build/onda_torch_kernels/` at the repository root, and loaded with
`ctypes`. A library is rebuilt when its source is newer. Nothing here runs at
import time, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "onda_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _stale(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    return not lib.exists() or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def build_all(names=None, verbose: bool = False) -> float:
    """Compile every stale kernel source in parallel; returns the seconds spent.

    `verbose` adds `-Xptxas -v` and prints the compiler's report (registers,
    shared memory, spills)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(f"[nvcc {name}]\n{out}")
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, BUILD_DIR / f"lib{name}.so")
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
    return _loaded[name]
