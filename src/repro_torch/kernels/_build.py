"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on its
own by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``build/repro_torch/lib<name>.so`` at the repository root (all
sources start together, one ``nvcc`` each), then loaded with ``ctypes``.  A
library is rebuilt when its source is newer.  Nothing here includes
PyTorch's headers, so a build takes seconds.

This module is imported lazily, from the kernel wrappers' CUDA branches and
from ``chip_smoke.py``: the CPU tests never reach it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME): the "
                           "repro_torch kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_all(verbose: bool = False) -> float:
    """Compile every stale ``csrc/*.cu`` in parallel; returns the seconds
    taken.  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src.stem)
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
            continue
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
               str(src)]
        procs.append((src.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} ---\n{log}")
        elif verbose:
            print(f"--- {name} ---\n{log}", flush=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        if not (CSRC / f"{name}.cu").exists():
            raise FileNotFoundError(f"no kernel source csrc/{name}.cu")
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
