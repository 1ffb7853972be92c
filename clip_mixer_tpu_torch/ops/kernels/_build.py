"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under ``build/kernels/`` at
the repository root, and loaded with ``ctypes``. A library newer than its
source and than the shared headers ``csrc/*.cuh`` is reused. Every C entry
returns ``cudaGetLastError()`` after its launch; :func:`check` turns a
non-zero code into an exception.

Nothing here runs at import time: the CPU tests import every module of the
port on hosts with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build in this process
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(candidate):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return candidate


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _fresh(name: str) -> bool:
    """The library is newer than its source and than every shared header
    in ``csrc/`` (a source may include any of them)."""
    lib = _lib_path(name)
    if not lib.exists():
        return False
    sources = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    return lib.stat().st_mtime >= max(p.stat().st_mtime for p in sources)


def build(names: Iterable[str]) -> None:
    """Compile the named sources that are missing or stale, one ``nvcc``
    process per source, all started together. The library is written under
    a temporary name and renamed, so a concurrent loader never sees half a
    file."""
    with _lock:
        stale = [n for n in names if not _fresh(n)]
        if not stale:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        jobs = []
        for n in stale:
            tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((n, tmp, proc))
        errors = []
        for n, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on csrc/{n}.cu:\n{out}")
                continue
            build_logs[n] = out
            os.replace(tmp, _lib_path(n))
        if errors:
            raise RuntimeError("\n".join(errors))


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
