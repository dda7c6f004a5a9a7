"""Build the CUDA kernels with ``nvcc`` at first use and load them with ``ctypes``.

Each source under ``csrc/`` becomes its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), compiled for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

into ``build/torch_kernels/`` at the repository root. A library's file name carries a
hash of its source and flags, so an edited source is rebuilt and a stale one is never
loaded. ``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("confusion_matrix", "binned_curve_counts", "weighted_bincount", "bincount", "ssim_moments")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc was not found: the CUDA kernels are built on a host with the CUDA toolkit")
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source into a temporary file; None if already built."""
    target = _library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, target, t0 = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log, "returncode": proc.returncode}
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every named source that is not built yet, one ``nvcc`` each, in parallel."""
    started = {name: _start(name) for name in names}
    errors = []
    for name, job in started.items():
        if job is None:
            continue
        try:
            _finish(name, job)
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        lib.tm_error_string.argtypes = [ctypes.c_int]
        lib.tm_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib
