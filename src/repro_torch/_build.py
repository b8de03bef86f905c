"""Builds the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into a shared library loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds, not minutes).  Libraries are keyed by a
hash of the sources and flags and land in ``build/repro_torch/`` at the
repository root, which ``.gitignore`` lists; a source edit therefore
rebuilds, and an unchanged one loads what is there.  Nothing is built when
a module is imported: the CPU never needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
SOURCES = ("decode_attention", "dwsep_conv1d", "ssd", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for these sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together.  Returns the seconds each build took
    (sources already built are absent).  The compiler's output, with
    ``-Xptxas -v``'s registers and spills, is kept in ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log_path = out.with_suffix(".log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        running.append((name, proc, tmp, out, log_path, time.perf_counter()))
    seconds: Dict[str, float] = {}
    failed = []
    for name, proc, tmp, out, log_path, t0 in running:
        if proc.wait() != 0:
            failed.append(f"{name} (log: {log_path})")
            continue
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
