"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each kernel family keeps its ``.cu`` sources under a ``csrc/`` directory
with a plain ``extern "C"`` interface (no PyTorch headers, so ``nvcc``
takes seconds).  :func:`load_library` compiles them for Hopper
(``sm_90a``) into one shared library the first time it is asked for,
under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the sources and flags, and loads it.
Nothing is built when a module is imported: the CPU tests import every
module on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# src/repro_torch/kernels/_build.py -> the checkout's root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_LOCK = threading.Lock()
# one lock per library, so that two libraries build at the same time
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (ptxas register / spill report) of the last build
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found; the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where the library for these sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources):
        h.update(Path(src).name.encode())
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` unless it exists."""
    out = library_path(name, sources)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{BUILD_LOGS[name]}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build (once) and load the library; cached for the process.

    Calls for different libraries may run in parallel threads: each
    library has its own lock, and ``nvcc`` runs outside the GIL.
    """
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _LOADED[name] = lib
        return lib
