"""The in-order asynchronous 2-order sweep kernel: wrapper, plain version.

The port's counterpart of ``repro.kernels.contour_mm.kernel``.
:func:`mm2` is a hand-written CUDA kernel for Hopper in ``csrc/mm2.cu``
(replaces ``mm2_pallas``; see its header for what bounds it and how the
design answers it).  It sweeps the edges in order and updates the labels
in place, so each edge sees the labels that earlier edges lowered: the
result depends on the edge order and equals ``ref.mm_block_ref`` bit for
bit.

On a CUDA tensor :func:`mm2` runs the kernel or raises; its plain version
:func:`mm2_plain` (a Python loop over the edges) runs only when the
tensors lie on the CPU.  The wrapper copies ``L``, launches on the
current stream with the copy updated in place, and adds one to
``mm2.launches`` for every launch.  Ids outside ``[0, n)`` raise
``IndexError`` on both devices, as for the kernels of ``blocked.py``.

The TPU kernel kept all of ``L`` in VMEM, which capped ``n`` at 3,145,728
at a 16 MiB budget (``ops.py:193-202`` of the reference).  The CUDA kernel
reads ``L`` from device memory and has no such ceiling.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.contour_mm.blocked import (check_int32, edge_count,
                                                    launch, on_cuda)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "mm2.cu",)
LIBRARY = "contour_mm2"

_IDS = "mm2: an edge endpoint or a label at one"


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load ``libcontour_mm2``; declare its API."""
    lib = _build.load_library(LIBRARY, SOURCES)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.contour_mm2.argtypes = [p, p, p, i64, i64, p, p]
    lib.contour_mm2.restype = ctypes.c_int
    return lib


def mm2_plain(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              edge_limit=None) -> torch.Tensor:
    """Plain version of :func:`mm2`: ``mm_block_ref`` over the first
    ``edge_limit`` edges, raising IndexError where the kernel would meet
    an id outside ``[0, n)``."""
    n = int(L.shape[0])
    m = edge_count(int(src.shape[0]), edge_limit)
    lab = L.tolist()
    for w, v in zip(src[:m].tolist(), dst[:m].tolist()):
        if not (0 <= w < n and 0 <= v < n):
            raise IndexError(f"{_IDS} outside [0, {n})")
        lw = lab[w]
        lv = lab[v]
        if not (0 <= lw < n and 0 <= lv < n):
            raise IndexError(f"{_IDS} outside [0, {n})")
        z = min(lab[lw], lab[lv])
        for t in (w, v, lw, lv):
            if z < lab[t]:
                lab[t] = z
    return torch.tensor(lab, dtype=L.dtype, device=L.device)


def mm2(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
        edge_limit=None, *, check: bool = True) -> torch.Tensor:
    """One asynchronous order-2 sweep in edge order; returns new labels.

    Edges at positions ``>= edge_limit`` (a Python int or 0-d tensor)
    are not visited.  The TPU kernel masked them to ``(0, 0)`` self-loops
    instead; under the ``L[v] <= v`` labelling invariant (so
    ``L[0] == 0``) such a self-loop is a no-op, and the two agree.  An
    endpoint, or a label at one, outside ``[0, len(L))`` raises
    IndexError; on the card, ``check=False`` skips such an edge instead
    and does not wait for the kernel.  ``L`` is not modified.
    """
    check_int32("L", L, L.device)
    check_int32("src", src, L.device)
    check_int32("dst", dst, L.device)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {tuple(src.shape)} vs "
                         f"{tuple(dst.shape)}")
    if not on_cuda(L):
        return mm2_plain(L, src, dst, edge_limit)
    src, dst = src.contiguous(), dst.contiguous()
    m = edge_count(int(src.shape[0]), edge_limit)
    out = L.clone(memory_format=torch.contiguous_format)
    if m > 0:
        lib = load_library()
        launch(lib.contour_mm2, out.data_ptr(), src.data_ptr(),
               dst.data_ptr(), m, wrapper=mm2, check=check, what=_IDS,
               L=out)
    return out


mm2.launches = 0
