"""The two min-mapping sweep kernels: wrappers, plain versions, counters.

The port's counterpart of ``repro.kernels.contour_mm.blocked``.  Both
kernels are hand-written CUDA for Hopper in ``csrc/contour_mm.cu`` (see
its header for what bounds them and how the design answers it):

* :func:`fused_relax` — one synchronous order-2 sweep straight off the
  edge list (replaces ``fused_relax_pallas``).  It carries every order-2
  sweep of the main path, at any ``n``: the TPU kernel's single-VMEM-tile
  limit has no counterpart here.
* :func:`scatter_min` — ``L.at[targets].min(values)`` over an update
  stream (replaces ``binned_scatter_min_pallas``); the order-1 and
  order-h sweeps go through it.

Each wrapper runs its kernel on a CUDA tensor, or raises; its plain torch
version (``*_plain``) runs only when the tensors lie on the CPU.  The
wrapper allocates the output (a copy of ``L``), launches on the current
stream, raises if the launch reports an error, and adds one to its
``launches`` count for every kernel launch.

Ids outside ``[0, n)`` (``n = len(L)``) raise ``IndexError`` on both
devices: the plain versions check before they gather, and the kernels
check every id before they follow it, skip it, and set an error word
that the wrapper reads after the launch.  That read waits for the kernel,
so the main path, whose ids are in range by construction (``Graph``
checks its endpoints, and every sweep keeps labels in ``[0, n)``),
passes ``check=False``: the kernel still never touches memory outside
``L``, and the host is not held up.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "contour_mm.cu",)
LIBRARY = "contour_mm"

_P = ctypes.c_void_p

_FUSED_IDS = "fused_relax: an edge endpoint or a label at one"
_SCATTER_IDS = "scatter_min: an update target"


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load ``libcontour_mm``; declare its API."""
    lib = _build.load_library(LIBRARY, SOURCES)
    i64 = ctypes.c_int64
    lib.contour_fused_relax.argtypes = [_P, _P, _P, _P, i64, i64, _P, _P]
    lib.contour_fused_relax.restype = ctypes.c_int
    lib.contour_scatter_min.argtypes = [_P, _P, _P, _P, _P, i64, i64, _P, _P]
    lib.contour_scatter_min.restype = ctypes.c_int
    return lib


def check_int32(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.int32 or t.dim() != 1:
        raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                        f"{t.dtype} of shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, L on {device}")


def on_cuda(L: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if L.device.type == "cuda":
        return True
    if L.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {L.device}")


def _check_ids(what: str, ids: torch.Tensor, n: int) -> None:
    """Raise IndexError if any id lies outside ``[0, n)``."""
    if ids.numel() and bool(((ids < 0) | (ids >= n)).any()):
        raise IndexError(f"{what} outside [0, {n})")


def launch(fn, *args, wrapper, check: bool, what: str,
           L: torch.Tensor) -> None:
    """Launch ``fn`` on the current stream and count it on ``wrapper``;
    with ``check``, wait for it and raise IndexError if the kernel met an
    id outside ``[0, len(L))``."""
    n = int(L.shape[0])
    err = torch.zeros(1, dtype=torch.int32, device=L.device) if check else None
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        rc = fn(*args, n, None if err is None else err.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    wrapper.launches += 1
    if err is not None and int(err.item()):
        raise IndexError(f"{what} outside [0, {n})")


def edge_count(m: int, edge_limit) -> int:
    if edge_limit is None:
        return m
    return max(0, min(m, int(edge_limit)))


# ---------------------------------------------------------------------------
# fused_relax (K1)
# ---------------------------------------------------------------------------


def fused_relax_plain(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                      edge_limit=None) -> torch.Tensor:
    """Plain torch version of :func:`fused_relax` (the same function)."""
    n = int(L.shape[0])
    m = edge_count(int(src.shape[0]), edge_limit)
    src, dst = src[:m], dst[:m]
    _check_ids(_FUSED_IDS, torch.cat([src, dst]), n)
    ls, ld = L[src], L[dst]
    _check_ids(_FUSED_IDS, torch.cat([ls, ld]), n)
    z = torch.minimum(L[ls], L[ld])
    idx = torch.cat([src, dst, ls, ld]).long()
    return L.scatter_reduce(0, idx, z.repeat(4), "amin", include_self=True)


def fused_relax(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                edge_limit=None, *, check: bool = True) -> torch.Tensor:
    """One synchronous order-2 min-mapping sweep; returns new labels.

    Equals ``minmap.mm_relax(L, src, dst, 2)`` bit for bit.  Edges at
    positions ``>= edge_limit`` (a Python int or 0-d tensor) take no part.
    The TPU kernel masked them to ``(0, 0)`` self-loops instead; under the
    ``L[v] <= v`` labelling invariant (so ``L[0] == 0``) such a self-loop
    is a no-op, and the two agree.  An endpoint, or a label at one,
    outside ``[0, len(L))`` raises IndexError; on the card,
    ``check=False`` skips such an edge instead and does not wait for the
    kernel.
    """
    check_int32("L", L, L.device)
    check_int32("src", src, L.device)
    check_int32("dst", dst, L.device)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {tuple(src.shape)} vs "
                         f"{tuple(dst.shape)}")
    if not on_cuda(L):
        return fused_relax_plain(L, src, dst, edge_limit)
    L, src, dst = L.contiguous(), src.contiguous(), dst.contiguous()
    m = edge_count(int(src.shape[0]), edge_limit)
    out = L.clone()
    if m > 0:
        lib = load_library()
        launch(lib.contour_fused_relax, L.data_ptr(), out.data_ptr(),
               src.data_ptr(), dst.data_ptr(), m, wrapper=fused_relax,
               check=check, what=_FUSED_IDS, L=L)
    return out


fused_relax.launches = 0


# ---------------------------------------------------------------------------
# scatter_min (K2)
# ---------------------------------------------------------------------------


def scatter_min_plain(L: torch.Tensor, targets: torch.Tensor,
                      values: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of :func:`scatter_min` (the same function)."""
    if valid is not None:
        targets, values = targets[valid], values[valid]
    _check_ids(_SCATTER_IDS, targets, int(L.shape[0]))
    return L.scatter_reduce(0, targets.long(), values, "amin",
                            include_self=True)


def scatter_min(L: torch.Tensor, targets: torch.Tensor, values: torch.Tensor,
                valid: Optional[torch.Tensor] = None, *,
                check: bool = True) -> torch.Tensor:
    """``L.at[targets].min(values)``, skipping updates where ``valid`` is
    False; returns new labels (``L`` is not modified).  A live target
    outside ``[0, len(L))`` raises IndexError; on the card,
    ``check=False`` skips such an update instead and does not wait for
    the kernel."""
    check_int32("L", L, L.device)
    check_int32("targets", targets, L.device)
    check_int32("values", values, L.device)
    if targets.shape != values.shape:
        raise ValueError(f"targets/values shape mismatch: "
                         f"{tuple(targets.shape)} vs {tuple(values.shape)}")
    if valid is not None:
        if valid.dtype != torch.bool or valid.shape != targets.shape:
            raise TypeError(f"valid must be bool of shape "
                            f"{tuple(targets.shape)}, got {valid.dtype} "
                            f"{tuple(valid.shape)}")
        if valid.device != L.device:
            raise ValueError(f"valid is on {valid.device}, L on {L.device}")
    if not on_cuda(L):
        return scatter_min_plain(L, targets, values, valid)
    L, targets, values = L.contiguous(), targets.contiguous(), \
        values.contiguous()
    if valid is not None:
        valid = valid.contiguous()
    k = int(targets.shape[0])
    out = L.clone()
    if k > 0:
        lib = load_library()
        launch(lib.contour_scatter_min, L.data_ptr(), out.data_ptr(),
               targets.data_ptr(), values.data_ptr(),
               None if valid is None else valid.data_ptr(), k,
               wrapper=scatter_min, check=check, what=_SCATTER_IDS, L=L)
    return out


scatter_min.launches = 0

