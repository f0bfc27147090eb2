"""The fused RMSNorm row kernel: wrapper, plain version, counter.

The port's counterpart of ``repro.kernels.fused_rmsnorm.kernel``.
:func:`rmsnorm_rows` is a hand-written CUDA kernel for Hopper in
``csrc/rmsnorm.cu`` (replaces ``rmsnorm_rows``; see its header for what
bounds it and how the design answers it).  It takes any row count: the
TPU kernel's ``block_rows`` and the padding it needed have no
counterpart.

On a CUDA tensor :func:`rmsnorm_rows` runs the kernel or raises; its plain
version :func:`rmsnorm_rows_plain` (``ref.rmsnorm_ref``) runs only when
the tensors lie on the CPU.  The wrapper allocates the output, launches
on the current stream, raises if the launch reports an error, and adds
one to ``rmsnorm_rows.launches`` for every launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPES, check_dtype, on_cuda,
                                         raise_on_error)
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "rmsnorm.cu",)
LIBRARY = "fused_rmsnorm"


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load ``libfused_rmsnorm``; declare its
    API."""
    lib = _build.load_library(LIBRARY, SOURCES)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.fused_rmsnorm_rows.argtypes = [p, p, p, i64, i64, ctypes.c_float,
                                       ctypes.c_int, p]
    lib.fused_rmsnorm_rows.restype = ctypes.c_int
    lib.fused_rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.fused_rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_rows_plain(x: torch.Tensor, w: torch.Tensor, *,
                       eps: float = 1e-5) -> torch.Tensor:
    """Plain torch version of :func:`rmsnorm_rows` (the same function)."""
    return rmsnorm_ref(x, w, eps)


def rmsnorm_rows(x: torch.Tensor, w: torch.Tensor, *,
                 eps: float = 1e-5) -> torch.Tensor:
    """x: (R, d) float32, bfloat16 or float16, contiguous; w: (d,) of any
    float type.  Returns ``x · rsqrt(mean(x²) + eps) · w`` per row, in x's
    dtype."""
    check_dtype("x", x)
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, d), got {tuple(x.shape)}")
    if not w.is_floating_point():
        raise TypeError(f"w must be a float tensor, got {w.dtype}")
    if tuple(w.shape) != (x.shape[1],):
        raise ValueError(f"w must have shape ({x.shape[1]},), got "
                         f"{tuple(w.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not on_cuda(x, w):
        return rmsnorm_rows_plain(x, w, eps=eps)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # the kernel reads w as float32, as the reference casts it
    wf = w.to(torch.float32).contiguous()
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.fused_rmsnorm_rows(
            x.data_ptr(), wf.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], float(eps), DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(rc, "rmsnorm_rows", lib.fused_rmsnorm_error_string)
    rmsnorm_rows.launches += 1
    return out


rmsnorm_rows.launches = 0
