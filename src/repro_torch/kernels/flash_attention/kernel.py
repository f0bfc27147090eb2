"""The GQA flash-attention kernel: wrapper, plain version, counter.

The port's counterpart of ``repro.kernels.flash_attention.kernel``.
:func:`flash_mha` is a hand-written CUDA kernel for Hopper in
``csrc/flash_attention.cu`` (replaces ``flash_mha``; see its header for
what bounds it and how the design answers it).  The kernel masks keys at
or past ``S`` itself, so ``T`` and ``S`` need not be multiples of any
block, and the TPU kernel's ``block_q``/``block_k`` have no counterpart.

On a CUDA tensor :func:`flash_mha` runs the kernel or raises; its plain
version :func:`flash_mha_plain` (``ref.mha_ref``) runs only when the
tensors lie on the CPU.  The wrapper allocates the output, launches on
the current stream with the shared memory the kernel needs, raises if
the launch reports an error (a launch refused for too much shared memory
included), and adds one to ``flash_mha.launches`` for every launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPES, check_dtype, on_cuda,
                                         raise_on_error)
from repro_torch.kernels.flash_attention.ref import mha_ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "flash_attention.cu",)
LIBRARY = "flash_attention"

# head dims the kernel takes: multiples of 8 in [8, 256]
HEAD_DIM_STEP = 8
MAX_HEAD_DIM = 256
# the kernel's loads and stores are 16-byte vectors
VECTOR_BYTES = 16


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load ``libflash_attention``; declare its
    API."""
    lib = _build.load_library(LIBRARY, SOURCES)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i64, i64, i64, i64, i64,
                                        i64, ctypes.c_int, ctypes.c_int, i64,
                                        p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [i64]
    lib.flash_attention_smem_bytes.restype = i64
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise TypeError/ValueError for inputs the kernel does not take."""
    check_dtype("q", q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be (B, H, T, hd) and k, v (B, Hkv, S, hd)")
    b, h, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k and v must be ({b}, Hkv, S, {hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    hkv = k.shape[1]
    if hkv < 1 or h % hkv:
        raise ValueError(f"H = {h} must be a multiple of Hkv = {hkv}")
    if hd % HEAD_DIM_STEP or not HEAD_DIM_STEP <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} must be a multiple of "
                         f"{HEAD_DIM_STEP} in [{HEAD_DIM_STEP}, "
                         f"{MAX_HEAD_DIM}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_aligned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError unless q, k and v start on a 16-byte boundary, as
    the kernel's vector loads need (a contiguous view at an odd offset into
    a larger buffer does not)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % VECTOR_BYTES:
            raise ValueError(f"{name} must start on a {VECTOR_BYTES}-byte "
                             f"boundary (data_ptr {t.data_ptr():#x})")


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Plain torch version of :func:`flash_mha` (the same function)."""
    return mha_ref(q, k, v, causal=causal)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, smem_limit: int) -> None:
    """Launch the kernel into ``out`` with its dynamic shared memory limit
    set to ``smem_limit`` bytes; raise if the launch reports an error."""
    lib = load_library()
    b, h, t, hd = q.shape
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], t, k.shape[2], hd, int(causal), DTYPES[q.dtype],
            smem_limit, torch.cuda.current_stream().cuda_stream)
    raise_on_error(rc, "flash_mha", lib.flash_attention_error_string)
    flash_mha.launches += 1


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, H, T, hd); k/v: (B, Hkv, S, hd) with Hkv | H, all float32
    or all bfloat16, contiguous (and 16-byte aligned on the card).
    -> (B, H, T, hd) in q's dtype."""
    check_inputs(q, k, v)
    if not on_cuda(q, k, v):
        return flash_mha_plain(q, k, v, causal=causal)
    check_aligned(q, k, v)
    out = torch.empty_like(q)
    if out.numel():
        smem = load_library().flash_attention_smem_bytes(q.shape[3])
        launch(q, k, v, out, causal, smem)
    return out


flash_mha.launches = 0
