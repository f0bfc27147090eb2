"""The GQA flash-attention kernel: wrapper, plain version, counter, and a
CPU replay of the 16-bit kernel's arithmetic.

The port's counterpart of ``repro.kernels.flash_attention.kernel``.
:func:`flash_mha` runs one of two hand-written CUDA kernels for Hopper in
``csrc/flash_attention.cu`` (they replace ``flash_mha``; see its header
for what bounds them and how the designs answer it), chosen by dtype:

* bfloat16 and float16: ``flash_wgmma_kernel``, a producer warpgroup
  feeding Q, K and V tiles through TMA into a ring of shared-memory stages
  and two consumer warpgroups running both products on ``wgmma``, with P
  split into two halves of the input's type so that P V keeps float32's
  precision;
* float32: ``flash_fma_kernel``, float32 FMAs on the CUDA cores.

Neither falls back to the other.  Both mask keys at or past ``S``
themselves, so ``T`` and ``S`` need not be multiples of any block, and the
TPU kernel's ``block_q``/``block_k`` have no counterpart.

On a CUDA tensor :func:`flash_mha` runs its kernel or raises; its plain
version :func:`flash_mha_plain` (``ref.mha_ref``) runs only when the
tensors lie on the CPU.  The wrapper allocates the output, launches on
the current stream with the shared memory the kernel needs, raises if
the launch reports an error (a launch refused for too much shared memory
included), and adds one to ``flash_mha.launches`` for every launch.
:func:`flash_mha_tiled_replay` replays the 16-bit kernel's tiles,
masks and P split in torch on the CPU for the tests; no path calls it.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPES, check_dtype, on_cuda,
                                         raise_on_error)
from repro_torch.kernels.flash_attention.ref import NEG_INF, mha_ref

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
    lib.flash_attention_smem_bytes.argtypes = [i64, ctypes.c_int]
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
    the kernels' vector loads and TMA's tensor maps need (a contiguous view
    at an odd offset into a larger buffer does not)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % VECTOR_BYTES:
            raise ValueError(f"{name} must start on a {VECTOR_BYTES}-byte "
                             f"boundary (data_ptr {t.data_ptr():#x})")


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Plain torch version of :func:`flash_mha` (the same function)."""
    return mha_ref(q, k, v, causal=causal)


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory the kernel for this head dim and dtype
    needs."""
    return load_library().flash_attention_smem_bytes(hd, DTYPES[dtype])


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
    """q: (B, H, T, hd); k/v: (B, Hkv, S, hd) with Hkv | H, all float32,
    all bfloat16 or all float16, contiguous (and 16-byte aligned on the
    card).
    -> (B, H, T, hd) in q's dtype."""
    check_inputs(q, k, v)
    if not on_cuda(q, k, v):
        return flash_mha_plain(q, k, v, causal=causal)
    check_aligned(q, k, v)
    out = torch.empty_like(q)
    if out.numel():
        launch(q, k, v, out, causal, smem_bytes(q.shape[3], q.dtype))
    return out


flash_mha.launches = 0

# the 16-bit kernel's head-dim buckets, and its key tile at each
HEAD_DIM_BUCKETS = (64, 128, 192, 256)


def key_tile(hd: int) -> int:
    """Keys a tile of the 16-bit kernel at head dim ``hd``
    (``Layout<D>::kBk`` in the source)."""
    return 128 if hd <= 128 else 64


def flash_mha_tiled_replay(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool,
                           block_q: int = 128, block_k: int = 128,
                           split_p: bool = True) -> torch.Tensor:
    """The 16-bit kernel's arithmetic, replayed in torch on the CPU.

    q: (B, H, T, hd), k/v: (B, Hkv, S, hd), bfloat16 or float16.  Rows
    past T and S and columns past hd up to the head-dim bucket are zeros,
    as TMA fills them; each ``block_q`` query tile walks its key tiles in
    order, skipping those wholly past the causal diagonal; scores are
    float32 products, scaled into base 2 (``scale * log2(e)``), masked to
    -1e30 at keys past S or past the query (causal); m, l and the
    accumulator are float32.  P is split into halves P_hi + P_lo of q's
    type, multiplied by V one after the other (one P of q's type when
    ``split_p`` is False).  Test-only: the kernel's order of float32 sums
    inside a product is not replayed.
    """
    b, h, t, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    d = next(x for x in HEAD_DIM_BUCKETS if x >= hd)
    tp = -(-t // block_q) * block_q
    sp = -(-s // block_k) * block_k

    def padded(x, rows, heads):
        out = torch.zeros(b, heads, rows, d)
        out[:, :, :x.shape[2], :hd] = x.float()
        return out

    qf, kf, vf = padded(q, tp, h), padded(k, sp, hkv), padded(v, sp, hkv)
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    group = h // hkv
    out = torch.zeros(b, h, tp, d)
    kpos = torch.arange(sp)
    for q0 in range(0, tp, block_q):
        qpos = torch.arange(q0, q0 + block_q)[:, None]
        tiles = sp // block_k
        if causal:
            tiles = min(tiles, (q0 + block_q - 1) // block_k + 1)
        qb = qf[:, :, q0:q0 + block_q]                 # (b, h, bq, d)
        m = torch.full((b, h, block_q, 1), NEG_INF)
        l = torch.zeros(b, h, block_q, 1)
        acc = torch.zeros(b, h, block_q, d)
        for kt in range(tiles):
            k0 = kt * block_k
            kb = kf[:, :, k0:k0 + block_k].repeat_interleave(group, dim=1)
            vb = vf[:, :, k0:k0 + block_k].repeat_interleave(group, dim=1)
            x = (qb @ kb.transpose(2, 3)) * scale_log2
            cols = kpos[k0:k0 + block_k][None, :]
            masked = cols >= s
            if causal:
                masked = masked | (cols > qpos)
            x = x.masked_fill(masked, NEG_INF)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            hi = p.to(q.dtype).float()
            if split_p:
                lo = (p - hi).to(q.dtype).float()
                acc = acc * corr + hi @ vb + lo @ vb
            else:
                acc = acc * corr + hi @ vb
            m = m_new
        out[:, :, q0:q0 + block_q] = acc / l.clamp_min(1e-30)
    return out[:, :, :t, :hd].to(q.dtype)
