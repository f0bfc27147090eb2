"""Entry point for flash attention: the reference's contract, backend
select.

The port's counterpart of ``repro.kernels.flash_attention.ops``.  Two
backends:

* ``"cuda"``  — the hand-written kernel :func:`kernel.flash_mha` (the
  reference's ``"pallas"``); on CPU tensors its plain version;
* ``"torch"`` — ``ref.mha_ref`` (the reference's ``"xla"``).

The kernel masks its own ragged edge, so nothing is padded: ``block_q``
and ``block_k`` only keep the reference's contract.  A non-causal call
with ``S % block_k != 0`` raises ``ValueError``, as the reference does
(``ops.py:47-48``).  So does a causal call with ``T > S`` and
``S % block_k != 0``, where the reference is wrong: it pads K/V with zero
keys, and its causal mask lets the queries past ``S`` attend to them
(at T=200, S=130, blocks of 64 its output differs from ``mha_ref`` by
0.12).  The reference's ``interpret`` flag has no counterpart: which
version runs follows the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_mha
from repro_torch.kernels.flash_attention.ref import mha_ref

BACKENDS = ("cuda", "torch")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128,
                    backend: str = "cuda") -> torch.Tensor:
    """q: (B, H, T, hd); k/v: (B, Hkv, S, hd).  Returns (B, H, T, hd)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got {block_q}, "
                         f"{block_k}")
    if backend == "torch":
        return mha_ref(q, k, v, causal=causal)
    t, s = q.shape[2], k.shape[2]
    if s % block_k and not causal:
        raise ValueError("non-causal flash requires S % block_k == 0")
    if s % block_k and t > s:
        raise ValueError(
            f"causal flash with T > S requires S % block_k == 0 (T={t}, "
            f"S={s}, block_k={block_k}): the reference pads K/V with zero "
            "keys that the queries past S attend to")
    return flash_mha(q.contiguous(), k.contiguous(), v.contiguous(),
                     causal=causal)
