"""Plain torch oracle for the flash_attention kernel: exact GQA softmax.

The port's counterpart of ``repro.kernels.flash_attention.ref``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True) -> torch.Tensor:
    """q: (B, H, T, hd); k/v: (B, Hkv, S, hd).  fp32 softmax, exact.

    Query head ``h`` attends to KV head ``h // (H / Hkv)``; the causal
    mask is top-left (key ``s`` is seen by query ``t`` when ``s <= t``).
    """
    b, h, t, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, t, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(s, device=q.device)[None, :]
                <= torch.arange(t, device=q.device)[:, None])
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", w, v.float())
    return out.reshape(b, h, t, hd).to(q.dtype)
