"""Plain torch oracle for the fused_rmsnorm kernel.

The port's counterpart of ``repro.kernels.fused_rmsnorm.ref``.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · w`` over the last dim, in float32,
    cast back to ``x.dtype``."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)
