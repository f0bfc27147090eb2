"""Entry point for fused RMSNorm: flattening and backend select.

The port's counterpart of ``repro.kernels.fused_rmsnorm.ops``.  Two
backends:

* ``"cuda"``  — the hand-written row kernel :func:`kernel.rmsnorm_rows`
  (the reference's ``"pallas"``); on CPU tensors its plain version;
* ``"torch"`` — ``ref.rmsnorm_ref`` (the reference's ``"xla"``).

The reference padded the rows to a multiple of its block with rows of
ones; the kernel takes any row count, and rows are independent, so
nothing is padded and the result is the same.  The reference's
``interpret`` flag has no counterpart: which version runs follows the
tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_rmsnorm.kernel import rmsnorm_rows
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

BACKENDS = ("cuda", "torch")


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
                  backend: str = "cuda") -> torch.Tensor:
    """x: (..., d); w: (d,).  RMS-normalise the trailing dim."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "torch":
        return rmsnorm_ref(x, w, eps)
    if x.dim() == 0:
        raise ValueError("x must have a trailing dim to normalise")
    d = x.shape[-1]
    y = rmsnorm_rows(x.reshape(-1, d).contiguous(), w, eps=eps)
    return y.reshape(x.shape)
