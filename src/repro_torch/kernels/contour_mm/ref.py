"""Plain torch oracles for the contour_mm sweeps.

The port's counterpart of ``repro.kernels.contour_mm.ref``.
:func:`mm_block_ref` replays the *sequential* in-place 2-order sweep in
edge order (the asynchronous semantics of the scalar TPU kernel);
:func:`mm_sync_ref` is the synchronous sweep that both CUDA kernels of
``blocked.py`` must match bit for bit.
"""
from __future__ import annotations

import torch


def mm_block_ref(src: torch.Tensor, dst: torch.Tensor, L: torch.Tensor
                 ) -> torch.Tensor:
    """Sequential async 2-order MM sweep, in edge order."""
    lab = L.tolist()
    for w, v in zip(src.tolist(), dst.tolist()):
        lw = lab[w]
        lv = lab[v]
        z = min(lab[lw], lab[lv])
        for t in (w, v, lw, lv):
            lab[t] = min(lab[t], z)
    return torch.tensor(lab, dtype=L.dtype, device=L.device)


def mm_sync_ref(src: torch.Tensor, dst: torch.Tensor, L: torch.Tensor
                ) -> torch.Tensor:
    """Synchronous (Alg. 1) 2-order sweep: every read sees the input ``L``."""
    lw, lv = L[src], L[dst]
    z = torch.minimum(L[lw], L[lv])
    idx = torch.cat([src, dst, lw, lv]).long()
    return L.scatter_reduce(0, idx, z.repeat(4), "amin", include_self=True)
