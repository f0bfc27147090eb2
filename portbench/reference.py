"""The plain reference: connected components in plain PyTorch.

Independent of the program under test: it imports nothing of
``repro_torch`` and takes only the edges the benchmark generated.  It
returns what the configurations guarantee, each vertex's component
labelled by the least vertex id in it, as int32.

The method is hooking and shortcutting (Shiloach-Vishkin style).  The
labels are a star forest at the start of every round: each label is its
tree's root.  A round reads the two roots of every edge and hooks the
larger onto the least smaller root it meets (a scatter-min into a copy,
so the round's reads see the old roots), then jumps pointers until the
labels are stars again.  Hooks only go to smaller ids, so no cycle can
form; every tree with an edge leaving it merges with another in each
round, so a component of ``k`` vertices needs at most ``log2(k) + 1``
rounds whatever its diameter; the least id of a component is never
hooked, so it ends as the label.  Edges are read in blocks to bound the
scratch memory.
"""
from __future__ import annotations

import torch

BLOCK = 1 << 27


def components(src: torch.Tensor, dst: torch.Tensor, n: int,
               block: int = BLOCK) -> torch.Tensor:
    """The least vertex id of each vertex's component, int32[n]."""
    device = src.device
    labels = torch.arange(n, dtype=torch.int64, device=device)
    m = int(src.shape[0])
    while True:
        hooked = labels.clone()
        merges = 0
        for lo in range(0, m, block):
            ru = labels[src[lo:lo + block].long()]
            rv = labels[dst[lo:lo + block].long()]
            small, big = torch.minimum(ru, rv), torch.maximum(ru, rv)
            cross = small != big
            merges += int(cross.sum())
            hooked.scatter_reduce_(0, big[cross], small[cross], "amin")
            del ru, rv, small, big, cross
        labels = hooked
        while True:
            jumped = labels[labels]
            if torch.equal(jumped, labels):
                break
            labels = jumped
        if merges == 0:
            return labels.int()


def mismatches(labels: torch.Tensor, expected: torch.Tensor) -> int:
    """The count of labels that differ from the reference's (shapes must
    agree; a missing or extra label counts as every label differing)."""
    if tuple(labels.shape) != tuple(expected.shape):
        return max(labels.numel(), expected.numel())
    return int((labels.to(expected.device, torch.int32) != expected).sum())
