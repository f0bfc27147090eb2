"""Heuristic table: which kernel carries a sweep on the CUDA port.

The port's counterpart of ``repro.connectivity.planner.heuristics``.  On
the TPU the fused order-2 pass was limited to one VMEM tile
(``SINGLE_TILE_MAX_N``); above it the binned scatter-min carried the
sweep.  On Hopper the fused kernel gathers from device memory and has no
such limit, so the table has one row: the ``cuda`` backend, with order-2
sweeps on ``fused_relax`` at any ``n`` and every other order on
``scatter_min`` (``ops.mm_relax_backend``).  The platform comes from the
labels' device; on a CPU tensor the kernel wrappers run their plain
versions.
"""
from __future__ import annotations

import torch

from repro_torch.connectivity.planner.plan import ExecutionPlan


def heuristic_plan(n_vertices: int, n_edges: int,
                   device: torch.device) -> ExecutionPlan:
    """The plan for a graph of this size on ``device``."""
    del n_vertices, n_edges  # one row: the kernels take every size
    return ExecutionPlan(backend="cuda", fuse_relabel=True,
                         device=torch.device(device).type,
                         origin="heuristic")
