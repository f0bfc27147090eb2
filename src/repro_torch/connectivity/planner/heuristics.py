"""Heuristic table: which kernel carries a sweep on the CUDA port.

The port's counterpart of ``repro.connectivity.planner.heuristics``.  On
the TPU the fused order-2 pass was limited to one VMEM tile
(``SINGLE_TILE_MAX_N``); above it the binned scatter-min carried the
sweep.  On Hopper the fused kernel gathers from device memory and has no
such limit, so the table has one row: the ``cuda`` backend, with order-2
sweeps on ``fused_relax`` at any ``n`` and every other order on
``scatter_min`` (``ops.mm_relax_backend``).  ``auto`` never picks
``cuda_async``, as the reference's table never picks its scalar
``pallas`` kernel.  The platform comes from the labels' device; on a CPU
tensor the kernel wrappers run their plain versions.

The frontier's realisation follows the reference's table: ``staged`` from
``STAGED_MIN_EDGES`` edges on, ``masked`` below.
"""
from __future__ import annotations

import torch

from repro_torch.connectivity.planner.plan import ExecutionPlan

# the reference's threshold (heuristics.py:22): from this many edges on,
# the frontier runs staged
STAGED_MIN_EDGES = 1 << 15


def heuristic_plan(n_vertices: int, n_edges: int,
                   device: torch.device) -> ExecutionPlan:
    """The plan for a graph of this size on ``device``."""
    del n_vertices  # the kernels take every size
    compact = "staged" if n_edges >= STAGED_MIN_EDGES else "masked"
    return ExecutionPlan(backend="cuda", fuse_relabel=True,
                         compact_schedule=compact,
                         device=torch.device(device).type,
                         origin="heuristic")
