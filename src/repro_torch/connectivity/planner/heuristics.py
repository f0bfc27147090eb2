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

The out-of-core chunk (:func:`oocore_chunk_bucket`) keeps the
reference's rule at a fixed budget: the reference derives its default
from the TPU's per-core VMEM budget, 16 MiB on a host that reports none,
and the port has no VMEM, so it keeps that derivation as
:data:`OOCORE_DEFAULT_BUDGET_BYTES` and reads neither ``REPRO_VMEM_BYTES``
nor a ``vmem_limit_bytes``; callers size chunks with
``SolveOptions.oocore_chunk_edges``.
"""
from __future__ import annotations

import torch

from repro_torch.connectivity.planner.plan import ExecutionPlan, next_pow2

# the reference's threshold (heuristics.py:22): from this many edges on,
# the frontier runs staged
STAGED_MIN_EDGES = 1 << 15

# Out-of-core chunk sizing: per-edge device cost of one resident chunk
# (the reference's OOCORE_BYTES_PER_EDGE), and the budget it divides: the
# reference's 16 MiB default, which makes the default chunk 2**17 edges.
OOCORE_BYTES_PER_EDGE = 128
OOCORE_DEFAULT_BUDGET_BYTES = 16 * 1024 * 1024


def heuristic_plan(n_vertices: int, n_edges: int,
                   device: torch.device) -> ExecutionPlan:
    """The plan for a graph of this size on ``device``."""
    del n_vertices  # the kernels take every size
    compact = "staged" if n_edges >= STAGED_MIN_EDGES else "masked"
    return ExecutionPlan(backend="cuda", fuse_relabel=True,
                         compact_schedule=compact,
                         device=torch.device(device).type,
                         origin="heuristic")


def oocore_chunk_bucket(n_edges: int, requested: int = 0) -> int:
    """The pow2 edge-chunk bucket the out-of-core streamer runs at.

    ``requested`` (``SolveOptions.oocore_chunk_edges``) wins when set,
    rounded up to a power of two; otherwise the bucket is
    :data:`OOCORE_DEFAULT_BUDGET_BYTES` over :data:`OOCORE_BYTES_PER_EDGE`,
    rounded down to a power of two.  Either way the result is clamped to
    ``[MIN_STAGE_EDGES, next_pow2(m)]``, as the reference clamps it.
    """
    # staged imports this package (through plan): import it late, as the
    # reference does
    from repro_torch.connectivity.planner.staged import MIN_STAGE_EDGES
    if requested and requested > 0:
        bucket = next_pow2(requested)
    else:
        budget = OOCORE_DEFAULT_BUDGET_BYTES
        # round *down* to pow2: never exceed the byte budget
        bucket = next_pow2(max(budget // OOCORE_BYTES_PER_EDGE, 1))
        if bucket * OOCORE_BYTES_PER_EDGE > budget:
            bucket //= 2
    ceiling = max(next_pow2(n_edges), MIN_STAGE_EDGES)
    return max(MIN_STAGE_EDGES, min(bucket, ceiling))
