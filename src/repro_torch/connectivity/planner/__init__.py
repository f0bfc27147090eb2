"""Execution-plan layer of the port: the plan, the heuristic table, the
measuring autotuner and its cache, the ``auto`` cost model, the
out-of-core chunk bucket and the staged frontier (``planner.staged``).

:func:`resolve_plan` is the single resolution point, as the reference's::

    pinned plan argument  >  tuning cache (only for backend="auto")
                          >  heuristic table

An explicit backend is a statement of intent: it skips the cache and
takes the table's plan with that backend substituted.

The reference's ``planner.vmem`` (a per-core VMEM budget and the scalar
kernel's whole-L ceiling) is not ported: the card has no VMEM, the
out-of-core chunk's default is fixed (``heuristics``) and ``cuda_async``
takes any n.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.connectivity.planner import cache
from repro_torch.connectivity.planner.autotune import (
    autotune,
    candidate_plans,
    plan_label,
)
from repro_torch.connectivity.planner.costmodel import (
    ENV_BENCH_ARTIFACT,
    StrategyChoice,
    resolve_strategy,
)
from repro_torch.connectivity.planner.heuristics import (
    OOCORE_BYTES_PER_EDGE,
    STAGED_MIN_EDGES,
    heuristic_plan,
    oocore_chunk_bucket,
)
from repro_torch.connectivity.planner.plan import (
    BACKENDS,
    COMPACT_SCHEDULES,
    ORIGINS,
    ExecutionPlan,
    next_pow2,
    plan_key,
    size_bucket,
)

__all__ = [
    "BACKENDS",
    "COMPACT_SCHEDULES",
    "ENV_BENCH_ARTIFACT",
    "ExecutionPlan",
    "OOCORE_BYTES_PER_EDGE",
    "ORIGINS",
    "STAGED_MIN_EDGES",
    "StrategyChoice",
    "autotune",
    "cache",
    "candidate_plans",
    "heuristic_plan",
    "next_pow2",
    "oocore_chunk_bucket",
    "plan_key",
    "plan_label",
    "resolve_plan",
    "resolve_strategy",
    "size_bucket",
]


def resolve_plan(
    n_vertices: int,
    m_edges: int,
    *,
    backend: str = "auto",
    plan: Optional[ExecutionPlan] = None,
    device="cuda",
    use_cache: bool = True,
) -> ExecutionPlan:
    """Resolve the :class:`ExecutionPlan` for one solve on ``device``.

    A ``plan`` pinned by the caller wins outright.  Otherwise, with
    ``backend="auto"``, a valid tuned entry of the cache for this device
    type and size bucket is used; on a miss the heuristic table decides.
    A forced backend takes the table's plan with that backend substituted
    (origin ``"pinned"``).
    """
    if plan is not None:
        if not isinstance(plan, ExecutionPlan):
            raise TypeError(f"plan must be an ExecutionPlan, got "
                            f"{type(plan).__name__}")
        return plan.validate()
    device_type = torch.device(device).type
    if backend == "auto":
        if use_cache:
            cached = cache.lookup(n_vertices, m_edges, device_type)
            if cached is not None:
                return cached
        return heuristic_plan(n_vertices, m_edges, device)
    return heuristic_plan(n_vertices, m_edges, device).replace(
        backend=backend, origin="pinned")
