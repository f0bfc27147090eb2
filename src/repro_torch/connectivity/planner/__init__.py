"""Execution-plan layer of the port: the heuristic table, the plan, the
out-of-core chunk bucket, and the staged frontier (``planner.staged``)."""
from repro_torch.connectivity.planner.heuristics import (
    OOCORE_BYTES_PER_EDGE,
    heuristic_plan,
    oocore_chunk_bucket,
)
from repro_torch.connectivity.planner.plan import (
    BACKENDS,
    ExecutionPlan,
    next_pow2,
)

__all__ = ["BACKENDS", "ExecutionPlan", "OOCORE_BYTES_PER_EDGE",
           "heuristic_plan", "next_pow2", "oocore_chunk_bucket"]
