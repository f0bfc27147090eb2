"""Execution-plan layer of the port (heuristic table only in this slice)."""
from repro_torch.connectivity.planner.heuristics import heuristic_plan
from repro_torch.connectivity.planner.plan import BACKENDS, ExecutionPlan

__all__ = ["BACKENDS", "ExecutionPlan", "heuristic_plan"]
