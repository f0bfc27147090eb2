"""Execution-plan layer of the port: the heuristic table, the plan, and
the staged frontier driver (``planner.staged``)."""
from repro_torch.connectivity.planner.heuristics import heuristic_plan
from repro_torch.connectivity.planner.plan import BACKENDS, ExecutionPlan

__all__ = ["BACKENDS", "ExecutionPlan", "heuristic_plan"]
