"""Roofline machinery (the port's ``repro.roofline``): the cost of a
rank's program counted op by op on ``meta`` tensors (``op_cost``, the
counterpart of ``hlo_cost``), the collective byte model, the report's
three terms against an H100's peaks, and MODEL_FLOPS."""
from repro_torch.roofline.analysis import (
    HW_H100,
    CollectiveStats,
    RooflineReport,
    analyze_program,
    collective_stats,
    count_params,
    model_flops,
)

__all__ = [
    "HW_H100", "CollectiveStats", "RooflineReport",
    "analyze_program", "collective_stats", "count_params", "model_flops",
]
