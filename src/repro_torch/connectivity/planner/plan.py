"""The resolved execution plan a kernel-backed solve runs under.

The port's counterpart of ``repro.connectivity.planner.plan``, cut to the
fields this slice honours: which backend realises the MM sweep, whether
order-2 sweeps take the fused kernel, the device the plan was made for,
and where the plan came from.  The tile sizes, compaction schedule and
out-of-core chunk of the TPU plan have no meaning for the CUDA kernels
yet; the tuning cache and autotuner come with the planner slice.
"""
from __future__ import annotations

import dataclasses

BACKENDS = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Resolved backend for one solve (frozen, hashable)."""

    backend: str                    # concrete: "torch" | "cuda"
    fuse_relabel: bool = True       # order-2 sweeps take fused_relax
    device: str = "cuda"            # device type the plan was made for
    origin: str = "heuristic"       # heuristic | pinned

    def replace(self, **updates) -> "ExecutionPlan":
        return dataclasses.replace(self, **updates)

    def provenance_entry(self) -> str:
        """The ``plan:`` line recorded in ``ComponentResult.provenance``."""
        return (f"plan:{self.backend} origin={self.origin} "
                f"fused={int(self.fuse_relabel)} device={self.device}")
