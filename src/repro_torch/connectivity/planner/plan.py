"""The resolved execution plan a kernel-backed solve runs under.

The port's counterpart of ``repro.connectivity.planner.plan``, cut to the
fields the port honours: which backend realises the MM sweep, whether
order-2 ``cuda`` sweeps take the fused kernel, how the work-adaptive
frontier is realised, the out-of-core solver's edge chunk, the device
the plan was made for, and where the plan came from.  The tile sizes of
the TPU plan have no meaning for the CUDA kernels; the tuning cache and
autotuner come with the planner slice.

The backends carry new names for the reference's:

* ``"torch"``      — plain torch scatter-min (the reference's ``"xla"``);
* ``"cuda"``       — the synchronous sweep kernels ``fused_relax`` and
  ``scatter_min`` (the reference's ``"pallas_blocked"``);
* ``"cuda_async"`` — the in-order asynchronous sweep kernel ``mm2`` (the
  reference's scalar ``"pallas"``).
"""
from __future__ import annotations

import dataclasses

BACKENDS = ("auto", "torch", "cuda", "cuda_async")


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Resolved backend and schedule for one solve (frozen, hashable)."""

    backend: str                    # concrete: "torch"|"cuda"|"cuda_async"
    fuse_relabel: bool = True       # order-2 cuda sweeps take fused_relax
    # frontier realisation: "masked" keeps the edge arrays whole and
    # bounds each sweep; "staged" also slices them to a pow2 capacity
    # that shrinks with the frontier (planner.staged)
    compact_schedule: str = "masked"
    # the out-of-core solver's pow2 edge chunk (0 = not out-of-core)
    chunk_bucket: int = 0
    device: str = "cuda"            # device type the plan was made for
    origin: str = "heuristic"       # heuristic | pinned

    def __post_init__(self):
        cb = self.chunk_bucket
        if not isinstance(cb, int) or cb < 0 or (cb and cb & (cb - 1)):
            raise ValueError(
                f"chunk_bucket must be 0 or a power of two, got {cb!r}")

    def replace(self, **updates) -> "ExecutionPlan":
        return dataclasses.replace(self, **updates)

    def provenance_entry(self) -> str:
        """The ``plan:`` line recorded in ``ComponentResult.provenance``."""
        oc = f" chunk={self.chunk_bucket}" if self.chunk_bucket else ""
        return (f"plan:{self.backend} origin={self.origin} "
                f"schedule={self.compact_schedule} "
                f"fused={int(self.fuse_relabel)} device={self.device}{oc}")
