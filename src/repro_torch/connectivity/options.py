"""Typed options for the port's ``solve()`` facade.

The port's counterpart of ``repro.connectivity.options``, with only the
fields the port honours:

* **algorithm selection** — ``algorithm`` (registry name or alias) and
  ``variant`` (Contour's ``C-Syn``/``C-1``/``C-2``/``C-m``/``C-11mm``/
  ``C-1m1m`` or a literal ``C-<h>``);
* **kernel dispatch** — ``backend``: ``"auto"`` (a tuned plan from the
  tuning cache, else the heuristic table, which picks ``"cuda"``),
  ``"cuda"`` (the synchronous sweep kernels), ``"cuda_async"`` (the
  in-order asynchronous 2-order sweep kernel; the reference's scalar
  ``"pallas"``) or ``"torch"`` (plain torch scatter-min); ``plan`` pins
  a whole :class:`~repro_torch.connectivity.planner.ExecutionPlan`
  (``planner.resolve_plan``: pinned > cache > table);
* **work schedule** — ``sampling``/``compact_every`` enable the
  work-adaptive frontier of ``connectivity.frontier``; both 0 (the
  default) is the paper's dense schedule.  ``sampling_strategy`` picks
  the sampling phase's edges (``frontier.SAMPLING_STRATEGIES``; ``None``
  is ``"prefix"``) and ``sampling_k`` the k-out fan-in;
* ``warm_start`` — the previous solve's labels (or a whole
  :class:`~repro_torch.connectivity.result.ComponentResult`);
* **out-of-core streaming** (``algorithm="oocore"``,
  ``connectivity.oocore``) — ``oocore_chunk_edges`` (the device edge
  chunk; 0 takes ``planner.oocore_chunk_bucket``'s default),
  ``oocore_round_cap`` (host-contraction rounds before the in-core
  finish is forced) and ``oocore_local_iters`` (bounded local sweeps
  folded per chunk per round).

The reference's other fields (``mesh``, ``edge_axes``, ``local_rounds``,
``vmem_limit_bytes``) come with the slices that honour them, and
setting one fails with a ``TypeError``.
``vmem_limit_bytes`` bounded the TPU scalar kernel's whole-L ceiling,
which ``cuda_async`` does not have.  ``kernel_fallback`` is left out
on purpose: a kernel that fails on the card raises; it is never retried
on the plain path behind the caller's back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.connectivity.frontier import get_sampling_strategy
from repro_torch.connectivity.planner.plan import BACKENDS
from repro_torch.connectivity.planner.staged import MIN_STAGE_EDGES


@dataclasses.dataclass(frozen=True, eq=False)
class SolveOptions:
    """Options for :func:`repro_torch.connectivity.solve`.

    ``eq=False`` keeps instances identity-hashed: ``warm_start`` may hold
    a tensor, which has no value equality.
    """

    algorithm: str = "contour"
    variant: Optional[str] = None          # per-algorithm default if None
    backend: str = "auto"
    plan: Optional[Any] = None             # a pinned ExecutionPlan
    max_iters: Optional[int] = None        # per-algorithm default if None
    warmup: int = 2                        # C-11mm's C-1 prefix length
    async_compress: int = 1                # in-iteration pointer-jump rounds
    sampling: int = 0                      # frontier sample-prefix sweeps
    compact_every: int = 0                 # contraction cadence (0 = dense)
    sampling_strategy: Optional[str] = None  # None = "prefix"
    sampling_k: int = 2                    # k-out sampler fan-in per vertex
    warm_start: Optional[Any] = None       # labels or ComponentResult
    oocore_chunk_edges: int = 0            # 0 = the planner's default
    oocore_round_cap: int = 64
    oocore_local_iters: int = 4

    def replace(self, **updates) -> "SolveOptions":
        """Return a copy with the given fields replaced."""
        return dataclasses.replace(self, **updates)

    def validate(self) -> None:
        """Cheap structural checks; registry-level checks live in solve()."""
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} not one of {BACKENDS}")
        if self.max_iters is not None and self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")
        # negative counts would silently change the iteration math instead
        # of failing
        for field in ("warmup", "async_compress", "sampling",
                      "compact_every"):
            value = getattr(self, field)
            if value < 0:
                raise ValueError(f"{field} must be >= 0, got {value}")
        if self.sampling_strategy is not None:
            get_sampling_strategy(self.sampling_strategy)  # raises on typo
        if self.sampling_k < 1:
            raise ValueError(
                f"sampling_k must be >= 1, got {self.sampling_k}")
        if self.oocore_chunk_edges and \
                self.oocore_chunk_edges < MIN_STAGE_EDGES:
            raise ValueError(
                f"oocore_chunk_edges must be 0 (auto) or >= "
                f"MIN_STAGE_EDGES ({MIN_STAGE_EDGES}); a chunk of "
                f"{self.oocore_chunk_edges} edges would thrash "
                f"per-bucket compiles")
        if self.oocore_round_cap < 1:
            raise ValueError(f"oocore_round_cap must be >= 1, got "
                             f"{self.oocore_round_cap}")
        if self.oocore_local_iters < 1:
            raise ValueError(f"oocore_local_iters must be >= 1, got "
                             f"{self.oocore_local_iters}")
