"""Typed options for the port's ``solve()`` facade.

The port's counterpart of ``repro.connectivity.options``, with only the
fields this slice honours:

* **algorithm selection** — ``algorithm`` (registry name or alias) and
  ``variant`` (Contour's ``C-Syn``/``C-1``/``C-2``/``C-m``/``C-11mm``/
  ``C-1m1m`` or a literal ``C-<h>``);
* **kernel dispatch** — ``backend``: ``"auto"`` (the heuristic table,
  which picks ``"cuda"``), ``"cuda"`` (the hand-written kernels) or
  ``"torch"`` (plain torch scatter-min);
* **work schedule** — ``sampling``/``compact_every`` must stay 0 (the
  dense schedule) until the frontier slice;
* ``warm_start`` — the previous solve's labels (or a whole
  :class:`~repro_torch.connectivity.result.ComponentResult`).

The reference's other fields (``mesh``, ``edge_axes``, ``local_rounds``,
``plan``, ``sampling_strategy``, ``sampling_k``, ``vmem_limit_bytes``,
the ``oocore_*`` fields) come with the slices that honour them, and
setting one fails with a ``TypeError``.  ``kernel_fallback`` is left out
on purpose: a kernel that fails on the card raises; it is never retried
on the plain path behind the caller's back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.connectivity.planner.plan import BACKENDS


@dataclasses.dataclass(frozen=True, eq=False)
class SolveOptions:
    """Options for :func:`repro_torch.connectivity.solve`.

    ``eq=False`` keeps instances identity-hashed: ``warm_start`` may hold
    a tensor, which has no value equality.
    """

    algorithm: str = "contour"
    variant: Optional[str] = None          # per-algorithm default if None
    backend: str = "auto"
    max_iters: Optional[int] = None        # per-algorithm default if None
    warmup: int = 2                        # C-11mm's C-1 prefix length
    async_compress: int = 1                # in-iteration pointer-jump rounds
    sampling: int = 0                      # frontier sample-prefix sweeps
    compact_every: int = 0                 # contraction cadence (0 = dense)
    warm_start: Optional[Any] = None       # labels or ComponentResult

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
