"""Solver registry: every connectivity algorithm family behind one signature.

A copy of the JAX package's registry, so the port's facade looks solvers
up the same way.  This slice registers only ``contour``.

A registered solver is a callable

    fn(graph: Graph, opts: SolveOptions, init_labels)
        -> (labels, iterations, converged[, edges_visited[, provenance]])

where ``init_labels`` is the resolved warm-start array (or None for a
cold start) and ``converged`` is the solver's own fixed-point flag
(False iff the iteration budget ran out).  Edge-sweep solvers may append
a float32 ``edges_visited`` work counter (the Contour family does), and
then a tuple of provenance strings (the Contour family records its
resolved plan); ``solve()`` normalises every arity.  The ``solve()``
facade looks solvers up here, so adding an algorithm family is one
``@register_solver`` away — no facade changes.

The registry also records capability flags (warm start, batched solving,
mesh execution, host vs device) that ``solve()`` uses to fail fast with a
clear message, plus the paper section each family reproduces.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

_REGISTRY: Dict[str, "SolverSpec"] = {}
_ALIASES: Dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """One registered algorithm family."""

    name: str
    fn: Callable                         # (graph, opts, init) -> (L, it, done)
    aliases: Tuple[str, ...] = ()
    variants: Tuple[str, ...] = ()       # () = takes no variant
    default_variant: Optional[str] = None
    default_max_iters: int = 100_000
    supports_warm_start: bool = True
    supports_batch: bool = True          # solvable as one batched call
    supports_mesh: bool = False          # runs on a Mesh via shard_map
    # delta-resweep safe: starting from a star-forest fixed point, sweeping
    # only newly ingested edges (rewritten to their endpoints' current
    # roots) reaches the full graph's fixed point.  A min-mapping property
    # — see connectivity.streaming / DESIGN.md §11 — so only the Contour
    # families set it.
    supports_streaming: bool = False
    runs_on: str = "device"              # "device" | "host"
    paper_ref: str = ""                  # paper section this reproduces

    def validate_variant(self, variant: Optional[str]) -> Optional[str]:
        """Resolve/validate a requested variant for this solver."""
        if variant is None:
            return self.default_variant
        if not self.variants:
            raise ValueError(
                f"solver {self.name!r} takes no variant, got {variant!r}")
        if variant in self.variants:
            return variant
        # Contour accepts literal h-order variants "C-<h>" beyond the
        # named set (used to validate the pointer-jump equivalence).
        if ("C-<h>" in self.variants and variant.startswith("C-")
                and variant[2:].isdigit()):
            return variant
        raise ValueError(
            f"unknown variant {variant!r} for solver {self.name!r}; "
            f"one of {self.variants}")


def register_solver(spec: SolverSpec) -> SolverSpec:
    """Register (or replace) a solver family; returns the spec."""
    _REGISTRY[spec.name] = spec
    for alias in spec.aliases:
        _ALIASES[alias] = spec.name
    return spec


def resolve_name(name: str) -> str:
    """Canonical solver name for ``name`` (which may be an alias)."""
    if name in _REGISTRY:
        return name
    if name in _ALIASES:
        return _ALIASES[name]
    known = sorted(_REGISTRY) + sorted(_ALIASES)
    raise ValueError(f"unknown algorithm {name!r}; known: {known}")


def get_solver(name: str) -> SolverSpec:
    return _REGISTRY[resolve_name(name)]


def list_solvers() -> Tuple[str, ...]:
    """Canonical names of every registered solver family."""
    return tuple(sorted(_REGISTRY))


def solver_specs() -> Tuple[SolverSpec, ...]:
    return tuple(_REGISTRY[k] for k in list_solvers())
