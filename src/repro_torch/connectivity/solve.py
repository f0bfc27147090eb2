"""The port's facade: ``solve(graph, options) -> ComponentResult``.

The counterpart of ``repro.connectivity.solve``: typed options, solver
lookup through the registry, warm starts, and the resolved plan recorded
in ``provenance``.  The solve runs on the device of the graph's tensors.
There is no ``kernel_fallback``: a kernel that fails on the card raises.

Example::

    from repro_torch import solve, Graph

    result = solve(graph)                               # Contour C-2
    result = solve(graph, variant="C-m")
    bigger = graph.add_edges(new_src, new_dst)
    result2 = solve(bigger, warm_start=result)          # incremental
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.connectivity import minmap
from repro_torch.connectivity.options import SolveOptions
from repro_torch.connectivity.registry import SolverSpec, get_solver
from repro_torch.connectivity.result import ComponentResult
from repro_torch.graphs.structs import Graph

# Solver families that resolve an ExecutionPlan at the facade (recorded in
# provenance); "oocore" also gets the streaming chunk bucket in its plan.
_PLANNED_SOLVERS = ("contour", "oocore")


def resolve_warm_start(warm_start, n_vertices: int):
    """Normalise a warm start to a label tensor (or None).

    Accepts a previous :class:`ComponentResult`, a tensor, a numpy array
    or a list of labels.  Length and the ``L[v] <= v`` clamp are settled
    by :func:`minmap.resolve_init_labels`.
    """
    del n_vertices  # length is validated by minmap.resolve_init_labels
    if warm_start is None:
        return None
    if isinstance(warm_start, ComponentResult):
        if warm_start.is_batched:
            raise ValueError(
                "warm_start is a batched ComponentResult; unstack() it or "
                "use solve_batch")
        warm_start = warm_start.labels
    labels = (warm_start if isinstance(warm_start, torch.Tensor)
              else torch.tensor(np.asarray(warm_start)))
    if labels.dim() != 1:
        raise ValueError(
            f"warm_start labels must be 1-D, got shape {tuple(labels.shape)}")
    minmap.check_labels_nonnegative(labels)
    return labels


def solver_output(out):
    """Normalise a registry solver's return to a uniform 4-tuple.

    A solver may append a 5th element, a tuple of provenance strings (the
    Contour family's resolved plan), which ``solve`` records.
    """
    labels, iterations, converged = out[:3]
    edges_visited = out[3] if len(out) > 3 else None
    return labels, iterations, converged, edges_visited


def make_result(labels, iterations, converged, edges_visited=None,
                batch_sizes=None, provenance=None) -> ComponentResult:
    """Canonical dtype normalisation into a :class:`ComponentResult`.

    int32 iterations, bool converged and a float32 work counter, as
    tensors on the labels' device (0-d, or ``[B]`` for a batched result
    with its ``batch_sizes``).  The one constructor of ``solve``,
    ``solve_batch`` and the streaming engine's ``snapshot()``.
    """
    device = labels.device
    return ComponentResult(
        labels=labels,
        iterations=torch.as_tensor(iterations, device=device).to(torch.int32),
        converged=torch.as_tensor(converged, device=device).to(torch.bool),
        batch_sizes=batch_sizes,
        edges_visited=(None if edges_visited is None else
                       torch.as_tensor(edges_visited, device=device)
                       .to(torch.float32)),
        provenance=(tuple(provenance) if provenance else None))


def _resolve(options: Optional[SolveOptions],
             overrides) -> tuple[SolveOptions, SolverSpec]:
    """Validate options and pick the solver."""
    opts = options if options is not None else SolveOptions()
    if not isinstance(opts, SolveOptions):
        raise TypeError(
            f"options must be SolveOptions, got {type(opts).__name__}")
    if overrides:
        opts = opts.replace(**overrides)
    opts.validate()
    spec = get_solver(opts.algorithm)
    opts = opts.replace(
        variant=spec.validate_variant(opts.variant),
        # registry default is the single source of per-solver budgets
        max_iters=(spec.default_max_iters if opts.max_iters is None
                   else opts.max_iters),
    )
    return opts, spec


def solve(
    graph: Graph,
    options: Optional[SolveOptions] = None,
    *,
    warm_start=None,
    **overrides,
) -> ComponentResult:
    """Solve connectivity on ``graph``; returns a :class:`ComponentResult`.

    Args:
      graph: edge-list :class:`Graph` (each undirected edge once); the
        solve runs on its device.
      options: a :class:`SolveOptions`; defaults to Contour C-2 on the
        ``auto`` backend (the CUDA kernels).
      warm_start: previous labels (tensor, array or
        :class:`ComponentResult`) to continue from — e.g. after
        :meth:`Graph.add_edges`.  Overrides ``options.warm_start``.
      **overrides: per-call :class:`SolveOptions` field overrides, e.g.
        ``solve(g, variant="C-m")``.  An unknown field raises
        ``TypeError``.
    """
    opts, spec = _resolve(options, overrides)
    init = resolve_warm_start(
        warm_start if warm_start is not None else opts.warm_start,
        graph.n_vertices)
    if init is not None and not spec.supports_warm_start:
        raise ValueError(f"solver {spec.name!r} does not support warm "
                         "starts")
    out = spec.fn(graph, opts, init)
    provenance = out[4] if len(out) > 4 else None
    return make_result(*solver_output(out), provenance=provenance)
