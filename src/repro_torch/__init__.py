"""PyTorch/CUDA port of the Contour connectivity reproduction.

A second package beside the JAX package ``repro``, module for module,
with the TPU's Pallas kernels replaced by hand-written CUDA kernels for
Hopper (``kernels/contour_mm/csrc``).  It imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``::

    from repro_torch import solve, Graph
    from repro_torch.graphs import generators as gen

    g = gen.rmat(20)                 # on cuda unless device= says otherwise
    result = solve(g)                # Contour C-2 on the CUDA kernels
    result.n_components
    batch = solve_batch([gen.rmat(10), gen.path(300)])   # a fleet at once
"""
from repro_torch.connectivity import (
    ComponentResult,
    Graph,
    SolveOptions,
    StrategyChoice,
    StreamingConnectivity,
    list_solvers,
    planner,
    register_solver,
    resolve_strategy,
    solve,
    solve_batch,
    stack_graphs,
)

__all__ = [
    "ComponentResult",
    "Graph",
    "SolveOptions",
    "StrategyChoice",
    "StreamingConnectivity",
    "list_solvers",
    "planner",
    "register_solver",
    "resolve_strategy",
    "solve",
    "solve_batch",
    "stack_graphs",
]
