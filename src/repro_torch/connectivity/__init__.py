"""``repro_torch.connectivity`` — the port's public connectivity API.

::

    from repro_torch.connectivity import solve, SolveOptions

    result = solve(graph)                       # Contour C-2 on the card
    result.n_components, result.component_sizes()
    result.same_component(u, v)

    bigger = graph.add_edges(new_src, new_dst)
    result2 = solve(bigger, warm_start=result)  # incremental
"""
from repro_torch.connectivity.options import SolveOptions
from repro_torch.connectivity.result import ComponentResult
from repro_torch.connectivity.registry import (
    SolverSpec,
    get_solver,
    list_solvers,
    register_solver,
    solver_specs,
)
from repro_torch.connectivity import solvers as _solvers  # registers contour
from repro_torch.connectivity.solve import solve
from repro_torch.connectivity.contour import VARIANTS
from repro_torch.graphs.structs import Graph

__all__ = [
    "ComponentResult",
    "Graph",
    "SolveOptions",
    "SolverSpec",
    "VARIANTS",
    "get_solver",
    "list_solvers",
    "register_solver",
    "solve",
    "solver_specs",
]
