"""``repro_torch.connectivity`` — the port's public connectivity API.

::

    from repro_torch.connectivity import solve, SolveOptions

    result = solve(graph)                       # Contour C-2 on the card
    result.n_components, result.component_sizes()
    result.same_component(u, v)

    bigger = graph.add_edges(new_src, new_dst)
    result2 = solve(bigger, warm_start=result)  # incremental

    # the work-adaptive frontier, on any backend
    solve(graph, sampling=2, compact_every=2, sampling_strategy="kout")
    solve(graph, backend="cuda_async")          # in-order async sweeps

    # the paper's baselines: FastSV, label propagation, Rem's union-find
    solve(graph, algorithm="fastsv")
    solve(graph, algorithm="lp")
    solve(graph, algorithm="connectit")         # on the host

Out-of-core (edges stream from host memory; the card holds the O(n)
labels plus one chunk)::

    chunks = rmat_chunks(scale=26, edge_factor=16, chunk_edges=1 << 20)
    result = solve_chunks(chunks)       # never materialises all edges
"""
from repro_torch.connectivity.frontier import (
    SAMPLING_STRATEGIES,
    SamplingStrategy,
    register_sampling_strategy,
)
from repro_torch.connectivity.options import SolveOptions
from repro_torch.connectivity.result import ComponentResult
from repro_torch.connectivity.registry import (
    SolverSpec,
    get_solver,
    list_solvers,
    register_solver,
    solver_specs,
)
from repro_torch.connectivity import solvers as _solvers  # registers them
from repro_torch.connectivity.solve import solve
from repro_torch.connectivity.streaming import StreamingConnectivity
from repro_torch.connectivity.oocore import OutOfCoreContraction, solve_chunks
from repro_torch.connectivity.resilience import (
    RecoveryStats,
    oocore_with_recovery,
    stream_with_recovery,
)
from repro_torch.connectivity.contour import VARIANTS
from repro_torch.graphs.structs import Graph
from repro_torch.runtime.recovery import (FaultInjector, ShardLossFault,
                                          SimulatedFault)

__all__ = [
    "ComponentResult",
    "FaultInjector",
    "Graph",
    "OutOfCoreContraction",
    "RecoveryStats",
    "SAMPLING_STRATEGIES",
    "SamplingStrategy",
    "ShardLossFault",
    "SimulatedFault",
    "SolveOptions",
    "SolverSpec",
    "StreamingConnectivity",
    "VARIANTS",
    "get_solver",
    "list_solvers",
    "oocore_with_recovery",
    "register_sampling_strategy",
    "register_solver",
    "solve",
    "solve_chunks",
    "solver_specs",
    "stream_with_recovery",
]
