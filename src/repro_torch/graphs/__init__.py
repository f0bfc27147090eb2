"""Graph substrate: edge-list structures, generators, oracles, statistics."""
from repro_torch.graphs.structs import Graph, build_csr, canonicalize_edges
from repro_torch.graphs import generators
from repro_torch.graphs.oracle import connected_components_oracle, rem_union_find
from repro_torch.graphs.stats import (approx_max_diameter, component_sizes,
                                      degree_stats)

__all__ = [
    "Graph",
    "canonicalize_edges",
    "build_csr",
    "generators",
    "connected_components_oracle",
    "rem_union_find",
    "component_sizes",
    "degree_stats",
    "approx_max_diameter",
]
