"""Graph statistics used by benchmarks and the convergence-bound tests."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.oracle import connected_components_oracle
from repro_torch.graphs.structs import build_csr


def component_sizes(src, dst, n_vertices: int) -> np.ndarray:
    labels = connected_components_oracle(src, dst, n_vertices)
    _, counts = np.unique(labels, return_counts=True)
    return np.sort(counts)[::-1]


def degree_stats(src, dst, n_vertices: int):
    deg = np.bincount(np.concatenate([src, dst]), minlength=n_vertices)
    return {
        "max_degree": int(deg.max()),
        "avg_degree": float(deg.mean()),
        "isolated": int((deg == 0).sum()),
    }


def degree_skew(src, dst, n_vertices: int) -> float:
    """Max-degree / mean-degree ratio — the cost model's skew feature.

    ~1 for regular graphs (paths, grids), large for hub-dominated
    families (stars, R-MAT).  0.0 for edgeless graphs (no degrees to
    compare), so degenerate inputs stay finite.
    """
    if n_vertices <= 0 or len(src) == 0:
        return 0.0
    deg = np.bincount(np.concatenate([np.asarray(src), np.asarray(dst)]),
                      minlength=n_vertices)
    mean = float(deg.mean())
    return float(deg.max()) / mean if mean > 0 else 0.0


def _bfs_ecc(row_ptr, col_idx, start: int, n: int) -> tuple[int, int]:
    """Eccentricity of ``start`` via NumPy frontier BFS; returns (ecc, far)."""
    dist = np.full(n, -1, dtype=np.int64)
    dist[start] = 0
    frontier = np.array([start], dtype=np.int64)
    d = 0
    far = start
    while frontier.size:
        # gather all neighbours of the frontier
        starts = row_ptr[frontier]
        ends = row_ptr[frontier + 1]
        total = int((ends - starts).sum())
        if total == 0:
            break
        out = np.concatenate([col_idx[s:e] for s, e in zip(starts, ends)])
        out = np.unique(out)
        nxt = out[dist[out] < 0]
        if nxt.size == 0:
            break
        d += 1
        dist[nxt] = d
        far = int(nxt[0])
        frontier = nxt
    return d, far


def approx_max_diameter(src, dst, n_vertices: int, sweeps: int = 2) -> int:
    """Double-sweep BFS lower bound on the max component diameter.

    Exact on trees/paths; a tight lower bound elsewhere — sufficient for
    validating the Theorem-1 iteration bound (which needs an upper bound on
    iterations given a diameter, so a lower-bound diameter makes the test
    conservative in the right direction when used as log argument check).
    """
    labels = connected_components_oracle(src, dst, n_vertices)
    row_ptr, col_idx = build_csr(np.asarray(src), np.asarray(dst), n_vertices)
    best = 0
    for comp in np.unique(labels):
        start = int(comp)  # min-id vertex of the component
        ecc, far = _bfs_ecc(row_ptr, col_idx, start, n_vertices)
        for _ in range(sweeps - 1):
            ecc, far = _bfs_ecc(row_ptr, col_idx, far, n_vertices)
        best = max(best, ecc)
    return best
