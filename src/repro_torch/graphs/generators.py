"""Graph generators mirroring the paper's benchmark families (Table I).

The paper benchmarks real-world power-law graphs (SNAP/SuiteSparse) and
synthetic Delaunay triangulations.  Offline we generate statistically
matching families:

* ``path`` / ``cycle`` / ``star`` / ``caterpillar`` — extreme-diameter and
  extreme-degree stress shapes used by the convergence proofs (Lemma 1-3).
* ``grid2d`` — planar, bounded-degree, large-diameter: the stand-in for the
  paper's ``delaunay_n*`` family (Delaunay triangulations are planar with
  average degree < 6; an 8-neighbour grid matches that regime).
* ``rmat`` — power-law degree graphs standing in for the SNAP social
  networks (com-orkut, soc-LiveJournal1, ...).
* ``erdos_renyi`` — low-diameter uniformly random graphs.
* ``components_mix`` — disjoint unions, exercising multi-component
  convergence (Theorem 1 is in terms of the *max component* diameter).

Everything returns a canonicalised :class:`repro_torch.graphs.Graph`.

The port's copy of ``repro.graphs.generators``: the same numpy builders,
so the same seed gives the same edges, array for array.  Each takes
``device=`` (``None`` means ``cuda``, see ``structs.resolve_device``).
The chunked sources (``EdgeChunks`` and its kin) come with the
out-of-core slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.structs import DeviceLike, Graph, canonicalize_edges


def _finish(src, dst, n, device: DeviceLike, drop_self_loops=True) -> Graph:
    src, dst = canonicalize_edges(src, dst, n, drop_self_loops=drop_self_loops)
    return Graph.from_numpy(src, dst, n, device=device)


def path(n: int, seed: int = 0, shuffle_ids: bool = True,
         device: DeviceLike = None) -> Graph:
    """Path graph; with shuffled vertex ids (worst case for label spread)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n) if shuffle_ids else np.arange(n)
    return _finish(ids[:-1], ids[1:], n, device)


def cycle(n: int, seed: int = 0, shuffle_ids: bool = True,
          device: DeviceLike = None) -> Graph:
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n) if shuffle_ids else np.arange(n)
    src = ids
    dst = np.roll(ids, -1)
    return _finish(src, dst, n, device)


def star(n: int, seed: int = 0, device: DeviceLike = None) -> Graph:
    """Star: hub 0 connected to all others (diameter 2, max degree n-1)."""
    rng = np.random.default_rng(seed)
    hub = int(rng.integers(n))
    spokes = np.setdiff1d(np.arange(n), [hub])
    return _finish(np.full(n - 1, hub), spokes, n, device)


def caterpillar(spine: int, legs_per_node: int, seed: int = 0,
                device: DeviceLike = None) -> Graph:
    """Long spine with pendant legs: long diameter + high local fanout."""
    n = spine * (1 + legs_per_node)
    spine_ids = np.arange(spine)
    src = [spine_ids[:-1]]
    dst = [spine_ids[1:]]
    leg = spine
    for s in range(spine):
        for _ in range(legs_per_node):
            src.append(np.array([s]))
            dst.append(np.array([leg]))
            leg += 1
    return _finish(np.concatenate(src), np.concatenate(dst), n, device)


def grid2d(rows: int, cols: int, diagonals: bool = True, seed: int = 0,
           device: DeviceLike = None) -> Graph:
    """2-D grid, optionally with one diagonal per cell (Delaunay-like)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    src = [idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    dst = [idx[:, 1:].ravel(), idx[1:, :].ravel()]
    if diagonals:
        src.append(idx[:-1, :-1].ravel())
        dst.append(idx[1:, 1:].ravel())
    return _finish(np.concatenate(src), np.concatenate(dst), rows * cols,
                   device)


def delaunay_like(scale: int, seed: int = 0,
                  device: DeviceLike = None) -> Graph:
    """Stand-in for the paper's delaunay_n{scale}: 2^scale vertices on a grid."""
    n = 1 << scale
    rows = 1 << (scale // 2)
    cols = n // rows
    return grid2d(rows, cols, diagonals=True, seed=seed, device=device)


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         device: DeviceLike = None) -> Graph:
    """RMAT power-law generator (Graph500 parameters by default)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / ab if ab > 0 else 0.5
    c_norm = c / (1.0 - ab) if ab < 1 else 0.5
    for bit in range(scale):
        go_right_rows = rng.random(m) > ab  # choose bottom half of matrix
        p_col = np.where(go_right_rows, c_norm, a_norm)
        go_right_cols = rng.random(m) > p_col
        src |= go_right_rows.astype(np.int64) << bit
        dst |= go_right_cols.astype(np.int64) << bit
    # permute ids so degree isn't correlated with vertex id
    perm = rng.permutation(n)
    return _finish(perm[src], perm[dst], n, device)


def erdos_renyi(n: int, avg_degree: float = 8.0, seed: int = 0,
                device: DeviceLike = None) -> Graph:
    m = int(n * avg_degree / 2)
    rng = np.random.default_rng(seed)
    return _finish(rng.integers(0, n, m), rng.integers(0, n, m), n, device)


def random_tree(n: int, seed: int = 0, device: DeviceLike = None) -> Graph:
    """Uniform attachment tree: each vertex i>0 attaches to a random j<i."""
    rng = np.random.default_rng(seed)
    parents = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    perm = rng.permutation(n)
    return _finish(perm[np.arange(1, n)], perm[parents], n, device)


def components_mix(parts, seed: int = 0, device: DeviceLike = None) -> Graph:
    """Disjoint union of graphs (vertex ids offset), plus isolated vertices.

    Args:
      parts: list of Graph
    """
    rng = np.random.default_rng(seed)
    offset = 0
    srcs, dsts = [], []
    for g in parts:
        s, d, n = g.to_numpy()
        srcs.append(s.astype(np.int64) + offset)
        dsts.append(d.astype(np.int64) + offset)
        offset += n
    n_total = offset + int(rng.integers(0, 4))  # a few isolated vertices
    return _finish(np.concatenate(srcs), np.concatenate(dsts), n_total,
                   device)


def paper_suite(small: bool = True, device: DeviceLike = None):
    """The benchmark suite used by ``benchmarks/``: name -> Graph.

    ``small=True`` keeps the suite CPU-friendly; ``small=False`` scales up
    toward the paper's sizes (still bounded for a single host).
    """
    k = 1 if small else 4
    d = device
    suite = {
        "path_64k": path(65_536 * k, seed=1, device=d),
        "cycle_64k": cycle(65_536 * k, seed=2, device=d),
        "star_64k": star(65_536 * k, seed=3, device=d),
        "caterpillar_16k": caterpillar(16_384 * k, 3, seed=4, device=d),
        "grid_256x256": grid2d(256 * k, 256, diagonals=True, device=d),
        "delaunay_n16": delaunay_like(16 if small else 18, device=d),
        "delaunay_n18": delaunay_like(18 if small else 20, device=d),
        "rmat_16": rmat(16 if small else 18, edge_factor=8, seed=5, device=d),
        "rmat_18": rmat(18 if small else 20, edge_factor=8, seed=6, device=d),
        "er_100k": erdos_renyi(100_000 * k, avg_degree=8.0, seed=7, device=d),
        "tree_100k": random_tree(100_000 * k, seed=8, device=d),
        "mix_3comp": components_mix(
            [path(20_000, seed=9, device=d), rmat(14, seed=10, device=d),
             grid2d(128, 128, device=d)], seed=11, device=d
        ),
    }
    return suite
