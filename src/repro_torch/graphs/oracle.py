"""Host-side connectivity oracles.

Two oracles:

* :func:`connected_components_oracle` — vectorised NumPy union-find used as
  ground truth in tests and to canonicalise labels (min vertex id per
  component, matching the Contour fixed point).
* :func:`rem_union_find` — a faithful Rem-style union-find with splicing,
  the algorithm ConnectIt found fastest on shared memory (paper §III-C).
  It is inherently sequential pointer-chasing, which is exactly why the
  paper positions it as the parallel-resource-starved baseline; we keep it
  host-side (see DESIGN.md §8.5) and use it both as oracle cross-check and
  as the ``ConnectIt`` stand-in for benchmark figures.
"""
from __future__ import annotations

import numpy as np


def _find_roots_vectorized(parent: np.ndarray) -> np.ndarray:
    """Resolve every vertex to its root by repeated pointer jumping."""
    roots = parent.copy()
    while True:
        nxt = roots[roots]
        if np.array_equal(nxt, roots):
            return roots
        roots = nxt


def connected_components_oracle(src, dst, n_vertices: int) -> np.ndarray:
    """Return min-vertex-id labels per component (NumPy, vectorised).

    Implementation: iterated hook-to-minimum + full pointer jumping — a
    dense variant of Shiloach-Vishkin that is simple enough to trust as an
    oracle (it is *not* the algorithm under test).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    parent = np.arange(n_vertices, dtype=np.int64)
    while True:
        ps, pd = parent[src], parent[dst]
        lo = np.minimum(ps, pd)
        hi = np.maximum(ps, pd)
        changed_edges = ps != pd
        if not changed_edges.any():
            break
        np.minimum.at(parent, hi, lo)
        parent = _find_roots_vectorized(parent)
    # roots are already component minima because we always hook max->min
    return parent


def rem_union_find(src, dst, n_vertices: int, parent0=None) -> np.ndarray:
    """Rem's union-find with splicing (ConnectIt's winner), sequential.

    Returns min-vertex-id labels per component.  The union loop follows
    Patwary et al.'s presentation: walk both vertices' parent chains,
    splicing the larger root under the smaller as we go.

    ``parent0`` warm-starts the parent forest from a previous solve's
    labels (may be shorter than ``n_vertices`` if the graph grew; clamped
    to the ``p[v] <= v`` invariant every union here preserves).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    p = np.arange(n_vertices, dtype=np.int64)
    if parent0 is not None:
        parent0 = np.asarray(parent0, dtype=np.int64)
        if parent0.shape[0] > n_vertices:
            raise ValueError(
                f"parent0 covers {parent0.shape[0]} vertices but the graph "
                f"has only {n_vertices}")
        k = parent0.shape[0]
        p[:k] = np.minimum(parent0, p[:k])
    for u, v in zip(src.tolist(), dst.tolist()):
        r_u, r_v = u, v
        while p[r_u] != p[r_v]:
            if p[r_u] > p[r_v]:
                if r_u == p[r_u]:  # root: hook under the smaller chain
                    p[r_u] = p[r_v]
                    break
                # splice: shortcut r_u to p[r_v] and climb
                z = p[r_u]
                p[r_u] = p[r_v]
                r_u = z
            else:
                if r_v == p[r_v]:
                    p[r_v] = p[r_u]
                    break
                z = p[r_v]
                p[r_v] = p[r_u]
                r_v = z
    roots = _find_roots_vectorized(p)
    # Rem roots are minima along parent chains (we always hook larger under
    # smaller), so roots are already the component minimum.
    return roots


def labels_equivalent(a: np.ndarray, b: np.ndarray) -> bool:
    """True iff two labelings induce the same partition."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        return False
    # map each a-label to the first b-label seen; must be a bijection
    order = np.argsort(a, kind="stable")
    a_s, b_s = a[order], b[order]
    # within runs of equal a, all b must be equal
    boundaries = np.flatnonzero(np.diff(a_s)) + 1
    groups_b = np.split(b_s, boundaries)
    reps = []
    for g in groups_b:
        if (g != g[0]).any():
            return False
        reps.append(g[0])
    reps = np.asarray(reps)
    return len(np.unique(reps)) == len(reps)
