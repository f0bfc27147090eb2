"""Minimum-mapping operators (paper §II-B) as plain torch functions.

The port's counterpart of ``repro.connectivity.minmap``.  The paper's
h-order minimum-mapping operator ``MM^h(L_u, L, w, v)``:

    z^h = min(L^h[w], L^h[v])           (L^h = h-fold composition of L)
    conditionally assign z^h into L_u at positions
    {w, v, L[w], L[v], ..., L^{h-1}[w], L^{h-1}[v]}

The conditional assignment is a scatter-min (``scatter_reduce`` with
``"amin"``): ``min`` is associative and commutative, so any combine order
reaches the identical result, bit for bit, per sweep.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import trace


def gather_chain(L: torch.Tensor, idx: torch.Tensor, order: int
                 ) -> Tuple[torch.Tensor, ...]:
    """Return (L^1[idx], ..., L^order[idx])."""
    out = []
    cur = L[idx]
    out.append(cur)
    for _ in range(order - 1):
        cur = L[cur]
        out.append(cur)
    return tuple(out)


def mm_update_stream(
    L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, order: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather phase of ``MM^order``: the ``(targets, values)`` update stream.

    ``values`` is ``z = min(L^order[src], L^order[dst])`` per edge, tiled;
    ``targets`` are the conditional-assignment positions, laid out as
    ``[src, dst, L[src], L[dst], L^2[src], L^2[dst], ...]`` — ``2·order``
    segments of length ``m``.  A per-edge mask therefore extends to the
    stream by tiling it ``2·order`` times (``ops.mm_relax_backend``).
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    chain_s = gather_chain(L, src, order)  # L[src], L^2[src], ...
    chain_d = gather_chain(L, dst, order)
    z = torch.minimum(chain_s[-1], chain_d[-1])
    targets = [src, dst]
    for k in range(order - 1):
        targets.append(chain_s[k])
        targets.append(chain_d[k])
    return torch.cat(targets), z.repeat(len(targets))


def mm_relax(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
             order: int) -> torch.Tensor:
    """One synchronous sweep of ``MM^order`` over every edge.

    All reads see the input ``L`` and all conditional assignments combine
    by minimum, exactly Alg. 1 lines 6-9 (``L_u`` initialised to ``L``,
    then ``L = L_u``).
    """
    idx, vals = mm_update_stream(L, src, dst, order)
    return L.scatter_reduce(0, idx.long(), vals, "amin", include_self=True)


def pointer_jump(L: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    """``L <- min(L, L[L])`` repeated; halves pointer-tree height per round."""
    for _ in range(rounds):
        L = torch.minimum(L, L[L])
    return L


def converged_early(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
                    ) -> torch.Tensor:
    """Paper §III-B2 early-convergence predicate (a 0-d bool tensor).

    Converged iff for every edge (w, v):
        L[w] == L[v]  and  L[w] == L^2[w]  and  L[v] == L^2[v].
    """
    lw, lv = L[src], L[dst]
    bad = (lw != lv) | (lw != L[lw]) | (lv != L[lv])
    return ~torch.any(bad)


def is_star_forest(L: torch.Tensor) -> torch.Tensor:
    """True iff the pointer graph is a forest of stars (L[L] == L)."""
    return torch.all(L[L] == L)


def check_labels_nonnegative(labels: torch.Tensor) -> None:
    """Eagerly reject negative labels (mirrors ``Graph.add_edges``).

    A negative label would index the label array from its tail on the
    plain path and out of bounds in the CUDA kernels.
    """
    if labels.numel():
        with trace.span("read.warm_start_min"):
            lo = int(labels.min())
        if lo < 0:
            raise ValueError(
                f"warm-start labels must be >= 0, got minimum {lo}; "
                "negative ids would index the wrong vertices and "
                "silently merge the wrong components")


def resolve_init_labels(init, n_vertices: int, device: torch.device,
                        dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Initial label array for a (possibly warm-started) solve.

    ``None`` gives the identity labelling of Alg. 1 line 2.  A warm start
    passes the converged labels of a previous solve: any labelling with
    ``L[v]`` in the same component as ``v`` has the same fixed point, and
    min-mapping labels only ever decrease.

    * a shorter array (the graph grew vertices since the previous solve)
      is extended with identity labels for the new vertices;
    * the result is clamped to ``min(init, iota)`` so the identity
      invariant ``L[v] <= v`` holds from iteration 0 (the CUDA sweep
      kernels' ``edge_limit`` relies on it);
    * negative labels are rejected (:func:`check_labels_nonnegative`).
    """
    iota = torch.arange(n_vertices, dtype=dtype, device=device)
    if init is None:
        return iota
    init = torch.as_tensor(init).to(device=device, dtype=dtype)
    check_labels_nonnegative(init)
    if init.shape[0] > n_vertices:
        raise ValueError(
            f"warm-start labels cover {init.shape[0]} vertices but the "
            f"graph has only {n_vertices}")
    if init.shape[0] < n_vertices:
        init = torch.cat([init, iota[init.shape[0]:]])
    return torch.minimum(init, iota)
