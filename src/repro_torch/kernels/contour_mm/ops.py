"""Backend dispatch for the min-mapping sweep, and the dense fixpoint.

The port's counterpart of ``repro.kernels.contour_mm.ops``.  Three
backends realise the sweep:

* ``"torch"``      — ``minmap.mm_relax``, plain torch scatter-min (the
  reference's ``"xla"``);
* ``"cuda"``       — the hand-written kernels of ``blocked.py`` (the
  reference's ``"pallas_blocked"``): order 2 runs ``fused_relax`` at any
  ``n``, every other order runs ``mm_update_stream`` + ``scatter_min``.
  Bit for bit the synchronous ``MM^h`` sweep, as ``"torch"``;
* ``"cuda_async"`` — the in-order asynchronous 2-order sweep of
  ``kernel.py`` (``mm2``, the reference's scalar ``"pallas"``): each edge
  sees the labels earlier edges lowered, so the result depends on the
  edge order.  Order 2 only.

``"auto"`` is ``"cuda"``.  On the card the kernels always launch; on CPU
tensors the kernel wrappers run their plain versions.

:func:`contour_cc_fixpoint` is ``contour.contour_labels`` with the
literal ``C-<order>`` variant: its loop keeps the convergence flag and
the iteration count on the device, as the reference's ``lax.while_loop``
does, and the host reads them once per ``converged.CHUNK`` iterations.
"""
from __future__ import annotations

import torch

from repro_torch.connectivity import minmap as lab
from repro_torch.connectivity.planner.plan import BACKENDS
from repro_torch.graphs.structs import Graph
from repro_torch.kernels.contour_mm.blocked import (edge_count, fused_relax,
                                                    scatter_min)
from repro_torch.kernels.contour_mm.kernel import mm2

mm_update_stream = lab.mm_update_stream


def mm_relax_backend(
    L: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    *,
    order: int = 2,
    backend: str = "auto",
    edge_limit=None,
    fuse: bool = True,
    done=None,
) -> torch.Tensor:
    """One ``MM^order`` sweep on the chosen backend; returns new labels.

    ``edge_limit`` (an int or 0-d tensor) is the frontier bound: only the
    first ``edge_limit`` edges contribute updates.  The ``torch`` backend
    masks the rest to ``(0, 0)`` self-loops as the reference does;
    ``fused_relax`` and ``mm2`` do not visit them; the scatter-min route
    drops their updates.  ``fuse=False`` sends an order-2 ``cuda`` sweep
    through the scatter-min kernel instead of the fused one; it does not
    apply to ``cuda_async``, which is order 2 only.

    ``done`` is the dense fixpoint loop's flag word (``converged.py``):
    the kernels, and the plain versions they stand for on CPU tensors,
    return a copy of ``L`` once it is set.  The ``torch`` backend sweeps
    regardless: past the loop's early-convergence point a sweep changes
    nothing.

    The kernels are launched with ``check=False``: the graph's endpoints
    were checked when the ``Graph`` was built, and a sweep keeps labels in
    ``[0, n)``, so the launch need not wait for its range flag.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if backend == "cuda_async":
        if order != 2:
            raise ValueError(
                "the in-order 'cuda_async' kernel is 2-order only; use "
                "'cuda' or 'torch' for order != 2")
        return mm2(L, src, dst, edge_limit=edge_limit, check=False,
                   done=done)
    if backend == "torch":
        if edge_limit is not None:
            # self-loops at vertex 0 are min-mapping no-ops
            live = torch.arange(src.shape[0], dtype=torch.int32,
                                device=src.device) < edge_limit
            src = torch.where(live, src, 0)
            dst = torch.where(live, dst, 0)
        return lab.mm_relax(L, src, dst, order)
    # cuda ("auto" is cuda)
    if fuse and order == 2:
        return fused_relax(L, src, dst, edge_limit=edge_limit, check=False,
                           done=done)
    if edge_limit is not None:
        # the edges past the bound make no updates at all
        k = edge_count(int(src.shape[0]), edge_limit)
        src, dst = src[:k], dst[:k]
    t, v = lab.mm_update_stream(L, src, dst, order)
    return scatter_min(L, t, v, check=False, done=done)


def edges_visited(it, m: int, device) -> torch.Tensor:
    """The dense schedule's work counter: float32 ``it`` (an int or a 0-d
    tensor) times ``m``.

    A float32 multiply, as the reference's ``it.astype(float32) * m``: it
    rounds differently from an exact integer product cast afterwards once
    ``it * m`` passes ``2**24``.
    """
    return torch.as_tensor(it, device=device).to(torch.float32) * m


def contour_mm_step(
    src: torch.Tensor,
    dst: torch.Tensor,
    L: torch.Tensor,
    *,
    backend: str = "auto",
    order: int = 2,
    fuse: bool = True,
) -> torch.Tensor:
    """One MM sweep over all edges. Returns the updated label array."""
    return mm_relax_backend(L, src, dst, order=order, backend=backend,
                            fuse=fuse)


def contour_cc_fixpoint(
    graph: Graph,
    *,
    backend: str = "auto",
    order: int = 2,
    max_iters: int = 10_000,
    sampling: int = 0,
    compact_every: int = 0,
    fuse: bool = True,
):
    """Iterate the sweep to the connectivity fixed point (dense schedule).

    Returns (labels, n_iters, converged, edges_visited) as 0-d tensors
    beside the labels, like the reference: ``converged`` is False iff the
    ``max_iters`` budget ran out; ``edges_visited`` is the float32
    ``n_iters * m``.  Each iteration is one ``MM^order`` sweep, one
    pointer-jump round and the early-convergence test, which is Contour's
    literal ``C-<order>`` variant.
    """
    # contour imports this module for its sweeps
    from repro_torch.connectivity.contour import contour_labels

    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    return contour_labels(graph.src, graph.dst, graph.n_vertices,
                          variant=f"C-{order}", max_iters=max_iters,
                          backend=backend, sampling=sampling,
                          compact_every=compact_every, fuse=fuse)
