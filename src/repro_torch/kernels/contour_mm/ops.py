"""Backend dispatch for the min-mapping sweep, and the dense fixpoint.

The port's counterpart of ``repro.kernels.contour_mm.ops``.  Two backends
realise the same ``MM^h`` sweep, bit for bit:

* ``"torch"`` — ``minmap.mm_relax``, plain torch scatter-min (the
  reference's ``"xla"``);
* ``"cuda"``  — the hand-written kernels of ``blocked.py`` (the
  reference's ``"pallas_blocked"``): order 2 runs ``fused_relax`` at any
  ``n``, every other order runs ``mm_update_stream`` + ``scatter_min``.

``"auto"`` is ``"cuda"``.  On the card it always launches the kernels; on
CPU tensors the kernel wrappers run their plain versions.  The
reference's scalar ``"pallas"`` backend (``mm2_pallas``) has no
counterpart yet.

:func:`contour_cc_fixpoint` is ``contour.contour_labels`` with the
literal ``C-<order>`` variant: a host loop with one device-to-host read
of the convergence flag per iteration (the reference keeps the flag on
the device inside a ``lax.while_loop``).
"""
from __future__ import annotations

import torch

from repro_torch.connectivity import minmap as lab
from repro_torch.connectivity.planner.plan import BACKENDS
from repro_torch.graphs.structs import Graph
from repro_torch.kernels.contour_mm.blocked import fused_relax, scatter_min

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
) -> torch.Tensor:
    """One ``MM^order`` sweep on the chosen backend; returns new labels.

    ``edge_limit`` (an int or 0-d tensor) is the frontier bound: only the
    first ``edge_limit`` edges contribute updates.  The ``torch`` backend
    masks the rest to ``(0, 0)`` self-loops as the reference does;
    ``fused_relax`` skips them; the scatter-min route marks their updates
    invalid.  ``fuse=False`` sends an order-2 sweep through the
    scatter-min kernel instead of the fused one.

    The kernels are launched with ``check=False``: the graph's endpoints
    were checked when the ``Graph`` was built, and a sweep keeps labels in
    ``[0, n)``, so the launch need not wait for its range flag.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    m = int(src.shape[0])
    edge_mask = None
    if edge_limit is not None:
        edge_mask = torch.arange(m, dtype=torch.int32,
                                 device=src.device) < edge_limit

    if backend == "torch":
        if edge_mask is not None:
            # self-loops at vertex 0 are min-mapping no-ops
            src = torch.where(edge_mask, src, 0)
            dst = torch.where(edge_mask, dst, 0)
        return lab.mm_relax(L, src, dst, order)
    # cuda ("auto" is cuda)
    if fuse and order == 2:
        return fused_relax(L, src, dst, edge_limit=edge_limit, check=False)
    t, v = lab.mm_update_stream(L, src, dst, order)
    # the stream is 2*order concatenated [m] segments, each inheriting the
    # per-edge liveness
    valid = None if edge_mask is None else edge_mask.repeat(2 * order)
    return scatter_min(L, t, v, valid=valid, check=False)


def edges_visited(it: int, m: int, device) -> torch.Tensor:
    """The dense schedule's work counter: float32 ``it`` times ``m``.

    A float32 multiply, as the reference's ``it.astype(float32) * m``: it
    rounds differently from an exact integer product cast afterwards once
    ``it * m`` passes ``2**24``.
    """
    return torch.tensor(it, dtype=torch.float32, device=device) * m


def require_dense_schedule(sampling: int, compact_every: int) -> None:
    """Reject the frontier schedule, which this slice does not port."""
    if sampling < 0 or compact_every < 0:
        raise ValueError("sampling and compact_every must be >= 0, got "
                         f"{sampling} / {compact_every}")
    if sampling > 0 or compact_every > 0:
        raise NotImplementedError(
            "the work-adaptive frontier schedule (sampling/compact_every) "
            "comes with the port's frontier slice; use the dense schedule")


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
