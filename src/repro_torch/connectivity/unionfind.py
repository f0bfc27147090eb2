"""ConnectIt stand-in: Rem's union-find with splicing (paper §III-C).

The port's counterpart of ``repro.connectivity.unionfind``.  Host-side by
design, as in the reference: Rem's algorithm is sequential pointer
chasing (``graphs.oracle.rem_union_find``, a Python loop of about a
microsecond an edge), registered so that all the families run through
one ``solve()`` signature.  The edges are copied to the host and the
labels back to the graph's device.

A warm start seeds the parent array with a previous solve's labels: Rem's
loop only ever rewrites parents to smaller values, so a star forest at
the old component minima is a valid, already compressed starting forest.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.graphs.oracle import rem_union_find


def rem_labels(src: torch.Tensor, dst: torch.Tensor, n_vertices: int,
               init_labels: Optional[torch.Tensor] = None):
    """Run Rem's union-find on the host; returns (labels, n_iterations,
    converged) on the device of ``src``.

    ``n_iterations`` is 1 by the paper's §IV-C convention (a union-find
    pass has no iteration structure to count); ``converged`` is always
    True: the pass is exact by construction.
    """
    parent0 = None if init_labels is None else init_labels.cpu().numpy()
    labels = rem_union_find(src.cpu().numpy(), dst.cpu().numpy(), n_vertices,
                            parent0=parent0)
    device = src.device
    return (torch.as_tensor(labels).to(device=device, dtype=src.dtype),
            torch.tensor(1, dtype=torch.int32, device=device),
            torch.tensor(True, device=device))


def rem(graph, init_labels: Optional[torch.Tensor] = None):
    return rem_labels(graph.src, graph.dst, graph.n_vertices,
                      init_labels=init_labels)


__all__ = ["rem_union_find", "rem_labels", "rem"]
