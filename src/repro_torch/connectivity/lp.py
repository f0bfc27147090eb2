"""Label-propagation baseline (paper §I, §V).

The port's counterpart of ``repro.connectivity.lp``.  Classic min-label
propagation: every vertex repeatedly takes the minimum label among itself
and its neighbours, the special case of Contour with a one-order
synchronous operator; it converges in O(diameter) iterations, the method
Contour's log-convergence is measured against.

An iteration is ``Lu = L.at[src].min(L[dst]).at[dst].min(L[src])``: both
scatters read the input ``L`` and combine by minimum, so it is one
scatter-min over the concatenated stream, one launch of the scatter-min
kernel (``blocked.scatter_min``) on the card.  The loop is Contour's
(``converged.device_loop``), with the no-change test
``converged.labels_unchanged`` doing the loop's step.  Past the fixed
point an iteration is an exact no-op (a function of ``L`` alone), so
nothing needs freezing; the sweep skips its pass once ``done`` is set.

``init_labels`` warm-starts from a previous solve's labels (propagation is
min-only, so labels fall monotonically from any valid start).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.connectivity import minmap as lab
from repro_torch.kernels.contour_mm import converged as cv
from repro_torch.kernels.contour_mm.blocked import scatter_min


def label_propagation_labels(src: torch.Tensor, dst: torch.Tensor,
                             n_vertices: int,
                             init_labels: Optional[torch.Tensor] = None,
                             max_iters: int = 100_000):
    """Run label propagation; returns (labels[n], n_iterations,
    converged), the last two 0-d tensors on the device of ``src``."""
    targets = torch.cat([src, dst])
    sources = torch.cat([dst, src])
    state = cv.loop_state(src.device)
    done = cv.done_word(state)

    def body(it, L):
        Lu = scatter_min(L, targets, L[sources], check=False, done=done)
        cv.labels_unchanged(Lu, L, state=state)
        return Lu

    L = cv.device_loop(
        body, lab.resolve_init_labels(init_labels, n_vertices, src.device,
                                      src.dtype), state, max_iters)
    it, converged = cv.loop_result(state)
    return L, it, converged


def label_propagation(graph, max_iters: int = 100_000):
    return label_propagation_labels(graph.src, graph.dst, graph.n_vertices,
                                    max_iters=max_iters)
