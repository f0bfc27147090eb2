"""FastSV baseline (Zhang, Azad & Hu, SIAM PP 2020), paper §III-C.

The port's counterpart of ``repro.connectivity.fastsv``.  FastSV iterates
three scatter-min phases over a parent array ``f`` with a grandparent
shortcut ``gf = f[f]``:

  1. *stochastic hooking*:  f_next[f[u]] <- min(f_next[f[u]], gf[v])
  2. *aggressive hooking*:  f_next[u]    <- min(f_next[u],    gf[v])
  3. *shortcutting*:        f_next[u]    <- min(f_next[u],    gf[u])

over both edge directions, until the grandparent array stops changing.
Both hookings go through the scatter-min kernel that carries Contour's
order-1 sweeps (``blocked.scatter_min``), as the reference uses one
scatter-min primitive for both families, so that a comparison of the two
isolates the algorithm.

The loop is Contour's (``converged.device_loop``): the state words on the
device, the no-change test ``converged.labels_unchanged`` doing the
loop's step, one read of ``(done, it)`` per ``converged.CHUNK``
iterations.  Past the fixed point FastSV's state is not provably frozen
(``f`` may still fall where ``gf`` no longer does), so an iteration that
finds ``done`` set keeps its input ``(f, gf)``: two ``torch.where`` over
n that read the word on the device.

``init_labels`` warm-starts the parent array from a previous solve's
labels: hooking is min-only, so parents fall monotonically from any valid
start (``minmap.resolve_init_labels``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.connectivity import minmap as lab
from repro_torch.kernels.contour_mm import converged as cv
from repro_torch.kernels.contour_mm.blocked import scatter_min


def iteration(f: torch.Tensor, gf: torch.Tensor, u: torch.Tensor,
              v: torch.Tensor, done=None):
    """One FastSV iteration from ``(f, gf)`` over the edge stream ``(u,
    v)``: the new ``(f, gf)``.  ``done`` is the loop's word, which the
    scatter-mins take."""
    gv = gf[v]
    # (1) stochastic hooking, (2) aggressive hooking, (3) shortcutting
    fn = scatter_min(f, f[u], gv, check=False, done=done)
    fn = scatter_min(fn, u, gv, check=False, done=done)
    fn = torch.minimum(fn, gf)
    return fn, fn[fn]


def freeze(done: torch.Tensor, old, new):
    """``old`` where the loop's done word is set, else ``new``, pair by
    pair: a ``torch.where`` over each, which reads the word on the
    device."""
    keep = done.bool()
    return tuple(torch.where(keep, a, b) for a, b in zip(old, new))


def fastsv_labels(src: torch.Tensor, dst: torch.Tensor, n_vertices: int,
                  init_labels: Optional[torch.Tensor] = None,
                  max_iters: int = 256):
    """Run FastSV; returns (labels[n], n_iterations, converged), the last
    two 0-d tensors on the device of ``src`` (int32, bool)."""
    u = torch.cat([src, dst])
    v = torch.cat([dst, src])
    f = lab.resolve_init_labels(init_labels, n_vertices, src.device,
                                src.dtype)
    state = cv.loop_state(src.device)
    done = cv.done_word(state)

    def body(it, carry):
        f_next, gf_next = freeze(done, carry, iteration(*carry, u, v, done))
        cv.labels_unchanged(gf_next, carry[1], state=state)
        return f_next, gf_next

    _, gf = cv.device_loop(body, (f, f[f]), state, max_iters)
    it, converged = cv.loop_result(state)
    # the converged gf is a star forest rooted at the component minima
    return gf, it, converged


def fastsv(graph, max_iters: int = 256):
    return fastsv_labels(graph.src, graph.dst, graph.n_vertices,
                         max_iters=max_iters)
