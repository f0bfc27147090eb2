"""Batched multi-graph solving: ``solve_batch`` over padded graphs.

The port's counterpart of ``repro.connectivity.batch``.  Fleets of small
graphs (per-shard dedup clusters, per-request subgraphs) are padded to one
shape: edge lists pad with ``(0, 0)`` self-loops (no-ops for every
min-based solver) and vertex counts with isolated vertices
(self-labelled singletons), so padding never changes a real vertex's
label.

The reference runs the fleet as one ``vmap``-ed program.  Here:

* **Dense Contour** (every variant, literal ``C-<h>`` included) on the
  ``cuda`` and ``torch`` backends runs as one fleet on the device
  (``contour.contour_labels_batched``): one sweep launch per iteration
  for every lane, each lane frozen at the iteration its own test passes,
  the host reading one fleet word pair per ``converged.CHUNK``
  iterations;
* **everything else** — the frontier schedule (any strategy), ``fastsv``,
  ``label_propagation``, ``backend="cuda_async"`` and ``auto``'s choice —
  runs lane by lane: each lane is a solo solve of its padded row
  (``Graph(src=batched.src[i], dst=batched.dst[i], n_vertices=max_n)``)
  under the fleet's plan with the masked frontier, which is what the
  reference's vmapped lane computes;
* ``union_find`` (a host loop) runs lane by lane over the original edge
  lists.

Either way every lane's labels, iterations, converged flag and
``edges_visited`` equal the reference's lane bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.connectivity import contour as _contour
from repro_torch.connectivity import minmap
from repro_torch.connectivity.options import SolveOptions
from repro_torch.connectivity.result import ComponentResult
from repro_torch.connectivity.solve import (_PLANNED_SOLVERS, _resolve,
                                            make_result, resolve_warm_start,
                                            solver_output)
from repro_torch.connectivity.registry import get_solver
from repro_torch.graphs.structs import DeviceLike, Graph, resolve_device

# backends whose dense loop runs as one fleet (the others run lane by lane)
_FLEET_BACKENDS = ("cuda", "torch")


def stack_graphs(graphs: Sequence[Graph], with_sizes: bool = False, *,
                 device: DeviceLike = None):
    """Pad ``graphs`` to a common shape and stack them into one batched
    Graph.

    The result has ``src``/``dst`` of shape ``[B, max_m]`` (``max_m`` at
    least 1) and ``n_vertices = max_n``; edge padding is self-loops at
    vertex 0.  ``with_sizes=True`` also returns the per-graph vertex
    counts (a tuple), for ``solve_batch(..., batch_sizes=sizes)``.  The
    graphs must share one device; ``device`` places an empty fleet
    (``cuda`` unless named), which stacks to a ``B=0`` graph with one
    padding vertex and one padding edge slot.
    """
    graphs = list(graphs)
    if not graphs:
        empty = torch.zeros((0, 1), dtype=torch.int32,
                            device=resolve_device(device))
        stacked = Graph(src=empty, dst=empty, n_vertices=1)
        return (stacked, ()) if with_sizes else stacked
    dev = graphs[0].device
    if any(g.device != dev for g in graphs):
        raise ValueError("the graphs of a batch must share one device")
    n = max(g.n_vertices for g in graphs)
    m = max(max(g.n_edges for g in graphs), 1)
    src = torch.zeros((len(graphs), m), dtype=torch.int32, device=dev)
    dst = torch.zeros((len(graphs), m), dtype=torch.int32, device=dev)
    for i, g in enumerate(graphs):
        src[i, :g.n_edges] = g.src
        dst[i, :g.n_edges] = g.dst
    stacked = Graph(src=src, dst=dst, n_vertices=n)
    if with_sizes:
        return stacked, tuple(g.n_vertices for g in graphs)
    return stacked


def _resolve_batch_sizes(batch_sizes, default, n: int):
    """Validate caller-provided per-graph vertex counts (or use default)."""
    if batch_sizes is None:
        return default
    sizes = tuple(int(s) for s in batch_sizes)
    if len(sizes) != len(default):
        raise ValueError(
            f"batch_sizes has {len(sizes)} entries for {len(default)} "
            "graphs")
    for i, s in enumerate(sizes):
        if not 1 <= s <= n:
            raise ValueError(
                f"batch_sizes[{i}] = {s} outside [1, {n}] (the padded "
                "vertex count)")
    return sizes


def _stack_warm_starts(warm_start, sizes: Sequence[int], n: int,
                       device: torch.device) -> Optional[torch.Tensor]:
    """Per-graph warm starts -> one ``[B, n]`` tensor (or None)."""
    if warm_start is None:
        return None
    if not isinstance(warm_start, (list, tuple)):
        ws = (warm_start.labels if isinstance(warm_start, ComponentResult)
              else warm_start)
        if not isinstance(ws, torch.Tensor):
            ws = torch.as_tensor(np.asarray(ws))
        if ws.dim() != 2 or ws.shape[0] != len(sizes):
            raise ValueError(
                f"batched warm_start must be a [B, n] array or a per-graph "
                f"sequence; got shape {tuple(ws.shape)} for B={len(sizes)}")
        # stacked rows are padded to the batch-wide max n; trim each back
        # to its graph (the padding region is identity labels anyway)
        warm_start = [ws[i, :min(int(ws.shape[1]), s)]
                      for i, s in enumerate(sizes)]
    if len(warm_start) != len(sizes):
        raise ValueError(
            f"warm_start has {len(warm_start)} entries for "
            f"{len(sizes)} graphs")
    rows = [minmap.resolve_init_labels(resolve_warm_start(w, s), n, device)
            for w, s in zip(warm_start, sizes)]
    return torch.stack(rows) if rows else None


def _lane_graph(batched: Graph, i: int, n: int) -> Graph:
    """Lane ``i``'s padded row as a graph of ``n`` vertices."""
    return Graph(src=batched.src[i], dst=batched.dst[i], n_vertices=n)


def _stack_outputs(outs: List[tuple]):
    """Per-lane solver outputs -> the batched 4-tuple."""
    labels = torch.stack([L for L, _, _, _ in outs])
    device = labels.device

    def col(k, dtype):
        return torch.stack([torch.as_tensor(o[k], device=device).to(dtype)
                            .reshape(()) for o in outs])

    evs = [ev for _, _, _, ev in outs]
    return (labels, col(1, torch.int32), col(2, torch.bool),
            None if any(ev is None for ev in evs)
            else col(3, torch.float32))


def solve_batch(
    graphs: Union[Sequence[Graph], Graph],
    options: Optional[SolveOptions] = None,
    *,
    warm_start=None,
    batch_sizes: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
    **overrides,
) -> ComponentResult:
    """Solve connectivity on a batch of graphs.

    Args:
      graphs: a sequence of :class:`Graph` (padded and stacked here) or an
        already-batched Graph with ``[B, m]`` edge arrays.
      options / overrides: as for :func:`repro_torch.connectivity.solve`.
      warm_start: per-graph previous labels — a sequence (tensors, arrays
        or :class:`ComponentResult`) or a stacked ``[B, n]`` array.
      batch_sizes: true per-graph vertex counts, for trimming the padding
        in ``unstack()``; needed for trimmed results from an
        already-batched Graph (``stack_graphs(..., with_sizes=True)``
        returns them).
      device: where an empty fleet's result lives (``cuda`` unless
        named); a fleet's solve runs on its graphs' device.

    Returns:
      a batched :class:`ComponentResult` (``labels [B, n]``,
      ``iterations [B]``, ``converged [B]``, ``edges_visited [B]``);
      ``unstack()`` splits it into per-graph results trimmed to each
      graph's vertex count.
    """
    opts, spec = _resolve(options, overrides)
    if opts.mesh is not None:
        raise ValueError("solve_batch is single-device (one fleet on one "
                         "device); it does not compose with "
                         "SolveOptions.mesh")
    if warm_start is None:
        warm_start = opts.warm_start  # same fallback as solve()

    if isinstance(graphs, Graph):
        batched = graphs
        if batched.src.dim() != 2:
            raise ValueError("an already-batched Graph has [B, m] edge "
                             "arrays; pass a sequence of graphs instead")
        n_graphs = int(batched.src.shape[0])
        sizes = _resolve_batch_sizes(
            batch_sizes, (batched.n_vertices,) * n_graphs,
            batched.n_vertices)
        originals: Optional[List[Graph]] = None
    else:
        originals = list(graphs)
        sizes = _resolve_batch_sizes(
            batch_sizes, tuple(g.n_vertices for g in originals),
            max((g.n_vertices for g in originals), default=1))
        batched = stack_graphs(originals, device=device)
    n = batched.n_vertices
    dev = batched.device
    n_graphs = int(batched.src.shape[0])

    if n_graphs == 0:
        # empty fleet: unstack() of the result is []; a mismatched
        # warm_start still raises instead of being ignored
        _stack_warm_starts(warm_start, sizes, n, dev)
        return make_result(torch.zeros((0, n), dtype=torch.int32,
                                       device=dev),
                           torch.zeros(0, dtype=torch.int32, device=dev),
                           torch.zeros(0, dtype=torch.bool, device=dev),
                           batch_sizes=())

    init_b = _stack_warm_starts(warm_start, sizes, n, dev)
    if init_b is not None and not spec.supports_warm_start:
        raise ValueError(f"solver {spec.name!r} does not support warm "
                         "starts")

    m = int(batched.src.shape[-1])
    provenance = None
    from repro_torch.connectivity.solvers import (auto_choice,
                                                  resolve_backend_plan)
    if spec.name == "auto":
        # the size-only model (no degree skew), as under the reference's
        # tracer; no provenance, as there
        _, opts = auto_choice(n, m, opts, None)
        spec = get_solver(opts.algorithm)
        opts = opts.replace(plan=resolve_backend_plan(
            n, m, dev, opts).replace(compact_schedule="masked"))
    elif spec.name in _PLANNED_SOLVERS:
        # one plan for the whole fleet, on the masked frontier (as the
        # reference's vmapped solver), recorded once
        plan = resolve_backend_plan(n, m, dev, opts).replace(
            compact_schedule="masked")
        opts = opts.replace(plan=plan)
        provenance = (plan.provenance_entry(),)

    dense = opts.sampling == 0 and opts.compact_every == 0
    if spec.supports_batch and spec.name == "contour" and dense \
            and opts.plan.backend in _FLEET_BACKENDS:
        out = _contour.contour_labels_batched(
            batched.src, batched.dst, n, init_b,
            variant=opts.variant or "C-2", max_iters=opts.max_iters,
            warmup=opts.warmup, async_compress=opts.async_compress,
            backend=opts.plan.backend, fuse=opts.plan.fuse_relabel)
    elif spec.supports_batch:
        out = _stack_outputs([
            solver_output(spec.fn(_lane_graph(batched, i, n), opts,
                                  None if init_b is None else init_b[i]))
            for i in range(n_graphs)])
    elif spec.runs_on == "host":
        # a sequential host solver: a plain loop over the original edge
        # lists (padding buys nothing here)
        lanes = (originals if originals is not None
                 else [_lane_graph(batched, i, n) for i in range(n_graphs)])
        out = _stack_outputs([
            solver_output(spec.fn(Graph(src=g.src, dst=g.dst, n_vertices=n),
                                  opts,
                                  None if init_b is None else init_b[i]))
            for i, g in enumerate(lanes)])
    else:
        raise ValueError(
            f"solver {spec.name!r} does not support batched solving")
    return make_result(*out, batch_sizes=sizes, provenance=provenance)
