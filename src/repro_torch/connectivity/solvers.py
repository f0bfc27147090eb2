"""Registered solver families of the port.

Five families of ``repro.connectivity.solvers``, one signature, with the
reference's variants, iteration budgets and capability flags:

* ``contour``           — paper §III-B, all variants (Alg. 1 + §III-B4),
  on the dense schedule and on both realisations of the work-adaptive
  frontier;
* ``fastsv``            — paper §III-C, the Shiloach-Vishkin family
  (Zhang, Azad & Hu);
* ``label_propagation`` — paper §I/§V, the traversal-family baseline;
* ``union_find``        — paper §III-C, the ConnectIt stand-in (Rem's
  union-find with splicing, on the host);
* ``oocore``            — out-of-core multi-round contraction
  (``connectivity.oocore``): the edges stream from host memory chunk by
  chunk, so the problem's size is not bounded by device memory.

The reference's ``distributed`` and ``auto`` come with later slices.
"""
from __future__ import annotations

from repro_torch.connectivity import contour as _contour
from repro_torch.connectivity import fastsv as _fastsv
from repro_torch.connectivity import lp as _lp
from repro_torch.connectivity import unionfind as _unionfind
from repro_torch.connectivity.planner import staged as _staged
from repro_torch.connectivity.planner.heuristics import (
    heuristic_plan, oocore_chunk_bucket)
from repro_torch.connectivity.registry import SolverSpec, register_solver
from repro_torch.graphs.generators import ArrayChunks

# Registry names that resolve to the out-of-core solver (and therefore
# need ExecutionPlan.chunk_bucket stamped at plan resolution).
_OOCORE_NAMES = ("oocore", "out_of_core")


def resolve_backend_plan(n_vertices: int, n_edges: int, device, opts):
    """The plan a solve of this size on ``device`` runs under.

    ``backend="auto"`` takes the heuristic table's plan; an explicit
    backend is substituted into it, so the plan recorded in provenance is
    the one that ran.  For the out-of-core solver the plan also carries
    the streaming chunk bucket (``chunk_bucket``).
    """
    plan = heuristic_plan(n_vertices, n_edges, device)
    if opts.backend != "auto":
        plan = plan.replace(backend=opts.backend, origin="pinned")
    if opts.algorithm in _OOCORE_NAMES:
        plan = plan.replace(chunk_bucket=oocore_chunk_bucket(
            n_edges, requested=opts.oocore_chunk_edges))
    return plan


def resolve_plan(graph, opts):
    """The plan a solve on ``graph``'s device runs under."""
    return resolve_backend_plan(graph.n_vertices, graph.n_edges,
                                graph.device, opts)


def _sampling_provenance(opts):
    """The provenance entry naming the sampling strategy in effect."""
    if opts.sampling <= 0:
        return ()
    return (f"sampling_strategy:{opts.sampling_strategy or 'prefix'}",)


def _contour_solver(graph, opts, init_labels):
    plan = resolve_plan(graph, opts)
    variant = opts.variant or "C-2"
    adaptive = opts.sampling > 0 or opts.compact_every > 0
    # the staged frontier slices the edge arrays between stages; C-Syn
    # takes no frontier and raises in contour_labels
    labels = (_staged.staged_adaptive_labels
              if (adaptive and variant != "C-Syn"
                  and plan.compact_schedule == "staged")
              else _contour.contour_labels)
    out = labels(
        graph.src, graph.dst, graph.n_vertices, init_labels,
        variant=variant,
        max_iters=opts.max_iters,
        warmup=opts.warmup,
        async_compress=opts.async_compress,
        backend=plan.backend,
        fuse=plan.fuse_relabel,
        sampling=opts.sampling,
        compact_every=opts.compact_every,
        sampling_strategy=opts.sampling_strategy or "prefix",
        sampling_k=opts.sampling_k,
    )
    return (*out, (plan.provenance_entry(), *_sampling_provenance(opts)))


def _fastsv_solver(graph, opts, init_labels):
    return _fastsv.fastsv_labels(graph.src, graph.dst, graph.n_vertices,
                                 init_labels, max_iters=opts.max_iters)


def _lp_solver(graph, opts, init_labels):
    return _lp.label_propagation_labels(graph.src, graph.dst,
                                        graph.n_vertices, init_labels,
                                        max_iters=opts.max_iters)


def _union_find_solver(graph, opts, init_labels):
    return _unionfind.rem_labels(graph.src, graph.dst, graph.n_vertices,
                                 init_labels=init_labels)


def _oocore_solver(graph, opts, init_labels):
    # oocore builds on streaming, which imports this module
    from repro_torch.connectivity import oocore as _oocore
    plan = resolve_plan(graph, opts)
    src, dst, n = graph.to_numpy()
    chunks = ArrayChunks(src, dst, n, plan.chunk_bucket)
    out = _oocore.oocore_labels(chunks, opts, init_labels=init_labels,
                                device=graph.device)
    return (*out[:4], (plan.provenance_entry(), *out[4]))


CONTOUR = register_solver(SolverSpec(
    name="contour",
    fn=_contour_solver,
    variants=_contour.VARIANTS + ("C-<h>",),
    default_variant="C-2",
    default_max_iters=100_000,
    supports_streaming=True,     # any async variant (C-Syn rejected)
    paper_ref="§III-B (Alg. 1, variants §III-B4)",
))

FASTSV = register_solver(SolverSpec(
    name="fastsv",
    fn=_fastsv_solver,
    default_max_iters=256,
    paper_ref="§III-C (FastSV / Shiloach-Vishkin family)",
))

LABEL_PROPAGATION = register_solver(SolverSpec(
    name="label_propagation",
    fn=_lp_solver,
    aliases=("lp",),
    default_max_iters=100_000,
    paper_ref="§I/§V (traversal-family baseline)",
))

UNION_FIND = register_solver(SolverSpec(
    name="union_find",
    fn=_union_find_solver,
    aliases=("connectit", "rem"),
    default_max_iters=1,
    supports_batch=False,        # host-side sequential loop
    runs_on="host",
    paper_ref="§III-C (ConnectIt stand-in: Rem's union-find)",
))

OOCORE = register_solver(SolverSpec(
    name="oocore",
    fn=_oocore_solver,
    aliases=("out_of_core",),
    variants=_contour.VARIANTS + ("C-<h>",),
    default_variant="C-2",
    default_max_iters=100_000,
    supports_batch=False,        # host-driven round loop
    paper_ref="§III-B streamed per Behnezhad et al. / ConnectIt "
              "multi-round contraction (DESIGN.md §15)",
))
