"""Registered solver families of the port.

Four families of ``repro.connectivity.solvers``, one signature, with the
reference's variants, iteration budgets and capability flags:

* ``contour``           — paper §III-B, all variants (Alg. 1 + §III-B4),
  on the dense schedule and on both realisations of the work-adaptive
  frontier;
* ``fastsv``            — paper §III-C, the Shiloach-Vishkin family
  (Zhang, Azad & Hu);
* ``label_propagation`` — paper §I/§V, the traversal-family baseline;
* ``union_find``        — paper §III-C, the ConnectIt stand-in (Rem's
  union-find with splicing, on the host).

The reference's ``distributed``, ``oocore`` and ``auto`` come with later
slices.
"""
from __future__ import annotations

from repro_torch.connectivity import contour as _contour
from repro_torch.connectivity import fastsv as _fastsv
from repro_torch.connectivity import lp as _lp
from repro_torch.connectivity import unionfind as _unionfind
from repro_torch.connectivity.planner import staged as _staged
from repro_torch.connectivity.planner.heuristics import heuristic_plan
from repro_torch.connectivity.registry import SolverSpec, register_solver


def resolve_plan(graph, opts):
    """The plan a solve on ``graph``'s device runs under.

    ``backend="auto"`` takes the heuristic table's plan; an explicit
    backend is substituted into it, so the plan recorded in provenance is
    the one that ran.
    """
    plan = heuristic_plan(graph.n_vertices, graph.n_edges, graph.device)
    if opts.backend != "auto":
        plan = plan.replace(backend=opts.backend, origin="pinned")
    return plan


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


CONTOUR = register_solver(SolverSpec(
    name="contour",
    fn=_contour_solver,
    variants=_contour.VARIANTS + ("C-<h>",),
    default_variant="C-2",
    default_max_iters=100_000,
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
