"""Registered solver families of the port.

This slice registers ``contour`` (paper §III-B, all variants) on the
dense schedule, with the reference's variants and iteration budget.  The
other families of ``repro.connectivity.solvers`` come with later slices.
"""
from __future__ import annotations

from repro_torch.connectivity import contour as _contour
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


def _contour_solver(graph, opts, init_labels):
    plan = resolve_plan(graph, opts)
    out = _contour.contour_labels(
        graph.src, graph.dst, graph.n_vertices, init_labels,
        variant=opts.variant or "C-2",
        max_iters=opts.max_iters,
        warmup=opts.warmup,
        async_compress=opts.async_compress,
        backend=plan.backend,
        sampling=opts.sampling,
        compact_every=opts.compact_every,
        fuse=plan.fuse_relabel,
    )
    return (*out, (plan.provenance_entry(),))


CONTOUR = register_solver(SolverSpec(
    name="contour",
    fn=_contour_solver,
    variants=_contour.VARIANTS + ("C-<h>",),
    default_variant="C-2",
    default_max_iters=100_000,
    paper_ref="§III-B (Alg. 1, variants §III-B4)",
))
