"""Registered solver families of the port.

The port registers ``contour`` (paper §III-B, all variants) on the
dense schedule and on both realisations of the work-adaptive frontier,
with the reference's variants and iteration budget.  The other families
of ``repro.connectivity.solvers`` come with later slices.
"""
from __future__ import annotations

from repro_torch.connectivity import contour as _contour
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


CONTOUR = register_solver(SolverSpec(
    name="contour",
    fn=_contour_solver,
    variants=_contour.VARIANTS + ("C-<h>",),
    default_variant="C-2",
    default_max_iters=100_000,
    paper_ref="§III-B (Alg. 1, variants §III-B4)",
))
