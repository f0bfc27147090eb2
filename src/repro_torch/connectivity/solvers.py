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
  chunk, so the problem's size is not bounded by device memory;
* ``auto``              — ConnectIt-style measured dispatch: the
  planner's cost model (``planner.resolve_strategy``) picks the solver
  family and sampling strategy per graph from its size and degree skew,
  and the choice lands in provenance.

The reference's ``distributed`` comes with a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.connectivity import contour as _contour
from repro_torch.connectivity import fastsv as _fastsv
from repro_torch.connectivity import lp as _lp
from repro_torch.connectivity import planner as _planner
from repro_torch.connectivity import unionfind as _unionfind
from repro_torch.connectivity.planner import staged as _staged
from repro_torch.connectivity.planner.heuristics import oocore_chunk_bucket
from repro_torch.connectivity.registry import (SolverSpec, get_solver,
                                               register_solver)
from repro_torch.graphs.generators import ArrayChunks

# Registry names that resolve to the out-of-core solver (and therefore
# need ExecutionPlan.chunk_bucket stamped at plan resolution).
_OOCORE_NAMES = ("oocore", "out_of_core")


def resolve_backend_plan(n_vertices: int, n_edges: int, device, opts):
    """The plan a solve of this size on ``device`` runs under.

    Resolution goes through :func:`planner.resolve_plan`: a plan pinned
    in ``opts.plan`` wins; otherwise ``backend="auto"`` consults the
    tuning cache and then the heuristic table, while an explicit backend
    takes the table with that backend substituted, so the plan recorded
    in provenance is the one that ran.  For the out-of-core solver the
    plan also carries the streaming chunk bucket (``chunk_bucket``),
    unless the pinned plan set one.
    """
    plan = _planner.resolve_plan(n_vertices, n_edges, backend=opts.backend,
                                 plan=opts.plan, device=device)
    if opts.algorithm in _OOCORE_NAMES and plan.chunk_bucket == 0:
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


def device_degree_skew(src, dst, n_vertices: int) -> float:
    """Max-degree / mean-degree ratio, computed where the edges lie.

    The degrees are two ``torch.bincount`` calls on the edges' device and
    their maximum is the one value read to the host; the mean degree is
    ``2m / n`` in float64, which is exactly numpy's mean of the integer
    degrees (their sum, 2m, is exact in float64), so the result equals
    ``graphs.stats.degree_skew`` bit for bit without copying the edges to
    the host.  0.0 for an edgeless graph or no vertices, as there.
    """
    m = int(src.shape[0])
    if n_vertices <= 0 or m == 0:
        return 0.0
    deg = (torch.bincount(src, minlength=n_vertices)
           + torch.bincount(dst, minlength=n_vertices))
    mean = 2.0 * m / n_vertices
    return float(int(deg.max())) / mean


def auto_choice(n_vertices: int, n_edges: int, opts, degree_skew):
    """The cost model's choice for a graph, and the options the chosen
    solver runs under: ``(StrategyChoice, delegate options)``.
    ``degree_skew=None`` is the size-only model ``solve_batch`` takes, as
    the reference's tracer does."""
    choice = _planner.resolve_strategy(
        n_vertices, n_edges, degree_skew=degree_skew,
        pinned_strategy=opts.sampling_strategy,
        pinned_variant=opts.variant)
    d_opts = opts.replace(
        algorithm=choice.solver,
        variant=choice.variant,
        sampling_strategy=choice.sampling_strategy,
        # explicit schedule knobs on the options win over the model's
        sampling=opts.sampling or choice.sampling,
        compact_every=opts.compact_every or choice.compact_every,
    )
    return choice, d_opts


def _auto_solver(graph, opts, init_labels):
    """Resolve (solver family, sampling strategy) with the cost model —
    pinned options > fitted artifact > heuristic table — and delegate;
    the choice and the delegate's provenance are returned."""
    skew = device_degree_skew(graph.src, graph.dst, graph.n_vertices)
    choice, d_opts = auto_choice(graph.n_vertices, graph.n_edges, opts,
                                 skew)
    out = tuple(get_solver(choice.solver).fn(graph, d_opts, init_labels))
    provenance = [choice.provenance_entry()]
    if len(out) > 4 and out[4]:
        provenance.extend(out[4])
    base = out[:4] if len(out) >= 4 else (*out[:3], None)
    return (*base, tuple(provenance))


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

AUTO = register_solver(SolverSpec(
    name="auto",
    fn=_auto_solver,
    variants=_contour.VARIANTS + ("C-<h>",),
    default_variant=None,        # the cost model picks unless pinned
    default_max_iters=100_000,
    supports_streaming=True,
    paper_ref="ConnectIt strategy-matrix dispatch (DESIGN.md §16)",
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
