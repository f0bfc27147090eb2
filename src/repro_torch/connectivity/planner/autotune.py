"""The measuring autotuner: time candidate plans, cache the winner.

The port's counterpart of ``repro.connectivity.planner.autotune``:

* :func:`candidate_plans` enumerates a bounded set of plans for a graph
  size: the heuristic table's plan first, then the ``masked`` and
  ``staged`` frontier realisations, then the heuristic plan with order-2
  sweeps on ``scatter_min`` instead of the fused kernel (``fuse_relabel``
  off).
  ``cuda_async`` is never a candidate, as ``auto`` never picks it;
* :func:`autotune` times each candidate on the caller's graph (best-of-k
  wall clock through the real ``solve``, with ``torch.cuda.synchronize``
  inside the timed window on the card) and stores the winner in the
  tuning cache (``planner.cache``);
* **hysteresis**: a candidate other than the heuristic plan is kept only
  when it beats it by more than ``margin`` (default 5%), so a near-tie
  resolves to the table.

Tuning never happens on its own: ``solve()`` only reads the cache.
Timing is injectable (``measure=``), so the decision is testable without
the wall clock.  The reference's ``record_kernel_failure`` (a TTL'd
demotion after a kernel-launch failure) is not ported: the port has no
kernel fallback.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.connectivity.planner import cache as _cache
from repro_torch.connectivity.planner.heuristics import heuristic_plan
from repro_torch.connectivity.planner.plan import ExecutionPlan


def plan_label(plan: ExecutionPlan) -> str:
    """Short human key for timing tables."""
    return (f"{plan.backend}/{plan.compact_schedule}"
            f"{'/fused' if plan.fuse_relabel else ''}")


def candidate_plans(n_vertices: int, m_edges: int,
                    device="cuda") -> List[ExecutionPlan]:
    """Bounded candidate set; the heuristic plan is always first."""
    base = heuristic_plan(n_vertices, m_edges, device)
    cands = [base]

    def add(p: ExecutionPlan):
        if not any(p.config_equal(c) for c in cands):
            cands.append(p)

    for schedule in ("masked", "staged"):
        add(base.replace(compact_schedule=schedule))
    add(base.replace(fuse_relabel=False))
    return cands


def _measure_solve(graph, plan: ExecutionPlan, opts,
                   repeats: int = 3) -> float:
    """Best-of-k wall clock of ``solve`` under a pinned plan, the card
    synchronised inside the timed window."""
    from repro_torch.connectivity.solve import solve  # lazy: import cycle

    pinned = opts.replace(plan=plan.replace(origin="pinned"),
                          backend=plan.backend)
    on_card = graph.device.type == "cuda"

    def run():
        solve(graph, pinned)
        if on_card:
            torch.cuda.synchronize(graph.device)

    run()                                   # warm-up: builds, caches
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def autotune(
    graph,
    opts=None,
    *,
    repeats: int = 3,
    margin: float = 0.05,
    measure: Optional[Callable] = None,
    cache_path: Optional[str] = None,
    write: bool = True,
) -> Tuple[ExecutionPlan, Dict[str, float]]:
    """Measure candidates on ``graph``; cache and return the winner.

    Returns ``(plan, timings)``: ``plan`` has ``origin="tuned"`` and
    ``timings`` maps :func:`plan_label` to best-of-k seconds.  ``measure``
    replaces the timing (``measure(graph, plan, opts) -> seconds``);
    ``write=False`` skips the cache write.  The plan is keyed by the
    graph's device type and size buckets.
    """
    from repro_torch.connectivity.options import SolveOptions  # lazy

    if opts is None:
        # the workload tuning certifies: the work-adaptive schedule
        # (where masked against staged matters) on the default variant
        opts = SolveOptions(sampling=2, compact_every=2)
    if measure is None:
        measure = lambda g, p, o: _measure_solve(g, p, o, repeats=repeats)

    n, m = graph.n_vertices, graph.n_edges
    device = graph.device.type
    cands = candidate_plans(n, m, device)
    timings: Dict[str, float] = {}
    best_plan, best_t = None, float("inf")
    for p in cands:
        t = float(measure(graph, p, opts))
        timings[plan_label(p)] = t
        if t < best_t:
            best_plan, best_t = p, t
    heur = cands[0]
    heur_t = timings[plan_label(heur)]
    # hysteresis: keep a plan other than the table's only on a clear win
    if not best_plan.config_equal(heur) and best_t >= heur_t * (1 - margin):
        best_plan, best_t = heur, heur_t
    tuned = best_plan.replace(origin="tuned")
    if write:
        _cache.store(n, m, device, tuned, time_s=best_t, timings=timings,
                     path=cache_path)
    return tuned, timings
