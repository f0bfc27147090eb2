"""The port's work-adaptive frontier against the JAX package's, bit for bit.

Each function of ``repro_torch.connectivity.frontier`` is held against
its counterpart in ``repro.connectivity.frontier`` (ties included), the
staged driver against ``repro``'s ``planner.staged``, and ``solve`` with
``sampling``/``compact_every`` against ``repro.solve`` for every
sampling strategy on both realisations (masked below 2**15 edges, staged
from there on) and every backend: labels, iterations, converged and
edges_visited must be identical.  The ``cuda_async`` backend is held
against the reference's scalar ``pallas`` kernel in interpret mode,
through the drivers directly, on graphs small enough for interpret-mode
sweeps.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.connectivity import contour as ref_contour  # noqa: E402
from repro.connectivity import frontier as ref_fr  # noqa: E402
from repro.connectivity import minmap as ref_mm  # noqa: E402
from repro.connectivity.planner import heuristics as ref_heur  # noqa: E402
from repro.connectivity.planner import staged as ref_staged  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.oracle import connected_components_oracle  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.connectivity import (  # noqa: E402
    SAMPLING_STRATEGIES, SamplingStrategy, SolveOptions, contour,
    register_sampling_strategy)
from repro_torch.connectivity import frontier as fr  # noqa: E402
from repro_torch.connectivity.planner import heuristics, staged  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(ref_out, port_out):
    np.testing.assert_array_equal(port_out.numpy(), np.asarray(ref_out))


def _same_out(ref, port):
    """(labels, iterations, converged, visited) tuples, bit for bit."""
    _eq(ref[0], port[0])
    assert port[0].dtype == torch.int32
    assert int(port[1]) == int(ref[1])
    assert bool(port[2]) == bool(ref[2])
    assert port[3].dtype == torch.float32
    assert (port[3].numpy().view(np.uint32)
            == np.asarray(ref[3]).view(np.uint32))


def _same_result(ref, port):
    _same_out((ref.labels, ref.iterations, ref.converged, ref.edges_visited),
              (port.labels, port.iterations, port.converged,
               port.edges_visited))


def _rand_edges(n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, m).astype(np.int32),
            rng.integers(0, n, m).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _mid_run(name):
    """numpy (src, dst, n, L) with L one synchronous C-2 step from the
    identity: a state with some components merged and some not."""
    g = {"rmat10": lambda: ref_gen.rmat(10, seed=5),
         "grid": lambda: ref_gen.grid2d(24, 24),
         "mix": lambda: ref_gen.components_mix(
             [ref_gen.path(300, seed=1), ref_gen.star(200, seed=2),
              ref_gen.rmat(8, seed=3)], seed=4)}[name]()
    s, d, n = g.to_numpy()
    L = ref_mm.pointer_jump(
        ref_mm.mm_relax(jnp.arange(n, dtype=jnp.int32), g.src, g.dst, 2))
    return s, d, n, np.asarray(L)


# ---------------------------------------------------------------------------
# the frontier's functions, one by one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [0, 1, 3, 4, 7, 4096, 61_234_567])
def test_sample_prefix_m_matches_reference(m):
    assert fr.sample_prefix_m(m) == ref_fr.sample_prefix_m(m)


@pytest.mark.parametrize("m,p,seed", [(0, 0.5, 0), (1, 1.0, 1), (50, 0.0, 2),
                                      (50, 1.0, 3), (997, 0.3, 4),
                                      (4096, 0.7, 5)])
def test_stable_partition_matches_reference(m, p, seed):
    s, d = _rand_edges(64, m, seed)
    keep = np.random.default_rng(seed + 10).random(m) < p
    want = ref_fr.stable_partition(jnp.asarray(s), jnp.asarray(d),
                                   jnp.asarray(keep))
    got = fr.stable_partition(_t(s), _t(d), _t(keep))
    _eq(want[0], got[0])
    _eq(want[1], got[1])
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("m,values,seed", [(0, 5, 0), (1, 5, 1), (300, 3, 2),
                                           (2000, 40, 3), (2000, 2000, 4)])
def test_occurrence_rank_matches_reference(m, values, seed):
    """Many ties: the rank follows list order, which needs a stable sort."""
    x = np.random.default_rng(seed).integers(0, values, m).astype(np.int32)
    _eq(ref_fr._occurrence_rank(jnp.asarray(x)), fr._occurrence_rank(_t(x)))


SAMPLE_GRAPHS = {
    "rand_50_200": lambda: _rand_edges(50, 200, 0) + (50,),
    "rand_200_90": lambda: _rand_edges(200, 90, 1) + (200,),
    # every inner vertex has degree 6: the bfs seeds are chosen among ties
    "grid": lambda: ref_gen.grid2d(20, 30).to_numpy(),
    "star": lambda: ref_gen.star(300, seed=3).to_numpy(),
    "rmat10": lambda: ref_gen.rmat(10, seed=5).to_numpy(),
    "one_edge": lambda: (np.array([2], np.int32), np.array([1], np.int32), 4),
}


# only kout reads k
STRATEGY_K = [("prefix", 2), ("kout", 1), ("kout", 2), ("kout", 3),
              ("bfs", 2)]


@pytest.mark.parametrize("strategy,k", STRATEGY_K)
@pytest.mark.parametrize("gname", sorted(SAMPLE_GRAPHS))
def test_prepare_sampling_matches_reference(gname, strategy, k):
    s, d, n = SAMPLE_GRAPHS[gname]()
    want = ref_fr.prepare_sampling(strategy, jnp.asarray(s), jnp.asarray(d),
                                   n, k)
    got = fr.prepare_sampling(strategy, _t(s), _t(d), n, k)
    _eq(want[0], got[0])
    _eq(want[1], got[1])
    assert isinstance(got[2], int) and got[2] == int(want[2])


def test_sampling_strategy_names_and_errors_match_reference():
    assert SAMPLING_STRATEGIES == ref_fr.SAMPLING_STRATEGIES
    e = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown sampling_strategy"):
        fr.prepare_sampling("nope", e, e, 2)
    with pytest.raises(ValueError, match="k must be >= 1"):
        fr.prepare_sampling("kout", e, e, 2, 0)


@pytest.mark.parametrize("labels", [
    [0, 0, 0, 3, 3, 5],
    [3, 3, 1, 1, 0],           # a tie: the first maximum wins
    [4, 4, 2, 2, 2, 4, 0],     # a tie between labels past the first
    [6, 5, 4, 3, 2, 1, 0],     # every count 1
])
def test_largest_component_label_matches_reference(labels):
    L = np.asarray(labels, np.int32)
    n = len(labels)
    want = int(ref_fr.largest_component_label(jnp.asarray(L), n))
    got = fr.largest_component_label(_t(L), n)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want


@pytest.mark.parametrize("active", ["all", "half", "none"])
@pytest.mark.parametrize("only_largest", [False, True])
@pytest.mark.parametrize("gname", ["rmat10", "grid", "mix"])
def test_contract_edges_matches_reference(gname, only_largest, active):
    s, d, n, L = _mid_run(gname)
    am = {"all": len(s), "half": len(s) // 2, "none": 0}[active]
    c_ref = c_port = None
    if only_largest:
        c_ref = ref_fr.largest_component_label(jnp.asarray(L), n)
        c_port = fr.largest_component_label(_t(L), n)
    want = ref_fr.contract_edges(jnp.asarray(L), jnp.asarray(s),
                                 jnp.asarray(d), jnp.int32(am),
                                 only_label=c_ref)
    got = fr.contract_edges(_t(L), _t(s), _t(d), am, only_label=c_port)
    _eq(want[0], got[0])
    _eq(want[1], got[1])
    assert isinstance(got[2], int) and got[2] == int(want[2])
    assert got[2] <= am


@pytest.mark.parametrize("gname", ["rmat10", "grid", "mix"])
def test_masked_converged_early_matches_reference(gname):
    s, d, n, L = _mid_run(gname)
    fixed = connected_components_oracle(s, d, n)
    for labels in (L, fixed):
        for am in (0, 1, len(s) // 3, len(s)):
            want = ref_fr.masked_converged_early(
                jnp.asarray(labels), jnp.asarray(s), jnp.asarray(d),
                jnp.int32(am))
            got = fr.masked_converged_early(_t(labels), _t(s), _t(d), am)
            assert bool(got) == bool(want)


@pytest.mark.parametrize("sampling", [0, 1, 3])
def test_frontier_limit_matches_reference(sampling):
    for it in range(5):
        for active_m, sample_m in ((100, 25), (10, 25), (0, 1)):
            want = ref_fr.frontier_limit(jnp.int32(it), jnp.int32(active_m),
                                         jnp.int32(sample_m), sampling)
            assert fr.frontier_limit(it, active_m, sample_m,
                                     sampling) == int(want)


@pytest.mark.parametrize("sampling,compact_every", [(0, 2), (2, 2), (3, 1)])
def test_apply_compaction_matches_reference(sampling, compact_every):
    s, d, n, L = _mid_run("mix")
    am = (2 * len(s)) // 3
    for it1 in range(1, 6):
        want = ref_fr.apply_compaction(
            jnp.asarray(L), jnp.asarray(s), jnp.asarray(d), jnp.int32(am),
            jnp.int32(it1), sampling=sampling, compact_every=compact_every,
            n_vertices=n)
        got = fr.apply_compaction(_t(L), _t(s), _t(d), am, it1,
                                  sampling=sampling,
                                  compact_every=compact_every, n_vertices=n)
        _eq(want[0], got[0])
        _eq(want[1], got[1])
        assert got[2] == int(want[2])


def test_compress_full_matches_reference():
    rng = np.random.default_rng(0)
    # a random pointer forest with L[v] <= v: chains of every depth
    n = 3000
    L = np.minimum(np.arange(n), (rng.random(n) * np.arange(n)).astype(int))
    L = L.astype(np.int32)
    want = ref_fr.compress_full(jnp.asarray(L))
    _eq(want, fr.compress_full(_t(L)))
    _eq(want, fr.compress_full(fr.compress_full(_t(L))))


@pytest.mark.parametrize("owned", [False, True])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_compress_full_rounds_and_buffers(owned, backend):
    """The jump-and-no-change rounds make the labels and the number of
    flag reads of ``while not is_star_forest(L): L = jump(L)``; the
    caller's labels are left alone unless ``owned``, and with ``owned``
    the rounds allocate one label array at most."""
    from repro_torch.connectivity import minmap
    from repro_torch.kernels.contour_mm import converged as cv

    rng = np.random.default_rng(3)
    n = 2000
    L = np.minimum(np.arange(n), (rng.random(n) * np.arange(n)).astype(int))
    L0 = _t(L.astype(np.int32))
    want, star_reads = L0.clone(), 1
    while not bool(minmap.is_star_forest(want)):
        want = minmap.pointer_jump(want)
        star_reads += 1
    loop = cv.loop_ops(backend)
    calls = {"jump": 0, "test": 0, "new": 0}

    def jump(x, done=None, out=None):
        calls["jump"] += 1
        calls["new"] += out is None
        return loop.pointer_jump(x, done, out) if out is not None \
            else loop.pointer_jump(x, done)

    def test(a, b, **kw):
        calls["test"] += 1
        return loop.labels_unchanged(a, b, **kw)

    counted = cv.LoopOps(loop.converged_early, test, jump)
    given = L0.clone()
    got = fr.compress_full(given, counted, owned=owned)
    _eq(want, got)
    assert calls["test"] == star_reads == calls["jump"]
    if not owned:
        assert torch.equal(given, L0)
        assert calls["new"] == min(calls["jump"], 2)
    else:
        assert calls["new"] == 1


def test_frontier_loop_leaves_the_callers_labels():
    """The loop overwrites only labels it made itself: the caller's stay
    as they were, with C-m's eleven jump rounds an iteration too."""
    s, d, n = ref_gen.rmat(9, seed=4).to_numpy()
    src, dst = torch.tensor(s), torch.tensor(d)
    for variant in ("C-2", "C-m", "C-11mm"):
        L0 = torch.arange(n, dtype=torch.int32)
        L0[7:] -= 1   # a chain: not a star forest
        before = L0.clone()
        out = fr.adaptive_fixpoint(
            src, dst, L0, contour._make_step(variant, 2, 1, "cuda"),
            n_vertices=n, sampling=0, compact_every=1, max_iters=100)
        assert torch.equal(L0, before)
        assert out[0] is not L0
        ref = repro_torch.solve(interop.graph_from_arrays(s, d, n,
                                                          device="cpu"),
                                variant=variant, warm_start=before,
                                compact_every=1)
        _eq(np.asarray(ref.labels), out[0])


def test_pointer_jump_into_a_buffer():
    from repro_torch.kernels.contour_mm import converged as cv

    L = _t(np.array([0, 0, 1, 2, 3, 4], np.int32))
    for jump in (cv.pointer_jump, cv.pointer_jump_plain):
        out = torch.full_like(L, -1)
        got = jump(L, None, out=out)
        assert got is out
        _eq(np.array([0, 0, 0, 1, 2, 3]), got)
        with pytest.raises(ValueError, match="not be L"):
            jump(L, None, out=L)
        with pytest.raises(ValueError, match="shape"):
            jump(L, None, out=torch.empty(3, dtype=torch.int32))


def test_edges_visited_accumulates_in_float32():
    """Each sweep adds its bound to a float32 counter, as the reference's
    ``visited + limit.astype(float32)``: past 2**24 that differs from an
    integer sum rounded once at the end."""
    limits = [2 ** 24, 1, 1, 1, 2 ** 25 + 7]
    want = jnp.float32(0)
    for lim in limits:
        want = want + jnp.int32(lim).astype(jnp.float32)
    L = torch.arange(4, dtype=torch.int32)
    e = torch.zeros(1, dtype=torch.int32)
    s = fr.FrontierState(L=L, src=e, dst=e, active_m=1)
    for lim in limits:
        s.active_m, s.done = lim, False
        fr.advance(s, lambda L, it, src, dst, limit: L, sample_m=1,
                   sampling=0, compact_every=0, n_vertices=4, max_iters=99)
    assert np.float32(s.visited).view(np.uint32) == np.asarray(want).view(
        np.uint32)
    assert float(s.visited) != float(sum(limits))


# ---------------------------------------------------------------------------
# solve() with the frontier: every strategy x schedule x backend
# ---------------------------------------------------------------------------

# m < 2**15 runs masked, m >= 2**15 staged, in both packages
SCHEDULE_GRAPHS = {
    "masked": lambda: ref_gen.components_mix(
        [ref_gen.path(2000, seed=1), ref_gen.star(500, seed=2),
         ref_gen.rmat(10, seed=3), ref_gen.grid2d(30, 40)], seed=4),
    "staged": lambda: ref_gen.components_mix(
        [ref_gen.path(8000, seed=5), ref_gen.rmat(12, seed=6),
         ref_gen.grid2d(64, 64)], seed=7),
}


@functools.lru_cache(maxsize=None)
def _schedule_arrays(schedule):
    s, d, n = SCHEDULE_GRAPHS[schedule]().to_numpy()
    assert (len(s) >= heuristics.STAGED_MIN_EDGES) == (schedule == "staged")
    return s, d, n


@functools.lru_cache(maxsize=None)
def _ref_frontier_solve(schedule, strategy, variant="C-2", sampling=2,
                        compact_every=2):
    s, d, n = _schedule_arrays(schedule)
    return repro.solve(repro.Graph.from_numpy(s, d, n), backend="xla",
                       variant=variant, sampling=sampling,
                       compact_every=compact_every,
                       sampling_strategy=strategy)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("schedule", ["masked", "staged"])
@pytest.mark.parametrize("strategy", SAMPLING_STRATEGIES)
def test_solve_frontier_matches_reference(strategy, schedule, backend):
    s, d, n = _schedule_arrays(schedule)
    ref = _ref_frontier_solve(schedule, strategy)
    port = repro_torch.solve(interop.graph_from_arrays(s, d, n, device="cpu"),
                             backend=backend, sampling=2, compact_every=2,
                             sampling_strategy=strategy)
    _same_result(ref, port)
    assert bool(port.converged)
    assert port.provenance == (
        f"plan:{backend} origin=pinned schedule={schedule} fused=1 "
        "device=cpu", f"sampling_strategy:{strategy}")
    # the frontier did cut the work
    assert float(port.edges_visited) < int(port.iterations) * len(s)


@pytest.mark.parametrize("variant", ["C-1", "C-m", "C-11mm", "C-1m1m",
                                     "C-3"])
@pytest.mark.parametrize("sampling,compact_every", [(0, 1), (3, 0), (3, 1)])
def test_frontier_schedules_and_variants_match_reference(
        variant, sampling, compact_every):
    s, d, n = _schedule_arrays("masked")
    ref = _ref_frontier_solve("masked", "prefix", variant, sampling,
                              compact_every)
    port = repro_torch.solve(interop.graph_from_arrays(s, d, n, device="cpu"),
                             variant=variant, sampling=sampling,
                             compact_every=compact_every)
    _same_result(ref, port)


@pytest.mark.parametrize("sampling,compact_every", [(0, 2), (2, 2), (2, 0)])
@pytest.mark.parametrize("n,m,seed", [(200, 900, 0), (500, 3000, 1),
                                      (1500, 5000, 2)])
def test_staged_and_masked_drivers_match_reference(n, m, seed, sampling,
                                                   compact_every):
    """Both realisations called directly, as ``tests/test_planner.py``
    calls the reference's, at sizes where the stages really shrink."""
    s, d = _rand_edges(n, m, seed)
    kw = dict(variant="C-2", sampling=sampling, compact_every=compact_every)
    ref_masked = ref_contour.contour_labels(jnp.asarray(s), jnp.asarray(d),
                                            n, **kw)
    ref_stg = ref_staged.staged_adaptive_labels(jnp.asarray(s),
                                                jnp.asarray(d), n, **kw)
    _same_out(ref_masked, contour.contour_labels(_t(s), _t(d), n, **kw))
    _same_out(ref_stg, staged.staged_adaptive_labels(_t(s), _t(d), n,
                                                     backend="cuda", **kw))


# the reference's scalar kernel runs in interpret mode: small graphs only
ASYNC_GRAPHS = {
    "rmat11": lambda: ref_gen.rmat(11, seed=8),
    "path_grid": lambda: ref_gen.components_mix(
        [ref_gen.path(1500, seed=9), ref_gen.grid2d(20, 50)], seed=10),
}


@pytest.mark.parametrize("driver", ["masked", "staged"])
@pytest.mark.parametrize("strategy", SAMPLING_STRATEGIES)
@pytest.mark.parametrize("gname", sorted(ASYNC_GRAPHS))
def test_cuda_async_frontier_matches_pallas(gname, strategy, driver):
    s, d, n = ASYNC_GRAPHS[gname]().to_numpy()
    kw = dict(variant="C-2", sampling=2, compact_every=2,
              sampling_strategy=strategy)
    if driver == "masked":
        ref = ref_contour.contour_labels(jnp.asarray(s), jnp.asarray(d), n,
                                         backend="pallas", **kw)
        port = contour.contour_labels(_t(s), _t(d), n, backend="cuda_async",
                                      **kw)
    else:
        ref = ref_staged.staged_adaptive_labels(
            jnp.asarray(s), jnp.asarray(d), n, backend="pallas", **kw)
        port = staged.staged_adaptive_labels(_t(s), _t(d), n,
                                             backend="cuda_async", **kw)
    _same_out(ref, port)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("schedule", ["masked", "staged"])
def test_frontier_warm_start_matches_reference(schedule, backend):
    s, d, n = _schedule_arrays(schedule)
    rng = np.random.default_rng(11)
    extra_s, extra_d = rng.integers(0, n + 9, 40), rng.integers(0, n + 9, 40)
    ref_g = repro.Graph.from_numpy(s, d, n)
    first = repro.solve(ref_g)
    ref = repro.solve(ref_g.add_edges(extra_s, extra_d, n_vertices=n + 9),
                      warm_start=first, sampling=2, compact_every=1,
                      sampling_strategy="kout")
    g = interop.graph_from_arrays(s, d, n, device="cpu")
    port_first = repro_torch.solve(g)
    port = repro_torch.solve(
        g.add_edges(extra_s, extra_d, n_vertices=n + 9),
        warm_start=port_first, backend=backend, sampling=2, compact_every=1,
        sampling_strategy="kout")
    _same_result(ref, port)


@pytest.mark.parametrize("schedule", ["masked", "staged"])
def test_frontier_budget_run_matches_reference(schedule):
    s, d, n = _schedule_arrays(schedule)
    for max_iters in (1, 2, 3):
        ref = repro.solve(repro.Graph.from_numpy(s, d, n), backend="xla",
                          max_iters=max_iters, sampling=2, compact_every=1)
        port = repro_torch.solve(
            interop.graph_from_arrays(s, d, n, device="cpu"),
            max_iters=max_iters, sampling=2, compact_every=1)
        _same_result(ref, port)
        assert not bool(port.converged)


def test_c_syn_rejects_the_frontier_in_both_packages():
    s, d, n = _schedule_arrays("masked")
    ref_g = repro.Graph.from_numpy(s, d, n)
    g = interop.graph_from_arrays(s, d, n, device="cpu")
    for kw in ({"sampling": 2}, {"compact_every": 1}):
        with pytest.raises(ValueError, match="C-Syn"):
            repro.solve(ref_g, variant="C-Syn", **kw)
        with pytest.raises(ValueError, match="C-Syn"):
            repro_torch.solve(g, variant="C-Syn", **kw)
        with pytest.raises(ValueError, match="C-Syn"):
            contour.contour_labels(g.src, g.dst, n, variant="C-Syn", **kw)
        with pytest.raises(ValueError, match="C-Syn"):
            staged.staged_adaptive_labels(g.src, g.dst, n, variant="C-Syn",
                                          **kw)
    with pytest.raises(ValueError, match=">= 0"):
        staged.staged_adaptive_labels(g.src, g.dst, n, sampling=-1)


@pytest.mark.parametrize("overrides,match", [
    ({"sampling_strategy": "nope"}, "unknown sampling_strategy"),
    ({"sampling_k": 0}, "sampling_k"),
])
def test_frontier_option_errors_match_reference(overrides, match):
    with pytest.raises(ValueError, match=match):
        repro.SolveOptions(**overrides).validate()
    with pytest.raises(ValueError, match=match):
        SolveOptions(**overrides).validate()


def test_staged_threshold_and_auto_plan_match_reference():
    assert heuristics.STAGED_MIN_EDGES == ref_heur.STAGED_MIN_EDGES
    assert staged.MIN_STAGE_EDGES == ref_staged.MIN_STAGE_EDGES
    for m in (0, 2 ** 15 - 1, 2 ** 15, 2 ** 20):
        plan = heuristics.heuristic_plan(1000, m, torch.device("cpu"))
        assert plan.compact_schedule == ref_heur.heuristic_plan(
            1000, m, "tpu").compact_schedule
        # as the reference's table never picks its scalar kernel
        assert plan.backend == "cuda"


def test_registered_strategy_runs_end_to_end():
    def reverse(src, dst, n_vertices, k):
        del n_vertices, k
        return src.flip(0), dst.flip(0), torch.tensor(max(1, len(src) // 3))

    register_sampling_strategy(SamplingStrategy("reverse_test", reverse))
    s, d, n = _schedule_arrays("masked")
    g = interop.graph_from_arrays(s, d, n, device="cpu")
    res = repro_torch.solve(g, sampling=2, compact_every=2,
                            sampling_strategy="reverse_test")
    np.testing.assert_array_equal(res.labels.numpy(),
                                  connected_components_oracle(s, d, n))
    assert res.provenance[-1] == "sampling_strategy:reverse_test"
