"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a CUDA device (the kernels have
no CPU mode).  This file imports no JAX, so it also runs on a machine
with only the port's dependencies::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import solve  # noqa: E402
from repro_torch.connectivity import minmap  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.graphs.oracle import connected_components_oracle  # noqa: E402
from repro_torch.kernels import contour_mm  # noqa: E402
from repro_torch.kernels.contour_mm import blocked, kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_mha, flash_mha_plain)
from repro_torch.kernels.fused_rmsnorm import (fused_rmsnorm,  # noqa: E402
                                               rmsnorm_rows,
                                               rmsnorm_rows_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _states(g, count=3):
    L = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
    out = [L]
    for _ in range(count):
        L = minmap.pointer_jump(minmap.mm_relax(L, g.src, g.dst, 2))
        out.append(L)
    return out


@pytest.mark.parametrize("graph", ["rmat", "grid", "star"])
def test_kernels_match_plain(cuda, graph):
    g = {"rmat": lambda: gen.rmat(14, seed=7, device=cuda),
         "grid": lambda: gen.grid2d(100, 120, device=cuda),
         "star": lambda: gen.star(5000, seed=1, device=cuda)}[graph]()
    contour_mm.reset_launch_counts()
    gen_ = torch.Generator(device=cuda).manual_seed(0)
    for L in _states(g):
        for limit in (None, 0, g.n_edges // 2):
            assert torch.equal(
                blocked.fused_relax(L, g.src, g.dst, edge_limit=limit),
                blocked.fused_relax_plain(L, g.src, g.dst, limit))
        for order in (1, 2, 3):
            t, v = minmap.mm_update_stream(L, g.src, g.dst, order)
            valid = torch.rand(t.shape, device=cuda, generator=gen_) < 0.5
            for vd in (None, valid):
                assert torch.equal(blocked.scatter_min(L, t, v, vd),
                                   blocked.scatter_min_plain(L, t, v, vd))
    torch.cuda.synchronize()
    # edge_limit=0 launches nothing
    assert blocked.fused_relax.launches == 4 * 2
    assert blocked.scatter_min.launches == 4 * 6


def test_solve_on_the_card_launches_the_kernels(cuda):
    g = gen.components_mix([gen.path(3000, seed=1, device="cpu"),
                            gen.rmat(12, seed=2, device="cpu")], seed=3,
                           device=cuda)
    want = connected_components_oracle(*g.to_numpy())
    for variant, kernel in (("C-2", blocked.fused_relax),
                            ("C-11mm", blocked.scatter_min)):
        contour_mm.reset_launch_counts()
        res = solve(g, variant=variant)
        assert kernel.launches > 0
        plain = solve(g, variant=variant, backend="torch")
        for field in ("labels", "iterations", "converged", "edges_visited"):
            assert torch.equal(getattr(res, field), getattr(plain, field))
        assert res.labels.device.type == "cuda"
        assert (res.labels.cpu().numpy() == want).all()


def test_wrappers_reject_bad_inputs_on_the_card(cuda):
    L = torch.arange(8, dtype=torch.int32, device=cuda)
    e = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        blocked.fused_relax(L.long(), e, e)
    with pytest.raises(ValueError):
        blocked.fused_relax(L, e.cpu(), e)
    with pytest.raises(ValueError):
        blocked.scatter_min(L, e, e, valid=torch.ones(2, dtype=torch.bool))


def test_kernels_reject_out_of_range_ids_on_the_card(cuda):
    def i32(*ids):
        return torch.tensor(ids, dtype=torch.int32, device=cuda)

    L = torch.arange(8, dtype=torch.int32, device=cuda)
    bad_label = L.clone()
    bad_label[3] = 9
    # (kernel call with an id outside [0, 8), what it gives once the bad
    # edge or update is skipped)
    cases = [
        (lambda c: blocked.fused_relax(L, i32(0, 8), i32(1, 2), check=c),
         [0, 0, 2, 3, 4, 5, 6, 7]),
        (lambda c: blocked.fused_relax(L, i32(1), i32(-1), check=c),
         list(range(8))),
        (lambda c: blocked.fused_relax(bad_label, i32(3, 4), i32(2, 1),
                                       check=c),
         [0, 1, 2, 9, 1, 5, 6, 7]),
        (lambda c: blocked.scatter_min(L, i32(1, 8), i32(0, 0), check=c),
         [0, 0, 2, 3, 4, 5, 6, 7]),
        (lambda c: blocked.scatter_min(L, i32(-1, 5), i32(0, 2), check=c),
         [0, 1, 2, 3, 4, 2, 6, 7]),
    ]
    for call, skipped in cases:
        with pytest.raises(IndexError, match=r"outside \[0, 8\)"):
            call(True)
        # unchecked, the kernel still touches nothing outside L
        assert call(False).tolist() == skipped
    torch.cuda.synchronize()


# graphs on which the sweep kernels' combining is pushed: every edge meets
# one hub (a star with its hub at a random id, and one whose hub is vertex
# 0), each edge reads what the one before lowered, and a power-law graph
SWEEP_GRAPHS = {
    "star": lambda d: gen.star(65536, seed=1, device=d),
    "one_hub": lambda d: gen.Graph.from_numpy(
        np.zeros(65535, np.int64), np.arange(1, 65536), 65536, device=d),
    "path_unshuffled": lambda d: gen.path(65536, shuffle_ids=False,
                                          device=d),
    "rmat": lambda d: gen.rmat(14, 16, seed=7, device=d),
}


def _sliced(t, offset):
    """``t`` from ``offset`` on: a view whose base is ``offset`` items
    past the allocation's (16-byte aligned) start."""
    return t[offset:]


@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 1), (2, 0)])
@pytest.mark.parametrize("graph", sorted(SWEEP_GRAPHS))
def test_sweep_kernels_on_hubs_and_slices(cuda, graph, offsets):
    """fused_relax and scatter_min on hub graphs and on slices of the
    edge list whose base is not on a 16-byte boundary, at edge limits 0,
    1, 31, 33 and m // 2: equal to their plain versions, with the
    replays' counts of updates before the test and of hot slots."""
    g = SWEEP_GRAPHS[graph](cuda)
    src, dst = _sliced(g.src, offsets[0]), _sliced(g.dst, offsets[1])
    m = min(src.shape[0], dst.shape[0])
    src, dst = src[:m], dst[:m]
    for L in _states(g, count=2):
        for limit in (None, 0, 1, 31, 33, m // 2):
            got, counts = blocked.fused_relax_sweep(L, src, dst, limit,
                                                    counts=True)
            assert torch.equal(got, blocked.fused_relax_plain(L, src, dst,
                                                              limit))
            _, want = blocked.fused_relax_combined_replay(L, src, dst, limit)
            assert {key: counts[key] for key in want} == want
        t, v = minmap.mm_update_stream(L, g.src, g.dst, 1)
        t, v = _sliced(t, offsets[0]), _sliced(v, offsets[1])
        k = min(t.shape[0], v.shape[0])
        valid = _sliced(torch.arange(t.shape[0] + 4, device=cuda) % 3 > 0,
                        offsets[1])[:k]
        for vd in (None, valid):
            got, counts = blocked.scatter_min_sweep(L, t[:k], v[:k], vd,
                                                    counts=True)
            assert torch.equal(got, blocked.scatter_min_plain(L, t[:k], v[:k],
                                                              vd))
            _, want = blocked.scatter_min_combined_replay(L, t[:k], v[:k],
                                                          vd)
            assert {key: counts[key] for key in want} == want


@pytest.mark.parametrize("graph", ["star", "rmat"])
def test_sweep_kernels_test_before_the_red(cuda, graph):
    """The test of the output label and the combine only drop reds: the
    labels are the plain version's, and the updates left after the test
    never exceed those before it, nor the reds issued those left.  On the
    star's first sweep the hub's slots are hot."""
    g = SWEEP_GRAPHS[graph](cuda)
    for i, L in enumerate(_states(g, count=2)):
        got, counts = blocked.fused_relax_sweep(L, g.src, g.dst,
                                                counts=True)
        assert torch.equal(got, blocked.fused_relax_plain(L, g.src, g.dst))
        t, v = minmap.mm_update_stream(L, g.src, g.dst, 2)
        got2, counts2 = blocked.scatter_min_sweep(L, t, v, counts=True)
        assert torch.equal(got2, blocked.scatter_min_plain(L, t, v))
        for c in (counts, counts2):
            assert (c["reds_to_memory"] <= c["reds_after_test"]
                    <= c["reds_before_test"])
        if graph == "star" and i == 0:
            assert counts2["hot_slots"] > 0


def test_sweep_counter_only_when_asked(cuda):
    """Without ``counts`` the sweeps return the labels alone (no counter
    is allocated); with it, the four counts of ``blocked.COUNTERS``."""
    g = SWEEP_GRAPHS["rmat"](cuda)
    L = _states(g, count=0)[0]
    assert isinstance(blocked.fused_relax_sweep(L, g.src, g.dst),
                      torch.Tensor)
    _, counts = blocked.fused_relax_sweep(L, g.src, g.dst, counts=True)
    assert tuple(counts) == blocked.COUNTERS
    assert counts["reds_before_test"] == g.n_edges


@pytest.mark.parametrize("graph", ["rmat", "grid", "path"])
def test_mm2_matches_plain(cuda, graph):
    g = {"rmat": lambda: gen.rmat(12, seed=7, device=cuda),
         "grid": lambda: gen.grid2d(60, 70, device=cuda),
         "path": lambda: gen.path(5000, seed=2, device=cuda)}[graph]()
    contour_mm.reset_launch_counts()
    for L in _states(g, count=2):
        for limit in (None, 0, g.n_edges // 3):
            assert torch.equal(
                kernel.mm2(L, g.src, g.dst, edge_limit=limit),
                kernel.mm2_plain(L.cpu(), g.src.cpu(), g.dst.cpu(),
                                 limit).to(cuda))
    torch.cuda.synchronize()
    # edge_limit=0 launches nothing
    assert kernel.mm2.launches == 3 * 2


def test_mm2_rejects_out_of_range_ids_on_the_card(cuda):
    def i32(*ids):
        return torch.tensor(ids, dtype=torch.int32, device=cuda)

    L = torch.arange(8, dtype=torch.int32, device=cuda)
    cases = [
        (lambda c: kernel.mm2(L, i32(0, 8), i32(1, 2), check=c),
         [0, 0, 2, 3, 4, 5, 6, 7]),
        (lambda c: kernel.mm2(L, i32(1, 5), i32(-1, 2), check=c),
         [0, 1, 2, 3, 4, 2, 6, 7]),
        (lambda c: kernel.mm2(i32(0, 1, 3, -1, 4, 5, 6, 7), i32(2, 2),
                              i32(2, 2), check=c),
         [0, 1, -1, -1, 4, 5, 6, 7]),
    ]
    for call, skipped in cases:
        with pytest.raises(IndexError, match=r"outside \[0, 8\)"):
            call(True)
        # unchecked, the kernel still touches nothing outside L
        assert call(False).tolist() == skipped
    torch.cuda.synchronize()


# (window, depth, cache slots) of mm2's protocol: the defaults, and sizes
# at which every forwarding, eviction and fallback branch fires
MM2_SIZES = [(kernel.WINDOW, kernel.DEPTH, kernel.CACHE_SLOTS), (1, 1, 1),
             (1, 2, 1), (3, 2, 1), (4, 4, 2), (7, 5, 8), (32, 2, 64)]
MM2_GRAPHS = {
    "path_unshuffled": lambda d: gen.path(3000, shuffle_ids=False, device=d),
    "path": lambda d: gen.path(3000, seed=2, device=d),
    "star": lambda d: gen.star(2000, seed=1, device=d),
    "grid": lambda d: gen.grid2d(30, 40, device=d),
    "rmat10": lambda d: gen.rmat(10, seed=7, device=d),
    "rmat12": lambda d: gen.rmat(12, seed=8, device=d),
    "mix": lambda d: gen.components_mix(
        [gen.path(500, seed=1, device="cpu"), gen.rmat(9, seed=2,
                                                       device="cpu"),
         gen.star(300, seed=3, device="cpu")], seed=4, device=d),
}


def _aliasing_list(seed, device):
    """Self-loops, duplicate edges, w == v and v == L[w] (lw == v)."""
    gen_ = torch.Generator().manual_seed(seed)
    n = 48
    L = torch.stack([torch.randint(0, i + 1, (), generator=gen_)
                     for i in range(n)]).int()
    w = torch.randint(0, n, (300,), generator=gen_, dtype=torch.int32)
    kind = torch.randint(0, 4, (300,), generator=gen_)
    v = torch.where(kind == 0, w, torch.where(
        kind == 1, L[w.long()],
        torch.randint(0, n, (300,), generator=gen_, dtype=torch.int32)))
    dup = torch.randint(0, 300, (60,), generator=gen_)
    src = torch.cat([w, w[dup], v[:40]])
    dst = torch.cat([v, v[dup], w[:40]])
    return L.to(device), src.to(device), dst.to(device)


@pytest.mark.parametrize("size", MM2_SIZES, ids=str)
@pytest.mark.parametrize("graph", sorted(MM2_GRAPHS))
def test_mm2_sizes_match_plain(cuda, graph, size):
    """The kernel at the defaults and at tiny window, depth and cache
    sizes, from identity and mid-run labels, in both edge orders, with an
    edge_limit inside a window: equal to mm2_plain bit for bit."""
    window, depth, slots = size
    g = MM2_GRAPHS[graph](cuda)
    m = g.n_edges
    limit = (m // 2 // window) * window + max(1, window // 2)
    for L in _states(g, count=1):
        for src, dst in ((g.src, g.dst), (g.src.flip(0), g.dst.flip(0))):
            for lim in (None, limit):
                got, counts = kernel.sweep(
                    L, src, dst, lim, window=window, depth=depth,
                    cache_slots=slots, counts=True)
                want = kernel.mm2_plain(L.cpu(), src.cpu(), dst.cpu(), lim)
                assert torch.equal(got.cpu(), want)
                assert sum(counts.values()) == 4 * (m if lim is None
                                                    else lim)


@pytest.mark.parametrize("size", MM2_SIZES, ids=str)
def test_mm2_sizes_on_self_loops_duplicates_and_aliasing(cuda, size):
    window, depth, slots = size
    for seed in range(4):
        L, src, dst = _aliasing_list(seed, cuda)
        got = kernel.sweep(L, src, dst, window=window, depth=depth,
                           cache_slots=slots)
        want = kernel.mm2_plain(L.cpu(), src.cpu(), dst.cpu())
        assert torch.equal(got.cpu(), want)


def test_mm2_launcher_refuses_what_the_card_cannot_hold(cuda):
    """A cache past the CTA's shared memory is refused at launch and
    raises; no launch is counted."""
    L = torch.arange(8, dtype=torch.int32, device=cuda)
    e = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    launches = kernel.mm2.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel.sweep(L, e, e, cache_slots=1 << 16)
    assert kernel.mm2.launches == launches
    with pytest.raises(ValueError, match="power of two"):
        kernel.sweep(L, e, e, cache_slots=3)


@pytest.mark.parametrize("options", [
    {"variant": "C-2"}, {"variant": "C-Syn"},
    {"variant": "C-2", "sampling": 2, "compact_every": 2},
    {"variant": "C-m", "sampling": 2, "compact_every": 1,
     "sampling_strategy": "kout"},
])
def test_solve_cuda_async_on_the_card_matches_cpu(cuda, options):
    g = gen.components_mix([gen.path(3000, seed=1, device="cpu"),
                            gen.rmat(12, seed=2, device="cpu")], seed=3,
                           device="cpu")
    contour_mm.reset_launch_counts()
    on_card = gen.Graph.from_numpy(*g.to_numpy(), device=cuda)
    res = solve(on_card, backend="cuda_async", **options)
    assert kernel.mm2.launches > 0
    on_cpu = solve(g, backend="cuda_async", **options)
    for field in ("labels", "iterations", "converged", "edges_visited"):
        assert torch.equal(getattr(res, field).cpu(), getattr(on_cpu, field))
    want = connected_components_oracle(*g.to_numpy())
    assert (res.labels.cpu().numpy() == want).all()


@pytest.mark.parametrize("strategy", ["prefix", "kout", "bfs"])
def test_frontier_on_the_card_matches_the_torch_backend(cuda, strategy):
    g = gen.components_mix([gen.rmat(13, seed=4, device="cpu"),
                            gen.grid2d(100, 120, device="cpu")], seed=5,
                           device=cuda)
    assert g.n_edges >= 1 << 15          # the staged schedule
    contour_mm.reset_launch_counts()
    res = solve(g, sampling=2, compact_every=2, sampling_strategy=strategy)
    assert blocked.fused_relax.launches > 0
    plain = solve(g, sampling=2, compact_every=2, sampling_strategy=strategy,
                  backend="torch")
    for field in ("labels", "iterations", "converged", "edges_visited"):
        assert torch.equal(getattr(res, field), getattr(plain, field))
    assert "schedule=staged" in res.provenance[0]


# ---------------------------------------------------------------------------
# the fixpoint loop on the card: converged_early and labels_unchanged (K6),
# pointer_jump (K7), the done word of the sweeps, the baseline families
# ---------------------------------------------------------------------------


def _converged_cases(d):
    """(name, L, src, dst) on which the predicate is pushed: a fixed point
    (no witness), one witness first or last among 200k edges (one edge
    between two components, or a label one hop from its root), every edge
    a witness, and a star at identity labels and at its fixed point."""
    g = gen.components_mix([gen.rmat(14, 8, seed=7, device="cpu"),
                            gen.grid2d(150, 200, device="cpu")], seed=9,
                           device="cpu")
    s, t, n = g.to_numpy()
    fixed = connected_components_oracle(s, t, n)
    other = int(np.flatnonzero(fixed != fixed[s[0]])[0])
    chain = fixed.copy()
    root = int(fixed[s[-1]])
    member = int(np.flatnonzero((fixed == root) & (np.arange(n) != root))[0])
    chain[s[-1]] = member if s[-1] != member else root
    chain[member] = root

    def on(*arrays):
        return [torch.as_tensor(np.asarray(a, np.int32), device=d)
                for a in arrays]

    first = t.copy()
    first[0] = other                      # edge 0 joins two components
    star = gen.star(70000, seed=3, device="cpu")
    ss, st, sn = star.to_numpy()
    return [
        ("fixed", *on(fixed, s, t)),
        ("witness_first", *on(fixed, s, first)),
        ("witness_last", *on(chain, s, t)),
        ("all_bad", *on(np.arange(n), s, t)),
        ("star_identity", *on(np.arange(sn), ss, st)),
        ("star_fixed", *on(connected_components_oracle(ss, st, sn), ss, st)),
    ]


def _check_converged(cv, cuda, name, L, src, dst):
    """K6 against its plain version at edge limits None, 0, 1, 31, 33, 200,
    m // 2 and m - 1; with a loop state, one test sets it = 1 and done =
    the flag, and a second does nothing.  Returns the checks made."""
    m = int(src.shape[0])
    for limit in (None, 0, 1, 31, 33, 200, m // 2, m - 1):
        want = bool(cv.converged_early_plain(L, src, dst, limit))
        assert bool(cv.converged_early(L, src, dst, limit)) == want, \
            (name, limit)
        state = cv.loop_state(cuda)
        cv.converged_early(L, src, dst, limit, state=state)
        assert state.tolist() == [int(want), 1, 0, 0], (name, limit)
        cv.converged_early(L, src, dst, limit, state=state)
        assert state.tolist() == [int(want), 1 + (not want), 0, 0]
    return 8


def test_converged_early_matches_plain_on_the_card(cuda):
    """K6 against its plain version at edge limits None, 0, 1, 31, 33, 200,
    m // 2 and m - 1 on the adversarial cases; with a loop state, one test
    sets it = 1 and done = the flag, and a second does nothing."""
    from repro_torch.kernels.contour_mm import converged as cv
    cv.converged_early.launches = 0
    checks = 0
    for name, L, src, dst in _converged_cases(cuda):
        checks += _check_converged(cv, cuda, name, L, src, dst)
        if name == "witness_first":
            assert not bool(cv.converged_early(L, src, dst))
        if name == "star_fixed":
            assert bool(cv.converged_early(L, src, dst))
    torch.cuda.synchronize()
    assert cv.converged_early.launches > 0 and checks == 6 * 8


def _tails_and_root_witnesses(d):
    """(name, L, src, dst): the fixed point's first 4q + r edges (r = 1, 2,
    3) with the last, in the tail past the last whole vector, joining two
    components; and a star whose labels all name a vertex on no edge whose
    own label is another (a witness by the root test alone, at the hub),
    after a component at its fixed point."""
    g = gen.components_mix([gen.rmat(12, 8, seed=3, device="cpu"),
                            gen.grid2d(60, 70, device="cpu")], seed=4,
                           device="cpu")
    s, t, n = g.to_numpy()
    fixed = connected_components_oracle(s, t, n)
    out = []
    for r in (1, 2, 3):
        k = 4 * 2000 + r
        tt = t[:k].copy()
        tt[-1] = int(np.flatnonzero(fixed != fixed[s[k - 1]])[0])
        out.append((f"tail_{r}", fixed, s[:k], tt))
    # the star: hub n, leaves n + 1 ... n + 2999, half of its edges with
    # the hub as v and half as w; every label names x
    hub, x = n, n + 3000
    leaves = n + np.arange(1, 3000)
    ss = np.concatenate([s, leaves[:1500], np.full(1499, hub)])
    tt = np.concatenate([t, np.full(1500, hub), leaves[1500:]])
    L = np.concatenate([fixed, np.full(3000, x), [0]])   # L[x] = 0 != x
    out.append(("root_only_at_hub", L, ss, tt))
    return [(name, *(torch.as_tensor(np.asarray(a, np.int32), device=d)
                     for a in arrays)) for name, *arrays in out]


def test_converged_early_on_views_tails_and_hubs_on_the_card(cuda):
    """K6 against its plain version, as above, on ``src[1:]``/``dst[1:]``
    (not 16-byte aligned: the scalar kernel) and ``src[4:]``/``dst[4:]``
    (aligned views) of the adversarial cases, on tails of 1-3 edges past
    the last whole vector with the witness in the tail, and on a witness
    found only by the root test at a hub."""
    from repro_torch.kernels.contour_mm import converged as cv
    checks = 0
    for name, L, src, dst in _converged_cases(cuda):
        for cut in (1, 4):
            checks += _check_converged(cv, cuda, f"{name}[{cut}:]", L,
                                       src[cut:], dst[cut:])
    for name, L, src, dst in _tails_and_root_witnesses(cuda):
        checks += _check_converged(cv, cuda, name, L, src, dst)
        assert not bool(cv.converged_early(L, src, dst)), name
    torch.cuda.synchronize()
    assert checks == (12 + 4) * 8


def test_converged_early_counts_out_of_range_ids_on_the_card(cuda):
    """An edge with an id outside [0, n), in a whole vector, in the tail or
    on the scalar kernel, and a label outside [0, n), are witnesses, and
    the kernel reads nothing through them (the plain version raises or
    wraps, so it is not asked)."""
    from repro_torch.kernels.contour_mm import converged as cv
    n = 64
    L = torch.arange(n, dtype=torch.int32, device=cuda) // 8 * 8
    s = torch.arange(0, 64, 8, dtype=torch.int32, device=cuda).repeat(4)
    d = s + torch.arange(1, 33, dtype=torch.int32, device=cuda) % 8
    s, d = s.contiguous(), d.contiguous()
    assert bool(cv.converged_early(L, s, d))
    # views: 8 whole vectors; 7 and a tail of edges 28, 29; the scalar
    # kernel
    views = (slice(None), slice(None, 30), slice(1, None))
    for pos in (5, 29):
        for bad_id in (-1, n, 1 << 30):
            for t in (s, d):
                saved = int(t[pos])
                t[pos] = bad_id
                for view in views:
                    assert not bool(cv.converged_early(L, s[view], d[view]))
                state = cv.loop_state(cuda)
                cv.converged_early(L, s, d, state=state)
                assert state.tolist() == [0, 1, 0, 0]
                t[pos] = saved
    far = L.clone()
    far[s[3]] = far[d[3]] = n + 5            # L[w] == L[v], outside [0, n)
    assert not bool(cv.converged_early(far, s, d))
    assert not bool(cv.converged_early(far, s[1:], d[1:]))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [0, 1, 31, 33, 1_000_003])
def test_labels_unchanged_matches_plain_on_the_card(cuda, n):
    """``all(a == b)`` with no difference, one first, one last, every
    element different, and a slice not on a 16-byte boundary."""
    from repro_torch.kernels.contour_mm import converged as cv
    a = torch.arange(n + 1, dtype=torch.int32, device=cuda)
    cases = [(a[:n], a[:n].clone()), (a[1:], a[1:].clone())]
    if n:
        for pos in (0, n - 1):
            b = a[:n].clone()
            b[pos] += 1
            cases.append((a[:n], b))
        cases.append((a[:n], a[:n] + 1))
    for x, y in cases:
        want = bool(cv.labels_unchanged_plain(x, y))
        assert bool(cv.labels_unchanged(x, y)) == want
        state = cv.loop_state(cuda)
        cv.labels_unchanged(x, y, state=state)
        assert state.tolist() == [int(want), 1, 0, 0]


def test_pointer_jump_matches_plain_on_the_card(cuda):
    """K7 equals ``min(L, L[L])`` out of place on chains, and with the done
    word set returns a copy of its input."""
    from repro_torch.kernels.contour_mm import converged as cv
    rng = np.random.default_rng(0)
    for n in (1, 31, 1025, 300_001):
        parent = np.minimum(np.arange(n), rng.integers(0, n, n))
        L = torch.as_tensor(parent.astype(np.int32), device=cuda)
        for done in (None, 0, 1):
            word = (None if done is None else
                    torch.tensor([done], dtype=torch.int32, device=cuda))
            got = cv.pointer_jump(L, word)
            want = L if done else torch.minimum(L, L[L])
            assert torch.equal(got, want)
            assert torch.equal(cv.pointer_jump_plain(L, word), want)
            assert got.data_ptr() != L.data_ptr()
        assert torch.equal(minmap.pointer_jump(L, rounds=3),
                           cv.pointer_jump(cv.pointer_jump(
                               cv.pointer_jump(L))))


def test_sweeps_with_the_done_word_set_leave_the_labels(cuda):
    """K1, K2 and K3 with ``done`` set return their input labels; with it
    clear, their plain versions' labels."""
    g = gen.rmat(12, seed=2, device=cuda)
    L = _states(g, count=1)[1]
    t, v = minmap.mm_update_stream(L, g.src, g.dst, 1)
    for done in (0, 1):
        word = torch.tensor([done], dtype=torch.int32, device=cuda)
        for got, plain in (
                (blocked.fused_relax(L, g.src, g.dst, done=word),
                 blocked.fused_relax_plain(L, g.src, g.dst)),
                (blocked.scatter_min(L, t, v, done=word),
                 blocked.scatter_min_plain(L, t, v)),
                (kernel.mm2(L, g.src, g.dst, done=word),
                 kernel.mm2_plain(L, g.src, g.dst))):
            assert torch.equal(got, L if done else plain)
            assert not torch.equal(plain, L)


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("variant", ["C-2", "C-Syn", "C-m", "C-11mm"])
def test_chunked_loop_on_the_card_matches_cpu(cuda, variant, chunk,
                                              monkeypatch):
    """The dense loop on the card, warm-started from labels whose vertices
    off every edge hang on chains (which an unfrozen jump would shorten),
    equals the same solve on CPU tensors in labels, iterations, converged
    and edges_visited, with the launches the path makes."""
    from repro_torch.kernels.contour_mm import converged as cv
    monkeypatch.setattr(cv, "CHUNK", chunk)
    g = gen.components_mix([gen.rmat(12, seed=2, device="cpu"),
                            gen.path(2000, seed=1, device="cpu")], seed=3,
                           device="cpu")
    s, d, n = g.to_numpy()
    extra = 64                             # vertices on no edge: a chain
    cpu = gen.Graph.from_numpy(s, d, n + extra, device="cpu")
    warm = np.arange(n + extra)
    warm[n + 1:] = np.arange(n, n + extra - 1)
    on_card = gen.Graph.from_numpy(s, d, n + extra, device=cuda)
    contour_mm.reset_launch_counts()
    res = solve(on_card, variant=variant, warm_start=warm)
    want = solve(cpu, variant=variant, warm_start=warm)
    for field in ("labels", "iterations", "converged", "edges_visited"):
        assert torch.equal(getattr(res, field).cpu(), getattr(want, field))
    test = (cv.labels_unchanged if variant == "C-Syn"
            else cv.converged_early)
    assert test.launches >= int(res.iterations)
    if variant != "C-Syn":
        assert cv.pointer_jump.launches > int(res.iterations)


@pytest.mark.parametrize("options", [{}, {"variant": "C-Syn"},
                                     {"sampling": 2, "compact_every": 2}])
def test_torch_backend_launches_no_kernel(cuda, options):
    """The ``torch`` backend on the card is plain torch, its fixpoint loop
    included: it launches no kernel, and gives the ``cuda`` backend's
    labels, iterations, converged and edges_visited."""
    g = gen.components_mix([gen.rmat(12, seed=2, device="cpu"),
                            gen.path(2000, seed=1, device="cpu")], seed=3,
                           device=cuda)
    contour_mm.reset_launch_counts()
    plain = solve(g, backend="torch", **options)
    assert all(k.launches == 0
               for k in contour_mm.KERNELS + contour_mm.LOOP_KERNELS)
    res = solve(g, backend="cuda", **options)
    for field in ("labels", "iterations", "converged", "edges_visited"):
        assert torch.equal(getattr(res, field), getattr(plain, field))


@pytest.mark.parametrize("algorithm", ["fastsv", "lp", "connectit"])
def test_baseline_families_on_the_card_match_cpu(cuda, algorithm):
    """FastSV, label propagation and Rem on the card equal their solves on
    CPU tensors and the oracle, cold, warm and under a budget; FastSV and
    label propagation launch ``scatter_min`` and ``labels_unchanged``."""
    from repro_torch.kernels.contour_mm import converged as cv
    g = gen.components_mix([gen.rmat(12, seed=2, device="cpu"),
                            gen.star(20000, seed=4, device="cpu"),
                            gen.path(500, seed=1, device="cpu")], seed=3,
                           device="cpu")
    on_card = gen.Graph.from_numpy(*g.to_numpy(), device=cuda)
    warm = solve(g, max_iters=1).labels.numpy()
    for kw in ({}, {"warm_start": warm}, {"max_iters": 2}):
        contour_mm.reset_launch_counts()
        res = solve(on_card, algorithm=algorithm, **kw)
        want = solve(g, algorithm=algorithm, **kw)
        assert res.labels.device.type == "cuda"
        for field in ("labels", "iterations", "converged"):
            assert torch.equal(getattr(res, field).cpu(), getattr(want, field))
        assert res.edges_visited is None
        if algorithm != "connectit":
            assert blocked.scatter_min.launches > 0
            assert cv.labels_unchanged.launches > 0
        if "max_iters" not in kw:
            assert (res.labels.cpu().numpy()
                    == connected_components_oracle(*g.to_numpy())).all()


# (rows, d, x dtype, w dtype): 16-byte vectors staged in registers from one
# to eight a thread, a row too wide for the stage (read twice), and widths
# that are not whole vectors (scalar loads)
RMS_CARD_CASES = [
    (64, 512, torch.float32, torch.float32),
    (33, 768, torch.bfloat16, torch.bfloat16),
    (7, 128, torch.float32, torch.float32),
    (300, 5120, torch.bfloat16, torch.float32),
    (5, 8192, torch.float32, torch.bfloat16),
    (5, 16384, torch.float32, torch.float32),
    (3, 65536, torch.bfloat16, torch.bfloat16),
    (2, 40000, torch.float32, torch.float32),
    (9, 100, torch.bfloat16, torch.float32),
    (9, 101, torch.float32, torch.float32),
    (33, 768, torch.float16, torch.float16),
    (300, 5120, torch.float16, torch.float32),
    (3, 65536, torch.float16, torch.float16),
    (9, 101, torch.float16, torch.float32),
]
# bfloat16 and float16 round the output: one unit in their last place
# (2**-7 and 2**-10 of the value)
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.mark.parametrize("rows,d,x_dtype,w_dtype", RMS_CARD_CASES)
def test_rmsnorm_matches_plain_on_the_card(cuda, rows, d, x_dtype, w_dtype):
    gen_ = torch.Generator(device=cuda).manual_seed(rows * d)
    x = torch.randn(rows, d, device=cuda, generator=gen_).to(x_dtype)
    w = torch.randn(d, device=cuda, generator=gen_).to(w_dtype)
    before = rmsnorm_rows.launches
    got = rmsnorm_rows(x, w)
    assert rmsnorm_rows.launches == before + 1
    torch.cuda.synchronize()
    want = rmsnorm_rows_plain(x, w)
    assert got.dtype == x_dtype
    tol = RMS_TOL[x_dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # the entry point on (..., d) is the same kernel, one launch
    y = fused_rmsnorm(x.reshape(1, rows, d), w)
    assert rmsnorm_rows.launches == before + 2
    assert torch.equal(y.reshape(rows, d), got)


def test_rmsnorm_rejects_bad_inputs_on_the_card(cuda):
    x = torch.zeros(4, 8, device=cuda)
    w = torch.ones(8, device=cuda)
    before = rmsnorm_rows.launches
    for call, error in (
            (lambda: rmsnorm_rows(x.double(), w), TypeError),
            (lambda: rmsnorm_rows(x, w.cpu()), ValueError),
            (lambda: rmsnorm_rows(x.cpu(), w), ValueError),
            (lambda: rmsnorm_rows(x, w[:7]), ValueError),
            (lambda: rmsnorm_rows(torch.zeros(8, 4, device=cuda).t(), w),
             ValueError)):
        with pytest.raises(error):
            call()
    assert rmsnorm_rows.launches == before


# (b, h, hkv, t, s, hd, causal, dtype): GQA, MQA, ragged T and S on both
# sides of a tile, T != S, every column-group count of the float32 kernel
# and every head-dim bucket of the bfloat16 one (64, 128, 192, 256, with
# head dims that are not multiples of 16), causal T > S with S a multiple
# of the 128-key tile, the smallest and largest head dims
FLASH_CARD_CASES = [
    (2, 4, 2, 128, 128, 64, True, torch.float32),
    (2, 4, 2, 128, 128, 64, False, torch.float32),
    (1, 8, 1, 130, 130, 32, True, torch.bfloat16),
    (1, 4, 4, 200, 130, 16, True, torch.float32),
    (1, 4, 2, 100, 260, 128, True, torch.bfloat16),
    (1, 4, 2, 70, 190, 128, False, torch.bfloat16),
    (1, 2, 2, 96, 96, 80, True, torch.float32),
    (1, 2, 2, 64, 100, 192, False, torch.float32),
    (1, 2, 1, 65, 65, 256, True, torch.bfloat16),
    (3, 2, 2, 1, 1, 8, True, torch.float32),
    (1, 2, 2, 127, 129, 8, True, torch.bfloat16),
    (1, 4, 2, 129, 127, 24, False, torch.bfloat16),
    (1, 4, 2, 300, 256, 80, True, torch.bfloat16),
    (1, 2, 1, 129, 128, 64, True, torch.bfloat16),
    (1, 2, 2, 129, 129, 192, True, torch.bfloat16),
    (2, 4, 4, 127, 127, 256, False, torch.bfloat16),
    (3, 2, 2, 1, 1, 8, True, torch.bfloat16),
    # the float16 instances: every head-dim bucket, ragged, causal T > S
    (1, 8, 1, 130, 130, 32, True, torch.float16),
    (1, 4, 2, 100, 260, 128, True, torch.float16),
    (1, 4, 2, 129, 127, 24, False, torch.float16),
    (1, 2, 2, 129, 129, 192, True, torch.float16),
    (2, 4, 4, 127, 127, 256, False, torch.float16),
    (1, 2, 1, 129, 128, 64, True, torch.float16),
]
# (atol, rtol, rms_rel), as chip_smoke.py holds the kernel at nemo's
# shapes: one unit in bfloat16's or float16's last place, and rms(got -
# want) against rms(want)
FLASH_TOL = {torch.float32: (1e-5, 1e-4, 1e-5),
             torch.bfloat16: (4e-3, 1e-2, 5e-4),
             torch.float16: (1e-3, 2e-3, 1e-4)}


@pytest.mark.parametrize("b,h,hkv,t,s,hd,causal,dtype", FLASH_CARD_CASES)
def test_flash_matches_plain_on_the_card(cuda, b, h, hkv, t, s, hd, causal,
                                         dtype):
    gen_ = torch.Generator(device=cuda).manual_seed(t * s + hd)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen_).to(dtype)
               for shape in ((b, h, t, hd), (b, hkv, s, hd),
                             (b, hkv, s, hd)))
    before = flash_mha.launches
    got = flash_mha(q, k, v, causal=causal)
    assert flash_mha.launches == before + 1
    torch.cuda.synchronize()
    want = flash_mha_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol, rms_rel = FLASH_TOL[dtype]
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    assert ((got - want).square().mean().sqrt()
            <= rms_rel * want.square().mean().sqrt())


def test_flash_entry_point_launches_the_kernel_on_the_card(cuda):
    gen_ = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(1, 4, 256, 64, device=cuda, generator=gen_)
    k = torch.randn(1, 2, 256, 64, device=cuda, generator=gen_)
    v = torch.randn(1, 2, 256, 64, device=cuda, generator=gen_)
    before = flash_mha.launches
    got = flash_attention(q, k, v)
    assert flash_mha.launches == before + 1
    assert torch.equal(got, flash_mha(q, k, v))


def test_flash_rejects_bad_inputs_on_the_card(cuda):
    def qkv(h=4, hkv=2, hd=64):
        return (torch.zeros(1, h, 16, hd, device=cuda),
                torch.zeros(1, hkv, 16, hd, device=cuda),
                torch.zeros(1, hkv, 16, hd, device=cuda))

    q, k, v = qkv()
    before = flash_mha.launches
    for call, error in (
            (lambda: flash_mha(*qkv(hd=260)), ValueError),
            (lambda: flash_mha(*qkv(h=3)), ValueError),
            (lambda: flash_mha(q, k.cpu(), v), ValueError),
            (lambda: flash_mha(q.cpu(), k, v), ValueError),
            (lambda: flash_mha(q.double(), k.double(), v.double()),
             TypeError),
            (lambda: flash_mha(q.half(), k, v), TypeError),
            (lambda: flash_mha(q.transpose(2, 3).contiguous()
                               .transpose(2, 3), k, v), ValueError)):
        with pytest.raises(error):
            call()
    assert flash_mha.launches == before
    # float16 is taken (it raised TypeError before it had a kernel
    # instance): one launch, float16 out, the plain version's result
    gen_ = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(t.shape, device=cuda, generator=gen_).half()
               for t in (q, k, v))
    got = flash_mha(q, k, v)
    assert flash_mha.launches == before + 1
    assert got.dtype == torch.float16
    atol, rtol, _ = FLASH_TOL[torch.float16]
    torch.testing.assert_close(got.float(), flash_mha_plain(q, k, v).float(),
                               atol=atol, rtol=rtol)


def test_flash_refuses_misaligned_views_on_the_card(cuda):
    """A contiguous view one element into a buffer is not 16-byte aligned:
    the wrapper raises ValueError and the C launcher refuses the pointers,
    so the kernel's vector loads never fault."""
    buf = torch.randn(1 * 2 * 16 * 64 + 1, device=cuda)
    q = buf[1:].view(1, 2, 16, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = torch.randn(1, 2, 16, 64, device=cuda)
    before = flash_mha.launches
    for args in ((q, k, k), (k, q, k), (k, k, q)):
        with pytest.raises(ValueError, match="16-byte"):
            flash_mha(*args)
    need = flash.smem_bytes(64, torch.float32)
    with pytest.raises(RuntimeError, match="flash_mha launch failed"):
        flash.launch(q, k, k, torch.empty_like(k), True, need)
    assert flash_mha.launches == before
    # the context is sound: the next aligned call runs
    torch.testing.assert_close(flash_mha(q.clone(), k, k),
                               flash_mha_plain(q, k, k), atol=1e-5,
                               rtol=1e-4)


# shared memory each kernel needs at hd = 128: the float32 kernel's fp32
# staging (2 * 128 * 68 + 64 * 128 + 64 * 68) * 4; the bfloat16 kernel's Q
# tile (32 KB) and two stages of K and V tiles (128 KB), its 7 mbarriers
# and 1 KB to align the ring to the 128-byte swizzle's 1024-byte pattern
FLASH_SMEM_AT_HD128 = {torch.float32: 119_808, torch.bfloat16: 164_920,
                       torch.float16: 164_920}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_launch_refused_for_shared_memory_raises(cuda, dtype):
    """Held to the 48 KB a launch gets without asking, or to one byte less
    than its need, the launch is refused, and the wrapper raises instead of
    returning an unwritten output."""
    q = torch.randn(1, 2, 64, 128, device=cuda).to(dtype)
    k = torch.randn(1, 2, 64, 128, device=cuda).to(dtype)
    out = torch.empty_like(q)
    need = flash.smem_bytes(128, dtype)
    assert need == FLASH_SMEM_AT_HD128[dtype]
    before = flash_mha.launches
    for limit in (48 * 1024, need - 1):
        with pytest.raises(RuntimeError, match="flash_mha launch failed"):
            flash.launch(q, k, k, out, True, limit)
    assert flash_mha.launches == before
    # the next call asks for what it needs, and runs
    flash.launch(q, k, k, out, True, need)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), flash_mha_plain(q, k, k).float(),
                               atol=tol[0], rtol=tol[1])


def _stream_batches(n, seed, n_batches=6):
    g = gen.rmat(12, seed=seed, device="cpu")
    src, dst, _ = g.to_numpy()
    m = len(src)
    return g.n_vertices, [(src[b * m // n_batches:(b + 1) * m // n_batches],
                           dst[b * m // n_batches:(b + 1) * m // n_batches])
                          for b in range(n_batches)]


def test_stream_on_the_card_equals_the_stream_on_cpu(cuda):
    """The streaming engine on the card launches the sweep, test and jump
    kernels, and after every batch its state dict equals the same stream's
    on CPU tensors (the plain versions) bit for bit; device batches with
    validate=False take the same path."""
    from repro_torch import StreamingConnectivity

    n, batches = _stream_batches(1 << 12, seed=3)
    card = StreamingConnectivity(n, device=cuda)
    on_device = StreamingConnectivity(n, device=cuda)
    cpu = StreamingConnectivity(n, device="cpu")
    contour_mm.reset_launch_counts()
    for src, dst in batches:
        card.ingest(src, dst)
        on_device.ingest(torch.as_tensor(src, device=cuda),
                         torch.as_tensor(dst, device=cuda), validate=False)
        cpu.ingest(src, dst)
        want = cpu.state_dict()
        for eng in (card, on_device):
            got = eng.state_dict()
            for key, value in want.items():
                got_value = got[key]
                if isinstance(got_value, torch.Tensor):
                    assert got_value.device.type == "cuda"
                    assert torch.equal(got_value.cpu(), value), key
                else:
                    assert got_value == value, key
    from repro_torch.kernels.contour_mm import converged as cv
    assert blocked.fused_relax.launches > 0
    assert cv.converged_early.launches > 0 and cv.pointer_jump.launches > 0
    assert card.n_components == cpu.n_components


def test_engine_refuses_out_of_range_ids_and_goes_on(cuda):
    """An id out of range never reaches the gather on the card (where it
    would raise a device-side assert and poison the context): the query
    fails with IndexError and the engine goes on answering."""
    from repro_torch.serving import ConnectivityClient, ConnectivityEngine

    with ConnectivityEngine(64, device=cuda) as eng:
        c = ConnectivityClient(eng)
        c.ingest(np.arange(10), np.arange(1, 11))
        for bad in (lambda: c.component_of(64),
                    lambda: c.same_component(0, 1 << 20),
                    lambda: c.same_component(-1, 3)):
            with pytest.raises(IndexError):
                bad()
        with pytest.raises(ValueError, match="n_vertices"):
            c.ingest([0], [64])
        assert c.same_component(0, 10) and not c.same_component(0, 11)
        assert c.component_of(7) == 0 and c.n_components() == 54
    assert eng.snapshot().labels.device.type == "cuda"
    torch.cuda.synchronize()


def _oocore_states(engines):
    """Round by round, every engine's state dict equal to the first's."""
    while not engines[0].finished_streaming:
        records = [eng.run_round() for eng in engines]
        assert all(r == records[0] for r in records)
        want = engines[0].state_dict()
        for eng in engines[1:]:
            got = eng.state_dict()
            assert sorted(got) == sorted(want)
            for key, value in want.items():
                assert got[key].dtype == value.dtype, key
                np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert all(eng.finished_streaming for eng in engines)
    outs = [eng.finish() for eng in engines]
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a.cpu(), b.cpu())
    return outs[0]


def test_oocore_on_the_card_equals_the_torch_backend_and_cpu(cuda):
    """The out-of-core solver on the card launches the sweep, test and
    jump kernels, and after every round its state dict equals the same
    run's on the `torch` backend on the card and on CPU tensors."""
    from repro_torch.connectivity import OutOfCoreContraction
    from repro_torch.kernels.contour_mm import converged as cv

    chunks = gen.rmat_chunks(scale=14, edge_factor=8, seed=3,
                             chunk_edges=2048)
    star = gen.star_forest_chunks(k=8, b=1024)
    for source, local_iters in ((chunks, 4), (star, 1)):
        contour_mm.reset_launch_counts()
        engines = [OutOfCoreContraction(source, device=cuda,
                                        oocore_local_iters=local_iters),
                   OutOfCoreContraction(source, device=cuda,
                                        backend="torch",
                                        oocore_local_iters=local_iters),
                   OutOfCoreContraction(source, device="cpu",
                                        oocore_local_iters=local_iters)]
        assert engines[0]._pipeline.host[0].is_pinned()
        labels = _oocore_states(engines)[0]
        assert labels.device.type == "cuda"
        assert blocked.fused_relax.launches > 0
        assert cv.converged_early.launches > 0 and cv.pointer_jump.launches > 0
        want = connected_components_oracle(
            *source.materialize(device="cpu").to_numpy())
        np.testing.assert_array_equal(labels.cpu().numpy(), want)
    assert len(engines[0].round_counts) >= 2


def test_oocore_buffers_are_not_overwritten_in_use(cuda, monkeypatch):
    """The copy pipeline's two hazards.  A fold that returns at once but
    holds the card (a sleep, then a copy of the chunk it was handed) lets
    the host run ahead: the chunk each fold saw must still be its own
    chunk (the copy of chunk k + 2 waits for fold k; the host waits for
    the copy out of a pinned buffer before it pads the next chunk into
    it).  Then a fold made slow for real (many local iterations on a hub
    graph) gives the CPU run's state dict after every round."""
    from repro_torch.connectivity import OutOfCoreContraction
    from repro_torch.connectivity import oocore

    chunks = gen.rmat_chunks(scale=13, edge_factor=8, seed=5,
                             chunk_edges=1024)
    seen = []

    def slow_fold(labels, src, dst, n_active, **kw):
        torch.cuda._sleep(5_000_000)
        seen.append(torch.stack([src, dst]).clone())
        return labels, 0, np.float32(0)

    monkeypatch.setattr(oocore, "_fold_chunk", slow_fold)
    eng = OutOfCoreContraction(chunks, device=cuda)
    eng._stream(chunks)
    torch.cuda.synchronize()
    assert len(seen) == chunks.n_chunks
    for k, got in enumerate(seen):
        src, dst = chunks.chunk(k)
        want = torch.zeros_like(got, device="cpu")
        want[0, :len(src)] = torch.from_numpy(src)
        want[1, :len(dst)] = torch.from_numpy(dst)
        assert torch.equal(got.cpu(), want), k
    monkeypatch.undo()

    hubs = gen.star_forest_chunks(k=16, b=1024)
    _oocore_states([
        OutOfCoreContraction(hubs, device=cuda, oocore_local_iters=64),
        OutOfCoreContraction(hubs, device="cpu", oocore_local_iters=64)])


def test_oocore_peak_bytes_below_the_edge_list(cuda):
    """On a graph of 16 buckets, the bytes the solve allocates on the card
    stay below the 8m bytes of its edge list."""
    from repro_torch.connectivity import OutOfCoreContraction
    from repro_torch.connectivity import oocore

    chunks = gen.rmat_chunks(scale=16, edge_factor=16, seed=1,
                             chunk_edges=1 << 16)
    assert chunks.n_chunks == 16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    eng = OutOfCoreContraction(chunks, device=cuda)
    eng.run()
    torch.cuda.synchronize()
    peak = oocore.device_peak_bytes(cuda) - base
    assert 0 < peak < oocore.EDGE_BYTES * chunks.n_edges
    assert not eng.round_cap_exhausted


def test_oocore_fold_peak_within_the_estimate(cuda):
    """delaunay_like(21) in chunks of 2**17 (n is 16 buckets, so the
    labels dominate): the bytes the run allocates on the card stay within
    ``peak_bytes_estimate()``, which counts three label arrays, and below
    the edge list's 8m."""
    from repro_torch.connectivity import OutOfCoreContraction
    from repro_torch.connectivity import oocore

    src, dst, n = gen.delaunay_like(21, device="cpu").to_numpy()
    chunks = gen.ArrayChunks(src, dst, n, 1 << 17)
    OutOfCoreContraction(chunks, device=cuda).run()   # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    eng = OutOfCoreContraction(chunks, device=cuda)
    labels = eng.run()[0]
    torch.cuda.synchronize()
    peak = oocore.device_peak_bytes(cuda) - base
    assert 0 < peak <= eng.peak_bytes_estimate()
    assert peak < oocore.EDGE_BYTES * chunks.n_edges
    assert np.array_equal(labels.cpu().numpy(),
                          connected_components_oracle(src, dst, n))


def _fleet(device, seed=0):
    """Eight small graphs of four families, and identity warm starts but
    for one lane whose padding vertices form an edge-free chain."""
    gs = [gen.rmat(8, edge_factor=16, seed=seed + 1, device=device),
          gen.path(200, seed=seed + 2, device=device),
          gen.grid2d(12, 20, device=device),
          gen.star(100, seed=seed + 3, device=device),
          gen.rmat(7, edge_factor=4, seed=seed + 4, device=device),
          gen.path(50, seed=seed + 5, device=device),
          gen.grid2d(5, 5, device=device),
          gen.star(64, seed=seed + 6, device=device)]
    n = max(g.n_vertices for g in gs)
    warm = [torch.arange(g.n_vertices, dtype=torch.int32, device=device)
            for g in gs]
    chain = torch.arange(n, dtype=torch.int32, device=device)
    chain[100:] -= 1
    warm[6] = chain
    return gs, warm


@pytest.mark.parametrize("variant", ["C-2", "C-Syn", "C-1", "C-m",
                                     "C-11mm", "C-1m1m", "C-3"])
def test_fleet_on_the_card_matches_cpu(cuda, variant):
    from repro_torch import solve_batch
    from repro_torch.kernels.contour_mm import converged as cv

    fleet, warm = _fleet(cuda)
    cpu_fleet, cpu_warm = _fleet("cpu")
    for ws, cpu_ws in ((None, None), (warm, cpu_warm)):
        cv_names = ("converged_early_batched", "labels_unchanged_batched",
                    "pointer_jump_batched")
        for fn in (blocked.fused_relax_batched, blocked.scatter_min_batched,
                   blocked.fused_relax, *(getattr(cv, k) for k in cv_names)):
            fn.launches = 0
        card = solve_batch(fleet, variant=variant, warm_start=ws)
        plain = solve_batch(fleet, variant=variant, warm_start=ws,
                            backend="torch")
        assert blocked.fused_relax.launches == 0
        test = (cv.labels_unchanged_batched if variant == "C-Syn"
                else cv.converged_early_batched)
        assert test.launches > 0
        sweep = (blocked.scatter_min_batched if variant in ("C-1", "C-3")
                 else blocked.fused_relax_batched)
        assert sweep.launches > 0
        if variant != "C-Syn":
            assert cv.pointer_jump_batched.launches > 0
        cpu = solve_batch(cpu_fleet, variant=variant, warm_start=cpu_ws)
        for res in (card, plain):
            for key in ("labels", "iterations", "converged", "edges_visited"):
                assert torch.equal(getattr(res, key).cpu(),
                                   getattr(cpu, key)), key


@pytest.mark.parametrize("lanes_b", [1, 8, 33])
def test_fleet_entry_points_match_plain_on_the_card(cuda, lanes_b):
    from repro_torch.connectivity import contour
    from repro_torch.connectivity.batch import stack_graphs
    from repro_torch.kernels.contour_mm import converged as cv

    gs = [gen.rmat(9, edge_factor=8, seed=s, device=cuda)
          if s % 3 else gen.grid2d(10, 30 + s, device=cuda)
          for s in range(lanes_b)]
    st = stack_graphs(gs)
    n, src, dst = st.n_vertices, st.src, st.dst
    off = blocked.lane_offsets(lanes_b, n, cuda)
    L = (torch.arange(n, dtype=torch.int32, device=cuda)
         .expand(lanes_b, n) + off).reshape(-1).contiguous()
    lanes = torch.zeros((lanes_b, 4), dtype=torch.int32, device=cuda)
    lanes[1::2, cv.DONE] = 1
    for _ in range(4):
        for lw in (None, lanes):
            assert torch.equal(
                blocked.fused_relax_batched(L, src, dst, n, lw),
                blocked.fused_relax_batched_plain(L, src, dst, n, lw))
            for order in (1, 3):
                t, v = contour.mm_update_stream_batched(L, src, dst, n,
                                                        order)
                assert torch.equal(
                    blocked.scatter_min_batched(L, t, v, n, lw),
                    blocked.scatter_min_batched_plain(L, t, v, n, lw))
            assert torch.equal(cv.pointer_jump_batched(L, n, lw),
                               cv.pointer_jump_batched_plain(L, n, lw))
            jumped = cv.pointer_jump_batched_plain(L, n)
            for fn, plain, args in (
                    (cv.converged_early_batched,
                     cv.converged_early_batched_plain, (L, src, dst, n)),
                    (cv.labels_unchanged_batched,
                     cv.labels_unchanged_batched_plain, (jumped, L, n)),
                    (cv.labels_unchanged_batched,
                     cv.labels_unchanged_batched_plain, (L, L, n))):
                a = cv.fleet_state(lanes_b, cuda)
                b = cv.fleet_state(lanes_b, cuda)
                if lw is not None:
                    a.lanes.copy_(lw)
                    b.lanes.copy_(lw)
                fn(*args, a)
                plain(*args, b)
                assert torch.equal(a.lanes, b.lanes)
                assert torch.equal(a.fleet[:2], b.fleet[:2])
                assert a.fleet[cv.TICKET].item() == 0
        L = cv.pointer_jump_batched_plain(
            blocked.fused_relax_batched_plain(L, src, dst, n), n)


def test_fleet_past_the_id_space_is_refused_before_a_launch(cuda):
    from repro_torch import Graph, solve_batch
    from repro_torch.kernels.contour_mm import converged as cv

    src = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    blocked.fused_relax_batched.launches = 0
    cv.converged_early_batched.launches = 0
    with pytest.raises(ValueError, match="int32"):
        solve_batch(Graph(src=src, dst=src, n_vertices=1 << 30))
    assert blocked.fused_relax_batched.launches == 0
    assert cv.converged_early_batched.launches == 0
