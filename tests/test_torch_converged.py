"""The fixpoint loop on the device, on the CPU: the plain versions of the
convergence tests and the jump round against the reference, and the
chunked loop against ``repro.solve``, bit for bit.

``converged.CHUNK`` (iterations enqueued between two reads of the loop's
state) is set to 1, 2, 3 and 64; every Contour variant must give the
reference's labels, iterations, converged and edges_visited at each,
cold, warm-started from labels whose vertices off every edge hang on a
chain (which a jump round past the fixed point would shorten), and under
a budget.  A control shows that a loop whose jump rounds ignore the done
word differs.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.connectivity import minmap as ref_mm  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.oracle import connected_components_oracle  # noqa: E402,E501

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.connectivity import minmap as mm  # noqa: E402
from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402

VARIANTS = ("C-Syn", "C-1", "C-2", "C-m", "C-11mm", "C-1m1m", "C-3")
CHUNKS = (1, 2, 3, 64)
CHAIN = 40   # vertices on no edge, appended to every graph: a chain

GRAPHS = {
    "rmat8": lambda: ref_gen.rmat(8, seed=5),
    "path": lambda: ref_gen.path(200, seed=1),
    "mix": lambda: ref_gen.components_mix(
        [ref_gen.path(40, seed=9), ref_gen.star(30, seed=10),
         ref_gen.rmat(6, seed=11)], seed=12),
}


@functools.lru_cache(maxsize=None)
def _arrays(gname):
    """numpy (src, dst, n): the graph with ``CHAIN`` vertices appended."""
    s, d, n = GRAPHS[gname]().to_numpy()
    return s, d, n + CHAIN


def _warm(gname):
    """Warm-start labels: identity on the graph's vertices, and the
    appended vertices each one below the next (``L[v] = v - 1``)."""
    _, _, n = _arrays(gname)
    warm = np.arange(n)
    warm[n - CHAIN + 1:] -= 1
    return warm


@functools.lru_cache(maxsize=None)
def _reference(gname, variant, warm, max_iters=None):
    s, d, n = _arrays(gname)
    out = repro.solve(repro.Graph.from_numpy(s, d, n), variant=variant,
                      max_iters=max_iters,
                      warm_start=_warm(gname) if warm else None)
    return (np.asarray(out.labels), int(out.iterations),
            bool(out.converged), np.asarray(out.edges_visited))


def _port(gname, variant, warm, max_iters=None, **options):
    s, d, n = _arrays(gname)
    g = interop.graph_from_arrays(s, d, n, device="cpu")
    return repro_torch.solve(g, variant=variant, max_iters=max_iters,
                             warm_start=_warm(gname) if warm else None,
                             **options)


def _assert_same(ref, port):
    labels, iterations, converged, visited = ref
    np.testing.assert_array_equal(port.labels.numpy(), labels)
    assert port.iterations.dtype == torch.int32
    assert int(port.iterations) == iterations
    assert bool(port.converged) == converged
    assert port.edges_visited.dtype == torch.float32
    assert (port.edges_visited.numpy().view(np.uint32)
            == visited.view(np.uint32))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_chunked_loop_matches_reference(variant, chunk, monkeypatch):
    monkeypatch.setattr(cv, "CHUNK", chunk)
    for gname in sorted(GRAPHS):
        for warm in (False, True):
            _assert_same(_reference(gname, variant, warm),
                         _port(gname, variant, warm))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("max_iters", [1, 2, 3])
@pytest.mark.parametrize("variant", ["C-Syn", "C-2", "C-m", "C-1m1m"])
def test_chunked_budget_runs_match_reference(variant, max_iters, chunk,
                                             monkeypatch):
    """On the path (far more iterations than the budget) the loop stops at
    ``max_iters`` with ``converged`` False, whatever the chunk."""
    monkeypatch.setattr(cv, "CHUNK", chunk)
    ref = _reference("path", variant, True, max_iters)
    assert not ref[2] and ref[1] == max_iters
    _assert_same(ref, _port("path", variant, True, max_iters))


@pytest.mark.parametrize("variant", ["C-2", "C-3"])
def test_control_an_unfrozen_jump_differs(variant, monkeypatch):
    """The control: jump rounds that ignore the done word keep shortening
    the chain past the fixed point, so with iterations enqueued past it
    (a chunk of 64) the labels differ from the reference; with a chunk of
    1 no iteration runs past it and they agree.  The loop as shipped
    agrees at both.  (C-m's eleven rounds an iteration, and C-1's many
    iterations, leave no chain of ``CHAIN`` vertices to shorten.)"""
    ref = _reference("mix", variant, True)
    monkeypatch.setattr(cv, "CHUNK", 64)
    _assert_same(ref, _port("mix", variant, True))
    jump = cv.pointer_jump
    monkeypatch.setattr(cv, "pointer_jump",
                        lambda L, done=None: jump(L, None))
    unfrozen = _port("mix", variant, True)
    assert int(unfrozen.iterations) == ref[1]
    assert not np.array_equal(unfrozen.labels.numpy(), ref[0])
    monkeypatch.setattr(cv, "CHUNK", 1)
    _assert_same(ref, _port("mix", variant, True))


def _record_wrapper_calls(monkeypatch):
    """Wrap the loop kernels' wrappers so that each call is recorded."""
    calls = []
    for name in ("converged_early", "labels_unchanged", "pointer_jump"):
        fn = getattr(cv, name)
        monkeypatch.setattr(
            cv, name, lambda *a, _fn=fn, _name=name, **k:
            calls.append(_name) or _fn(*a, **k))
    return calls


@pytest.mark.parametrize("variant", VARIANTS)
def test_torch_backend_loop_is_plain(variant, monkeypatch):
    """The ``torch`` backend is plain torch end to end: its loop calls
    none of the loop kernels' wrappers (on the card each would launch its
    kernel) and gives the reference's result, cold and warm; the default
    backend's loop calls them."""
    calls = _record_wrapper_calls(monkeypatch)
    for warm in (False, True):
        _assert_same(_reference("mix", variant, warm),
                     _port("mix", variant, warm, backend="torch"))
        assert calls == []
    _port("mix", variant, False)
    assert calls


@pytest.mark.parametrize("strategy", ["prefix", "kout"])
def test_torch_backend_frontier_is_plain(strategy, monkeypatch):
    """The same for the frontier schedule: its convergence check and its
    final compression run the plain versions on the ``torch`` backend,
    with the default backend's result."""
    calls = _record_wrapper_calls(monkeypatch)
    options = dict(sampling=2, compact_every=2, sampling_strategy=strategy)
    plain = _port("mix", "C-2", True, backend="torch", **options)
    assert calls == []
    got = _port("mix", "C-2", True, **options)
    assert "converged_early" in calls and "pointer_jump" in calls
    for field in ("labels", "iterations", "converged", "edges_visited"):
        assert torch.equal(getattr(plain, field), getattr(got, field))


def test_loop_reads_its_state_once_a_chunk(monkeypatch):
    """The dense loop reads ``(done, it)`` ceil(iterations / k) times."""
    reads = []
    read = cv.read_loop
    monkeypatch.setattr(cv, "read_loop",
                        lambda state: reads.append(1) or read(state))
    for chunk in CHUNKS:
        monkeypatch.setattr(cv, "CHUNK", chunk)
        reads.clear()
        res = _port("path", "C-1", False)
        assert len(reads) == -(-int(res.iterations) // chunk)


# ---------------------------------------------------------------------------
# the plain versions of K6 and K7 against the reference
# ---------------------------------------------------------------------------


@jax.jit
def _ref_predicates(L, s, d):
    return (ref_mm.converged_early(L, s, d), ref_mm.pointer_jump(L, 1),
            ref_mm.pointer_jump(L, 3))


def _label_states(s, d, n, rng):
    """Identity labels, two mid-run C-2 states, the fixed point, and a
    random parent array with ``L[v] <= v``."""
    L = np.arange(n, dtype=np.int32)
    states = [L]
    for _ in range(2):
        L = np.asarray(ref_mm.pointer_jump(ref_mm.mm_relax(
            jnp.asarray(L), jnp.asarray(s), jnp.asarray(d), 2)))
        states.append(L)
    states.append(np.asarray(repro.solve(
        repro.Graph.from_numpy(s, d, n)).labels))
    states.append(np.minimum(np.arange(n), rng.integers(0, n, n))
                  .astype(np.int32))
    return states


@pytest.mark.parametrize("m", [0, 1, 31, 33, None])
def test_plain_versions_match_the_reference(m):
    """``converged_early`` at edge limits, ``pointer_jump`` with and
    without the done word, and ``labels_unchanged``, against the
    reference's functions, through the wrappers on CPU tensors."""
    rng = np.random.default_rng(0)
    s, d, n = _arrays("rmat8")
    s, d = s[:m].astype(np.int32), d[:m].astype(np.int32)
    ts, td = torch.from_numpy(s), torch.from_numpy(d)
    on = torch.tensor([1], dtype=torch.int32)
    off = torch.tensor([0], dtype=torch.int32)
    states = _label_states(s, d, n, rng)
    for i, L in enumerate(states):
        tL = torch.tensor(L)
        conv, jump1, jump3 = _ref_predicates(jnp.asarray(L), jnp.asarray(s),
                                             jnp.asarray(d))
        assert bool(cv.converged_early(tL, ts, td)) == bool(conv)
        for limit in (0, 1, len(s) // 2, len(s) + 5):
            k = min(limit, len(s))
            want = ref_mm.converged_early(jnp.asarray(L), jnp.asarray(s[:k]),
                                          jnp.asarray(d[:k]))
            assert (bool(cv.converged_early(tL, ts, td, limit))
                    == bool(cv.converged_early_plain(tL, ts, td, limit))
                    == bool(want))
        np.testing.assert_array_equal(cv.pointer_jump(tL).numpy(), jump1)
        np.testing.assert_array_equal(cv.pointer_jump(tL, off).numpy(),
                                      jump1)
        np.testing.assert_array_equal(cv.pointer_jump(tL, on).numpy(), L)
        np.testing.assert_array_equal(mm.pointer_jump(tL, rounds=3).numpy(),
                                      jump3)
        for done, want in ((None, jump3), (off, jump3), (on, L)):
            for jump in (cv.pointer_jump, cv.pointer_jump_plain):
                got = tL
                for _ in range(3):
                    got = jump(got, done)
                np.testing.assert_array_equal(got.numpy(), want)
        for j, other in enumerate(states):
            want = jnp.all(jnp.asarray(L) == jnp.asarray(other))
            assert bool(cv.labels_unchanged(
                tL, torch.tensor(other))) == bool(want)
            assert bool(want) == (i == j or np.array_equal(L, other))


def test_loop_state_and_step_on_the_cpu():
    """A test with a state does the loop's step: ``it += 1`` and ``done`` =
    the flag while ``done`` is clear, nothing once it is set."""
    s, d, n = _arrays("rmat8")
    ts, td = torch.from_numpy(s.astype(np.int32)), \
        torch.from_numpy(d.astype(np.int32))
    L = torch.arange(n, dtype=torch.int32)
    state = cv.loop_state("cpu")
    assert state.tolist() == [0, 0, 0, 0]
    assert cv.converged_early(L, ts, td, state=state) is None
    assert state.tolist() == [0, 1, 0, 0]
    assert cv.read_loop(state) == (False, 1)
    cv.labels_unchanged(L, L.clone(), state=state)
    assert state.tolist() == [1, 2, 0, 0]
    cv.converged_early(L, ts, td, state=state)
    cv.labels_unchanged(L, L + 1, state=state)
    assert cv.read_loop(state) == (True, 2)
    it, done = cv.loop_result(state)
    assert it.dtype == torch.int32 and int(it) == 2
    assert done.dtype == torch.bool and bool(done)
    assert cv.done_word(state).data_ptr() == state.data_ptr()
    with pytest.raises(TypeError, match="four int32"):
        cv.converged_early(L, ts, td, state=torch.zeros(4))


# ---------------------------------------------------------------------------
# the kernel's structure replayed on the host, and the predicate on random
# warm starts: plain version against the reference
# ---------------------------------------------------------------------------

try:
    import hypothesis  # noqa: F401
    HAS_HYPOTHESIS = True
except ImportError:
    HAS_HYPOTHESIS = False


def _replay_step(L, w4, v4, n, checked):
    """One lane's step of ``converged_vec_kernel`` on host lists:
    (witness, the last label whose root the lane checked)."""
    ok = [0 <= a < n and 0 <= b < n for a, b in zip(w4, v4)]
    witness = not all(ok)
    lw, lv = [0] * 4, [0] * 4
    for i in range(4):
        if not ok[i]:
            continue
        reuse = i > 0 and ok[i - 1] and w4[i] == w4[i - 1]
        lw[i] = lw[i - 1] if reuse else L[w4[i]]
        lv[i] = L[v4[i]]
    last = checked
    for i in range(4):
        if not ok[i]:
            continue
        if lw[i] != lv[i] or not 0 <= lw[i] < n:
            witness = True
            continue
        if lw[i] != last and L[lw[i]] != lw[i]:
            witness = True
        last = lw[i]
    return witness, last


def _replay(L, src, dst, edge_limit=None, *, aligned=True, lanes=1024,
            step=None):
    """The flag of ``csrc/converged.cu``'s predicate, its structure
    replayed on the host.  ``aligned``: ``converged_vec_kernel``, the
    ``m % 4`` tail edge by edge, then each of ``lanes`` lanes (the grid's
    threads) on vectors ``lane, lane + lanes, ...`` of 4 edges, reusing
    ``L[w]`` where ``w`` repeats inside a vector and checking ``L[L[w]]``
    only for a label other than the last it checked; else every edge by
    itself (``converged_kernel``).  ``step`` stands in for
    :func:`_replay_step`.  A witness ends the replay, as it ends the
    test."""
    step = step or _replay_step
    m = len(src) if edge_limit is None else min(edge_limit, len(src))
    L, s, d = L.tolist(), src[:m].tolist(), dst[:m].tolist()
    n = len(L)

    def alone(e):
        return step(L, [s[e]] * 4, [d[e]] * 4, n, -1)[0]

    if not aligned:
        return not any(alone(e) for e in range(m))
    items = m // 4
    if any(alone(e) for e in range(4 * items, m)):
        return False
    for lane in range(min(lanes, items)):
        checked = -1
        for vec in range(lane, items, lanes):
            witness, checked = step(L, s[4 * vec:4 * vec + 4],
                                    d[4 * vec:4 * vec + 4], n, checked)
            if witness:
                return False
    return True


def _tails_and_root_witnesses():
    """(name, L, src, dst) on the CPU: a fixed point's first 4q + r edges
    (r = 0, 1, 2, 3) whose last edge joins two components (for r > 0 in
    the tail past the last whole vector), and a star whose labels all name
    a vertex on no edge whose own label is another (a witness by the root
    test alone, at the hub)."""
    g = ref_gen.components_mix([ref_gen.rmat(8, seed=3),
                                ref_gen.grid2d(12, 15)], seed=4)
    s, t, n = (np.asarray(a) for a in g.to_numpy())
    fixed = connected_components_oracle(s, t, n)
    out = []
    for r in (0, 1, 2, 3):
        k = 4 * 100 + r
        tt = t[:k].copy()
        tt[-1] = int(np.flatnonzero(fixed != fixed[s[k - 1]])[0])
        out.append((f"tail_{r}", fixed, s[:k], tt))
    hub, x = n, n + 300
    leaves = n + np.arange(1, 300)
    ss = np.concatenate([s, leaves[:150], np.full(149, hub)])
    tt = np.concatenate([t, np.full(150, hub), leaves[150:]])
    out.append(("root_only_at_hub",
                np.concatenate([fixed, np.full(300, x), [0]]), ss, tt))
    return [(name, *(torch.from_numpy(np.array(a, np.int32))
                     for a in arrays)) for name, *arrays in out]


@pytest.mark.parametrize("case", _tails_and_root_witnesses(),
                         ids=lambda c: c[0])
def test_replay_on_tails_views_and_a_root_witness(case):
    """The replay, aligned (1, 3 and 1024 lanes) and not, gives the plain
    flag at every edge limit, on the edges and on the view that drops the
    first edge; the whole list is a witness."""
    _, L, s, d = case
    for src, dst in ((s, d), (s[1:], d[1:])):
        for k in range(len(src) + 1):
            want = bool(cv.converged_early_plain(L, src, dst, k))
            for aligned, lanes in ((True, 1), (True, 3), (True, 1024),
                                   (False, 1)):
                assert _replay(L, src, dst, k, aligned=aligned,
                               lanes=lanes) == want, (k, aligned, lanes)
    assert not _replay(L, s, d)


def test_replay_control_a_lane_that_trusts_an_unchecked_label_differs():
    """The control: a replay whose lanes take every label as checked (no
    root read after the first) passes labels one hop from their root,
    which the replay as shipped and the plain version fail."""
    # a star whose labels are all vertex 9, on no edge, whose own label is
    # 0: every edge is a witness by the root test alone
    s = torch.zeros(8, dtype=torch.int32)
    d = torch.arange(1, 9, dtype=torch.int32)
    L = torch.full((10,), 9, dtype=torch.int32)
    L[9] = 0
    assert not bool(cv.converged_early_plain(L, s, d))
    assert not _replay(L, s, d, lanes=1)

    def trusting(L_, w4, v4, n, checked):
        # each step as if its first edge's label had been checked already
        return _replay_step(L_, w4, v4, n, L_[w4[0]])

    assert _replay(L, s, d, lanes=1, step=trusting)


# the reference takes the first k edges padded with the self loop (0, 0)
# to M_PAD edges and the labels padded with roots to N_PAD vertices: under
# L <= iota vertex 0 is a root, so the padding adds no witness, and the
# reference compiles once
N_PAD, M_PAD = 40, 96


@jax.jit
def _ref_converged(L, s, d):
    return ref_mm.converged_early(L, s, d)


if HAS_HYPOTHESIS:
    from hypothesis import given, settings, strategies as st

    @st.composite
    def _warm_starts(draw):
        """(L, src, dst): a random multigraph on fewer than 40 vertices
        (self loops and repeats kept) and warm-start labels ``L <= iota``:
        a random parent below each vertex, the components' fixed point, or
        that fixed point with one vertex one hop from its root; then a
        chain of vertices on no edge, each one below the next (the
        predicate must not see it)."""
        n = draw(st.integers(1, 32))
        rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
        m = int(rng.integers(0, 3 * n + 1))
        src = rng.integers(0, n, m)
        dst = rng.integers(0, n, m)
        kind = draw(st.sampled_from(["parent", "fixed", "one_hop"]))
        if kind == "parent":
            L = np.minimum(np.arange(n), rng.integers(0, n, n))
        else:
            L = connected_components_oracle(src, dst, n).astype(np.int64)
            if kind == "one_hop":
                # v's label becomes u, a non-root of its component below v
                pairs = [(v, u) for v in range(n) for u in range(v)
                         if L[u] == L[v] and u != L[v]]
                if pairs:
                    v, u = pairs[rng.integers(len(pairs))]
                    L[v] = u
        chain = draw(st.integers(0, 7))
        L = np.concatenate([L, n + np.arange(chain)
                            - (np.arange(chain) > 0)])
        return (L.astype(np.int32), src.astype(np.int32),
                dst.astype(np.int32))

    @st.composite
    def _kernel_inputs(draw):
        """A warm start of :func:`_warm_starts`, and how the kernel meets
        it: maybe one edge id outside [0, n) (the kernel counts its edge as
        a witness), and the grid's lanes."""
        L, s, d = draw(_warm_starts())
        rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
        outside = len(s) > 0 and draw(st.booleans())
        if outside:
            e = int(rng.integers(len(s)))
            (s if rng.integers(2) else d)[e] = rng.choice(
                [-1, len(L), len(L) + 7])
        return L, s, d, outside, draw(st.sampled_from([1, 3, 32]))

    @settings(max_examples=150, deadline=None, derandomize=True)
    @given(_warm_starts())
    def test_plain_predicate_matches_the_reference_on_warm_starts(case):
        """``converged_early_plain`` gives the reference's flag
        (``repro.connectivity.minmap.converged_early``) at every edge limit
        from 0 to m, and so does the wrapper on CPU tensors."""
        L, s, d = case
        tL, ts, td = map(torch.from_numpy, (L, s, d))
        jL = np.arange(N_PAD, dtype=np.int32)
        jL[:len(L)] = L
        for k in range(len(s) + 1):
            js, jd = np.zeros((2, M_PAD), np.int32)
            js[:k], jd[:k] = s[:k], d[:k]
            want = bool(_ref_converged(jL, js, jd))
            assert bool(cv.converged_early_plain(tL, ts, td, k)) == want, k
            assert bool(cv.converged_early(tL, ts, td, k)) == want, k

    @settings(max_examples=150, deadline=None, derandomize=True)
    @given(_kernel_inputs())
    def test_replay_of_the_kernel_gives_the_plain_flag(case):
        """The replay (the kernel's vectors of 4 edges, its tail, the
        reused ``L[w]``, the root checked once a label a lane, and the
        scalar kernel) gives the plain predicate's flag at every edge
        limit; an edge with an id outside [0, n) is a witness (the plain
        version is not asked: it raises, or wraps a negative id)."""
        L, s, d, outside, lanes = case
        tL, ts, td = map(torch.from_numpy, (L, s, d))
        n = len(L)
        for k in range(len(s) + 1):
            cut = bool(((s[:k] < 0) | (s[:k] >= n) | (d[:k] < 0)
                        | (d[:k] >= n)).any())
            want = not cut and bool(cv.converged_early_plain(tL, ts, td, k))
            for aligned in (True, False):
                assert _replay(tL, ts, td, k, aligned=aligned,
                               lanes=lanes) == want, (k, aligned)
        assert outside or not cut
else:
    @pytest.mark.skip(reason="hypothesis not installed; the deterministic "
                             "replay tests above still ran")
    def test_plain_predicate_matches_the_reference_on_warm_starts():
        pass

    @pytest.mark.skip(reason="hypothesis not installed; the deterministic "
                             "replay tests above still ran")
    def test_replay_of_the_kernel_gives_the_plain_flag():
        pass
