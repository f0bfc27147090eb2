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
