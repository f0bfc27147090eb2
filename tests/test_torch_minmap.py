"""The port's min-mapping operators against ``repro.connectivity.minmap``.

Same graphs, same label states (identity and two mid-run states of the
reference's C-2 loop), compared bit for bit (int32).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.connectivity import minmap as ref_mm  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402

from repro_torch.connectivity import minmap as mm  # noqa: E402

GRAPHS = {
    "rmat10": lambda: ref_gen.rmat(10),
    "grid40": lambda: ref_gen.grid2d(40, 40),
    "star2000": lambda: ref_gen.star(2000),
    "path800": lambda: ref_gen.path(800),
}
STATES = (0, 1, 2)   # reference C-2 iterations run before the state

# the reference functions, jitted whole: one compile per shape instead of
# one per primitive keeps this file fast on the CPU
@jax.jit
def _ref_c2(L, s, d):
    return ref_mm.pointer_jump(ref_mm.mm_relax(L, s, d, 2))


@functools.partial(jax.jit, static_argnums=3)
def _ref_sweep(L, s, d, order):
    t, v = ref_mm.mm_update_stream(L, s, d, order)
    return (t, v, ref_mm.mm_relax(L, s, d, order),
            ref_mm.gather_chain(L, s, order))


@jax.jit
def _ref_predicates(L, s, d):
    nL = _ref_c2(L, s, d)
    return (ref_mm.pointer_jump(L, 1), ref_mm.pointer_jump(L, 2),
            ref_mm.converged_early(L, s, d), ref_mm.is_star_forest(L),
            nL, ref_mm.converged_early(nL, s, d), ref_mm.is_star_forest(nL))


@functools.lru_cache(maxsize=None)
def _case(gname, state):
    """(numpy src, dst, L) for a graph and a label state."""
    g = GRAPHS[gname]()
    L = jnp.arange(g.n_vertices, dtype=jnp.int32)
    for _ in range(state):
        L = _ref_c2(L, g.src, g.dst)
    s, d, _ = g.to_numpy()
    return s, d, np.array(L)


def _both(gname, state):
    s, d, L = _case(gname, state)
    ref = (jnp.asarray(L), jnp.asarray(s), jnp.asarray(d))
    port = (torch.from_numpy(L.copy()), torch.from_numpy(s.copy()),
            torch.from_numpy(d.copy()))
    return ref, port


def _eq(ref, port):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype
    np.testing.assert_array_equal(port, ref)


pytestmark = pytest.mark.parametrize("gname", sorted(GRAPHS))


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("order", [1, 2, 3])
def test_mm_update_stream_and_relax(gname, state, order):
    (rL, rs, rd), (L, s, d) = _both(gname, state)
    rt, rv, r_relax, r_chain = _ref_sweep(rL, rs, rd, order)
    t, v = mm.mm_update_stream(L, s, d, order)
    _eq(rt, t)
    _eq(rv, v)
    _eq(r_relax, mm.mm_relax(L, s, d, order))
    for a, b in zip(r_chain,
                    mm.gather_chain(L, s, order)):
        _eq(a, b)


@pytest.mark.parametrize("state", STATES)
def test_pointer_jump_and_predicates(gname, state):
    (rL, rs, rd), (L, s, d) = _both(gname, state)
    jump1, jump2, conv, star, nrL, nconv, nstar = _ref_predicates(rL, rs, rd)
    _eq(jump1, mm.pointer_jump(L, 1))
    _eq(jump2, mm.pointer_jump(L, 2))
    assert bool(mm.converged_early(L, s, d)) == bool(conv)
    assert bool(mm.is_star_forest(L)) == bool(star)
    # one C-2 step on: the predicates see a state that moved
    nL = mm.pointer_jump(mm.mm_relax(L, s, d, 2))
    _eq(nrL, nL)
    assert bool(mm.converged_early(nL, s, d)) == bool(nconv)
    assert bool(mm.is_star_forest(nL)) == bool(nstar)


def test_resolve_init_labels(gname):
    s, d, L = _case(gname, 1)
    n = L.shape[0]
    cases = {
        "identity": None,
        "mid_run": L,
        "shorter": L[: n // 2],
        "clamped": np.minimum(L + 7, n - 1).astype(np.int32)[::-1].copy(),
    }
    for name, init in cases.items():
        ref = ref_mm.resolve_init_labels(
            None if init is None else jnp.asarray(init), n, jnp.int32)
        port = mm.resolve_init_labels(
            None if init is None else torch.from_numpy(init), n, "cpu")
        _eq(ref, port)
    bad = L.copy()
    bad[3] = -2
    with pytest.raises(ValueError, match=">= 0") as ref_err:
        ref_mm.resolve_init_labels(jnp.asarray(bad), n, jnp.int32)
    with pytest.raises(ValueError, match=">= 0") as port_err:
        mm.resolve_init_labels(torch.from_numpy(bad), n, "cpu")
    assert "minimum -2" in str(ref_err.value)
    assert "minimum -2" in str(port_err.value)
    too_long = np.arange(n + 1, dtype=np.int32)
    with pytest.raises(ValueError, match="cover"):
        ref_mm.resolve_init_labels(jnp.asarray(too_long), n, jnp.int32)
    with pytest.raises(ValueError, match="cover"):
        mm.resolve_init_labels(torch.from_numpy(too_long), n, "cpu")


def test_order_check(gname):
    _, (L, s, d) = _both(gname, 0)
    with pytest.raises(ValueError, match="order must be >= 1"):
        mm.mm_update_stream(L, s, d, 0)
