"""The ``mm2`` kernel's protocol, replayed on the CPU, against the reference.

``kernel.mm2_pipelined_replay`` is the CUDA kernel's protocol in plain
Python: producers prefetch each window's four labels an edge as early as
the protocol allows, and one consumer takes every label read from its
cache, from a prefetch it can prove fresh, or from ``L``.  It must equal
the JAX package's ``ref.mm_block_ref`` and ``mm2_pallas`` (interpret
mode) bit for bit at every window, depth and cache size, from identity
and mid-run labels, in both edge orders; two controls that break the
protocol on purpose must not.  The kernel itself is held against
``mm2_plain`` on the card in ``test_torch_cuda.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.connectivity import minmap as ref_mm  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.kernels.contour_mm import ref as ref_ref  # noqa: E402
from repro.kernels.contour_mm.kernel import mm2_pallas  # noqa: E402

from repro_torch.kernels.contour_mm import kernel  # noqa: E402

GRAPHS = {
    "path_unshuffled": lambda: ref_gen.path(600, shuffle_ids=False),
    "path": lambda: ref_gen.path(600, seed=1),
    "star": lambda: ref_gen.star(400, seed=2),
    "grid": lambda: ref_gen.grid2d(16, 20),
    "rmat10": lambda: ref_gen.rmat(10, seed=5),
    "rmat11": lambda: ref_gen.rmat(11, seed=6),
    "rmat12": lambda: ref_gen.rmat(12, seed=7),
    "mix": lambda: ref_gen.components_mix(
        [ref_gen.path(200, seed=3), ref_gen.rmat(8, seed=4),
         ref_gen.star(50, seed=5)], seed=6),
}
# (window, depth, cache slots): from 1, where every prefetch is taken at
# its window's release and the cache holds one vertex, up to the defaults
SIZES = [(1, 1, 1), (1, 2, 1), (2, 1, 2), (3, 2, 1), (4, 4, 2), (5, 3, 4),
         (16, 4, 16), (kernel.WINDOW, kernel.DEPTH, kernel.CACHE_SLOTS)]
ORDERS = ("forward", "reversed")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


@functools.lru_cache(maxsize=None)
def _case(gname, state, order):
    """numpy (src, dst, L) and the reference's sweep, from ``mm_block_ref``
    and from ``mm2_pallas`` in interpret mode (one block of all edges, so
    that no (0, 0) padding is swept), which must agree."""
    s, d, n = GRAPHS[gname]().to_numpy()
    L = jnp.arange(n, dtype=jnp.int32)
    if state == "mid_run":
        L = ref_mm.pointer_jump(ref_mm.mm_relax(L, jnp.asarray(s),
                                                jnp.asarray(d), 2))
    if order == "reversed":
        s, d = s[::-1].copy(), d[::-1].copy()
    return s, d, np.asarray(L), _reference(s, d, np.asarray(L))


def _reference(s, d, L):
    want = np.asarray(ref_ref.mm_block_ref(jnp.asarray(s), jnp.asarray(d),
                                           jnp.asarray(L)))
    pallas = np.asarray(mm2_pallas(jnp.asarray(s), jnp.asarray(d),
                                   jnp.asarray(L), block_edges=len(s),
                                   interpret=True))
    np.testing.assert_array_equal(pallas, want)
    return want


def _replay(s, d, L, size, limit=None, **controls):
    window, depth, slots = size
    got, counts = kernel.mm2_pipelined_replay(
        _t(L), _t(s), _t(d), limit, window=window, depth=depth,
        cache_slots=slots, **controls)
    assert got.dtype == torch.int32
    return got.numpy(), counts


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_replay_matches_reference(gname, size):
    for state in ("identity", "mid_run"):
        for order in ORDERS:
            s, d, L, want = _case(gname, state, order)
            got, counts = _replay(s, d, L, size)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{state} {order}")
            # every edge reads four labels, each from one place
            assert sum(counts.values()) == 4 * len(s)
            if size[:2] == (1, 1):
                # released one edge before it is walked: always fresh
                assert counts["global_loads"] == 0


@pytest.mark.parametrize("size", SIZES, ids=str)
def test_replay_edge_limit_mid_window(size):
    window = size[0]
    for gname in ("path_unshuffled", "rmat10"):
        s, d, L, _ = _case(gname, "mid_run", "forward")
        limit = (len(s) // 2 // window) * window + max(1, window // 2)
        want = _reference(s[:limit], d[:limit], L)
        got, counts = _replay(s, d, L, size, limit=limit)
        np.testing.assert_array_equal(got, want)
        assert sum(counts.values()) == 4 * limit
        np.testing.assert_array_equal(
            _replay(s, d, L, size, limit=torch.tensor(limit))[0], want)


@pytest.mark.parametrize("size", SIZES, ids=str)
def test_replay_short_and_ragged_edge_lists(size):
    """m below one window, and m not a multiple of the window."""
    window = size[0]
    s, d, L, _ = _case("grid", "identity", "forward")
    for m in sorted({1, 5, max(1, window - 1), window + 1,
                     3 * window + 17}):
        want = _reference(s[:m], d[:m], L)
        np.testing.assert_array_equal(_replay(s[:m], d[:m], L, size)[0],
                                      want)


def _aliasing_list(seed):
    """Self-loops, duplicate edges, w == v, and v == L[w] (so lw == v):
    labels below the ids as the solver keeps them."""
    rng = np.random.default_rng(seed)
    n = 48
    L = np.array([rng.integers(0, i + 1) for i in range(n)], np.int32)
    w = rng.integers(0, n, 300).astype(np.int32)
    kind = rng.integers(0, 4, 300)
    v = np.where(kind == 0, w, np.where(kind == 1, L[w],
                                        rng.integers(0, n, 300))).astype(
        np.int32)
    dup = rng.integers(0, 300, 60)
    return (np.concatenate([w, w[dup], v[:40]]),
            np.concatenate([v, v[dup], w[:40]]), L)


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_on_self_loops_duplicates_and_aliasing(seed, size):
    s, d, L = _aliasing_list(seed)
    np.testing.assert_array_equal(_replay(s, d, L, size)[0],
                                  _reference(s, d, L))


def test_trust_prefetch_control_differs_on_the_unshuffled_path():
    """Taking a prefetched label without the cache and the freshness test
    misses the label the edge before lowered: in the path's order each
    edge (i, i + 1) reads L[i], which edge (i - 1, i) just wrote."""
    s, d, L, want = _case("path_unshuffled", "identity", "forward")
    size = (kernel.WINDOW, kernel.DEPTH, kernel.CACHE_SLOTS)
    assert not np.array_equal(
        _replay(s, d, L, size, trust_prefetch=True)[0], want)
    np.testing.assert_array_equal(_replay(s, d, L, size)[0], want)


def test_skip_window_check_control_differs_with_a_small_cache():
    """Without the slot's write window, a prefetch of a vertex whose write
    left the cache with another vertex counts as fresh."""
    s, d, L, want = _case("path", "identity", "forward")
    for size in [(16, 4, 16), (4, 4, 2)]:
        assert not np.array_equal(
            _replay(s, d, L, size, skip_window_check=True)[0], want)
        np.testing.assert_array_equal(_replay(s, d, L, size)[0], want)


def test_replay_and_launcher_check_their_arguments():
    L = torch.arange(8, dtype=torch.int32)
    e = torch.tensor([0, 1], dtype=torch.int32)
    for bad in ({"window": 0}, {"depth": 0}, {"cache_slots": 3},
                {"cache_slots": 0}):
        with pytest.raises(ValueError):
            kernel.mm2_pipelined_replay(L, e, e, **bad)
    with pytest.raises(IndexError, match=r"outside \[0, 8\)"):
        kernel.mm2_pipelined_replay(L, torch.tensor([0, 8],
                                                    dtype=torch.int32), e)
    # the launcher takes CUDA tensors only: mm2() runs the plain version
    # on CPU tensors, and the kernel has no CPU mode
    launches = kernel.mm2.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.sweep(L, e, e)
    assert kernel.mm2.launches == launches
