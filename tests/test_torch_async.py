"""The in-order asynchronous sweep (``cuda_async``) against ``mm2_pallas``.

On the CPU the ``mm2`` wrapper runs its plain version; that is held bit
for bit (int32) against the reference's scalar Pallas kernel in interpret
mode, per sweep, from identity and mid-run labels, with and without an
``edge_limit``, and ``repro_torch.solve(g, backend="cuda_async")``
against ``repro.solve(g, backend="pallas")`` on the order-2 variants in
labels, iterations, converged and edges_visited.  The CUDA kernel itself
is checked against the plain version in ``test_torch_cuda.py``, whose
tests skip without a card.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.connectivity import minmap as ref_mm  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.kernels.contour_mm import ops as ref_ops  # noqa: E402
from repro.kernels.contour_mm import ref as ref_ref  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.connectivity.planner import heuristic_plan  # noqa: E402
from repro_torch.kernels import contour_mm  # noqa: E402
from repro_torch.kernels.contour_mm import kernel, ops, ref  # noqa: E402

GRAPHS = {
    "path800": lambda: ref_gen.path(800, seed=1),
    "rmat10": lambda: ref_gen.rmat(10, seed=5),
    "grid24": lambda: ref_gen.grid2d(24, 24),
}


@functools.lru_cache(maxsize=None)
def _states(gname):
    """numpy (src, dst, n, [identity labels, labels after one C-2
    iteration of the reference's scalar kernel])."""
    g = GRAPHS[gname]()
    s, d, n = g.to_numpy()
    L0 = jnp.arange(n, dtype=jnp.int32)
    L1 = ref_mm.pointer_jump(ref_ops.mm_relax_backend(
        L0, g.src, g.dst, backend="pallas", interpret=True))
    return s, d, n, [np.asarray(L0), np.asarray(L1)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(ref_out, port_out):
    port_out = port_out.numpy()
    ref_out = np.asarray(ref_out)
    assert port_out.dtype == ref_out.dtype == np.int32
    np.testing.assert_array_equal(port_out, ref_out)


def _pair(gname):
    s, d, n = GRAPHS[gname]().to_numpy()
    return (repro.Graph.from_numpy(s, d, n),
            interop.graph_from_arrays(s, d, n, device="cpu"))


def _same_result(ref, port):
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert int(port.iterations) == int(ref.iterations)
    assert bool(port.converged) == bool(ref.converged)
    assert (port.edges_visited.numpy().view(np.uint32)
            == np.asarray(ref.edges_visited).view(np.uint32))


# ---------------------------------------------------------------------------
# one sweep: mm2 against mm2_pallas (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_limit", [False, True])
@pytest.mark.parametrize("state", [0, 1])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_mm2_matches_pallas_interpret(gname, state, with_limit):
    s, d, n, states = _states(gname)
    L = states[state]
    limit = (2 * len(s)) // 3 if with_limit else None
    want = ref_ops.mm_relax_backend(
        jnp.asarray(L), jnp.asarray(s), jnp.asarray(d), backend="pallas",
        block_edges=512, interpret=True, edge_limit=limit)
    _eq(want, kernel.mm2(_t(L), _t(s), _t(d), edge_limit=limit))
    _eq(want, ops.mm_relax_backend(_t(L), _t(s), _t(d), backend="cuda_async",
                                   edge_limit=limit))
    if limit is None:
        _eq(want, ref.mm_block_ref(_t(s), _t(d), _t(L)))


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_mm2_matches_pallas_at_another_block_size(gname):
    """The reference pads to ``block_edges`` with (0, 0) edges; at 64 the
    padding and the grid differ from 512, and the sweep does not."""
    s, d, n, states = _states(gname)
    for L in states:
        want = ref_ops.contour_mm_step(jnp.asarray(s), jnp.asarray(d),
                                       jnp.asarray(L), backend="pallas",
                                       block_edges=64, interpret=True)
        _eq(want, kernel.mm2(_t(L), _t(s), _t(d)))


def test_mm2_depends_on_edge_order():
    """The asynchronous sweep is not the synchronous one: reversing the
    edges changes one sweep's labels, in both packages alike."""
    s, d, n, states = _states("path800")
    L = states[0]
    fwd = kernel.mm2(_t(L), _t(s), _t(d))
    rev = kernel.mm2(_t(L), _t(s[::-1]), _t(d[::-1]))
    assert not torch.equal(fwd, rev)
    _eq(ref_ref.mm_block_ref(jnp.asarray(s[::-1]), jnp.asarray(d[::-1]),
                             jnp.asarray(L)), rev)
    assert not torch.equal(fwd, ref.mm_sync_ref(_t(s), _t(d), _t(L)))


def test_zero_zero_padding_is_a_noop_when_label_0_is_0():
    """The reference masks the edges past ``edge_limit`` to (0, 0) and
    pads to ``block_edges`` with (0, 0); ``mm2`` does not visit them.  The
    two agree because ``L[0] == 0`` (``minmap.resolve_init_labels`` keeps
    ``L[v] <= v``).  Without it, a (0, 0) edge does change labels."""
    s, d, n, states = _states("rmat10")
    limit = len(s) // 2
    for L in states:
        assert L[0] == 0
        masked_s = np.where(np.arange(len(s)) < limit, s, 0).astype(np.int32)
        masked_d = np.where(np.arange(len(s)) < limit, d, 0).astype(np.int32)
        pad = np.zeros(37, np.int32)
        want = kernel.mm2(_t(L), _t(s), _t(d), edge_limit=limit)
        _eq(want, kernel.mm2(_t(L), _t(masked_s), _t(masked_d)))
        _eq(want, kernel.mm2(_t(L), _t(np.concatenate([masked_s, pad])),
                             _t(np.concatenate([masked_d, pad]))))
    # L[0] = 5, L[5] = 3: the self-loop at 0 lowers L[0] to 3
    bad = np.arange(8, dtype=np.int32)
    bad[0], bad[5] = 5, 3
    zero = torch.zeros(1, dtype=torch.int32)
    assert kernel.mm2(_t(bad), zero, zero).tolist()[0] == 3


def test_dropped_whole_l_ceiling_is_a_deliberate_deviation():
    """The reference's scalar kernel keeps all of L in VMEM and refuses
    n above ``(budget * 3 // 4) // 4`` (3,145,728 at 16 MiB).  The CUDA
    kernel reads L from device memory: the port takes any n."""
    s, d, n, states = _states("grid24")
    L = states[1]
    with pytest.raises(ValueError, match="ceiling"):
        ref_ops.mm_relax_backend(jnp.asarray(L), jnp.asarray(s),
                                 jnp.asarray(d), backend="pallas",
                                 interpret=True, vmem_limit_bytes=1024)
    _eq(ref_ref.mm_block_ref(jnp.asarray(s), jnp.asarray(d), jnp.asarray(L)),
        ops.mm_relax_backend(_t(L), _t(s), _t(d), backend="cuda_async"))
    # past the reference's default ceiling, a few edges
    big = 3_145_728 + 5
    with pytest.raises(ValueError, match="ceiling"):
        ref_ops.mm_relax_backend(jnp.arange(big, dtype=jnp.int32),
                                 jnp.asarray([big - 1], jnp.int32),
                                 jnp.asarray([3], jnp.int32),
                                 backend="pallas", interpret=True)
    out = ops.mm_relax_backend(torch.arange(big, dtype=torch.int32),
                               torch.tensor([big - 1], dtype=torch.int32),
                               torch.tensor([3], dtype=torch.int32),
                               backend="cuda_async")
    assert int(out[big - 1]) == 3
    assert not hasattr(repro_torch.SolveOptions(), "vmem_limit_bytes")


# ---------------------------------------------------------------------------
# solve(backend="cuda_async") against solve(backend="pallas")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["C-2", "C-m", "C-Syn"])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_solve_cuda_async_matches_pallas(gname, variant):
    ref_g, g = _pair(gname)
    ref_res = repro.solve(ref_g, backend="pallas", variant=variant)
    port = repro_torch.solve(g, backend="cuda_async", variant=variant)
    _same_result(ref_res, port)
    assert bool(port.converged)
    assert port.provenance == ("plan:cuda_async origin=pinned "
                               "schedule=masked fused=1 device=cpu",)


@pytest.mark.parametrize("variant", ["C-2", "C-Syn"])
def test_cuda_async_budget_run_and_warm_start_match_pallas(variant):
    ref_g, g = _pair("path800")
    ref_res = repro.solve(ref_g, backend="pallas", variant=variant,
                          max_iters=1)
    port = repro_torch.solve(g, backend="cuda_async", variant=variant,
                             max_iters=1)
    _same_result(ref_res, port)
    assert not bool(port.converged)
    rng = np.random.default_rng(3)
    es, ed = rng.integers(0, 810, 12), rng.integers(0, 810, 12)
    ref_next = repro.solve(ref_g.add_edges(es, ed, n_vertices=810),
                           backend="pallas", variant=variant,
                           warm_start=ref_res)
    port_next = repro_torch.solve(g.add_edges(es, ed, n_vertices=810),
                                  backend="cuda_async", variant=variant,
                                  warm_start=port)
    _same_result(ref_next, port_next)


@pytest.mark.parametrize("variant", ["C-1", "C-11mm", "C-1m1m", "C-3"])
def test_orders_other_than_2_raise_in_both_packages(variant):
    ref_g, g = _pair("grid24")
    with pytest.raises(ValueError, match="2-order only"):
        repro.solve(ref_g, backend="pallas", variant=variant)
    with pytest.raises(ValueError, match="2-order only"):
        repro_torch.solve(g, backend="cuda_async", variant=variant)


def test_auto_never_picks_cuda_async(monkeypatch):
    calls = []
    real = ops.mm2

    def spy(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)
    monkeypatch.setattr(ops, "mm2", spy)
    _, g = _pair("rmat10")
    assert heuristic_plan(g.n_vertices, g.n_edges, g.device).backend == "cuda"
    repro_torch.solve(g)
    assert calls == []
    repro_torch.solve(g, backend="cuda_async")
    assert calls and set(calls) == {g.n_vertices}


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------


def _i32(*ids):
    return torch.tensor(ids, dtype=torch.int32)


# ids outside [0, n) for n = 8; the plain version raises IndexError, as
# the kernel does on the card (test_torch_cuda.py)
OUT_OF_RANGE = [
    ("endpoint", lambda L: kernel.mm2(L, _i32(0, 8), _i32(1, 2))),
    ("negative_endpoint", lambda L: kernel.mm2(L, _i32(1), _i32(-1))),
    ("label", lambda L: kernel.mm2(torch.where(L == 3, 9, L), _i32(3),
                                   _i32(2))),
    # L[2] = 3, L[3] = -1: the first edge lowers L[2] to -1, and the
    # second follows it
    ("lowered_label", lambda L: kernel.mm2(_i32(0, 1, 3, -1, 4, 5, 6, 7),
                                           _i32(2, 2), _i32(2, 2))),
]


@pytest.mark.parametrize("name,call", OUT_OF_RANGE,
                         ids=[c[0] for c in OUT_OF_RANGE])
def test_mm2_plain_rejects_out_of_range_ids(name, call):
    with pytest.raises(IndexError, match=r"outside \[0, 8\)"):
        call(torch.arange(8, dtype=torch.int32))


def test_mm2_masked_out_ids_are_not_checked():
    L = torch.arange(8, dtype=torch.int32)
    got = kernel.mm2(L, _i32(2, 99), _i32(5, 0), edge_limit=1)
    assert got.tolist() == [0, 1, 2, 3, 4, 2, 6, 7]
    lowered = kernel.mm2(_i32(0, 1, 3, -1, 4, 5, 6, 7), _i32(2, 2),
                         _i32(2, 2), edge_limit=1)
    assert lowered.tolist() == [0, 1, -1, -1, 4, 5, 6, 7]
    # the input is not written
    assert L.tolist() == list(range(8))


def test_mm2_checks_its_inputs_and_counts_only_launches():
    contour_mm.reset_launch_counts()
    L = torch.arange(4, dtype=torch.int32)
    e = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        kernel.mm2(L.long(), e, e)
    with pytest.raises(ValueError, match="mismatch"):
        kernel.mm2(L, e, e[:1])
    meta = torch.arange(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernel.mm2(meta, e.to("meta"), e.to("meta"))
    with pytest.raises(ValueError, match="is on"):
        kernel.mm2(L, e.to("meta"), e)
    kernel.mm2(L, e, e)            # CPU tensors: the plain version
    assert [k.launches for k in contour_mm.KERNELS] == [0, 0, 0]
    assert kernel.SOURCES[0].exists()
