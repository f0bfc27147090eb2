"""The port's sweep kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain torch version; those are held bit
for bit (int32) against the reference's ``fused_relax_pallas`` and
``binned_scatter_min_pallas`` run in interpret mode, and against
``repro``'s ``mm_relax``.  The CUDA kernels themselves are checked against
the plain versions in ``test_torch_cuda.py``, whose tests skip without a
card (``python3 chip_smoke.py`` runs the same checks at full size).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.connectivity import minmap as ref_mm  # noqa: E402
from repro.connectivity.planner import heuristics as ref_heur  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.kernels.contour_mm import blocked as ref_blocked  # noqa: E402
from repro.kernels.contour_mm import ops as ref_ops  # noqa: E402
from repro.kernels.contour_mm import ref as ref_ref  # noqa: E402

from repro_torch.connectivity import minmap as mm  # noqa: E402
from repro_torch.connectivity.planner import heuristic_plan  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import contour_mm  # noqa: E402
from repro_torch.kernels.contour_mm import blocked, ops, ref  # noqa: E402


@jax.jit
def _ref_c2(L, s, d):
    return ref_mm.pointer_jump(ref_mm.mm_relax(L, s, d, 2))


@functools.lru_cache(maxsize=None)
def _states(scale, seed):
    """numpy (src, dst, [L identity, L after 1 C-2 step, after 2])."""
    g = ref_gen.rmat(scale, seed=seed)
    L = jnp.arange(g.n_vertices, dtype=jnp.int32)
    states = [np.array(L)]
    for _ in range(2):
        L = _ref_c2(L, g.src, g.dst)
        states.append(np.array(L))
    s, d, _ = g.to_numpy()
    return s, d, states


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(ref_out, port_out):
    port_out = port_out.numpy()
    ref_out = np.asarray(ref_out)
    assert port_out.dtype == ref_out.dtype == np.int32
    np.testing.assert_array_equal(port_out, ref_out)


# ---------------------------------------------------------------------------
# fused_relax (K1) vs fused_relax_pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_limit", [False, True])
@pytest.mark.parametrize("state", [0, 1, 2])
def test_fused_relax_matches_pallas_interpret(state, with_limit):
    s, d, states = _states(10, 2)          # n = 1024, m = 6104
    L = states[state]
    limit = (len(s) * 2) // 3 if with_limit else None
    want = ref_blocked.fused_relax_pallas(
        jnp.asarray(L), jnp.asarray(s), jnp.asarray(d), interpret=True,
        edge_limit=limit)
    got = blocked.fused_relax(_t(L), _t(s), _t(d), edge_limit=limit)
    _eq(want, got)
    if limit is not None:
        # the reference's (0, 0) masking and the port's skip agree because
        # L[0] == 0 under the L[v] <= v invariant; the limit is honoured
        assert L[0] == 0
        assert not np.array_equal(
            got.numpy(), blocked.fused_relax(_t(L), _t(s), _t(d)).numpy())


@pytest.mark.parametrize("limit", [None, 0, 1, 5000, 10 ** 9])
def test_fused_relax_matches_mm_relax_rmat12(limit):
    s, d, states = _states(12, 7)
    for L in states:
        rs, rd = jnp.asarray(s), jnp.asarray(d)
        if limit is not None:
            mask = jnp.arange(len(s)) < limit
            rs, rd = jnp.where(mask, rs, 0), jnp.where(mask, rd, 0)
        want = ref_mm.mm_relax(jnp.asarray(L), rs, rd, 2)
        _eq(want, blocked.fused_relax(_t(L), _t(s), _t(d), edge_limit=limit))
        if limit is None:
            _eq(want, ref.mm_sync_ref(_t(s), _t(d), _t(L)))


# ---------------------------------------------------------------------------
# scatter_min (K2) vs binned_scatter_min_pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_scatter_min_matches_pallas_interpret(order, with_valid):
    s, d, states = _states(10, 2)
    L = states[1]
    t, v = ref_mm.mm_update_stream(jnp.asarray(L), jnp.asarray(s),
                                   jnp.asarray(d), order)
    valid = None
    if with_valid:
        valid = np.random.default_rng(order).random(t.shape[0]) < 0.5
    want = ref_blocked.binned_scatter_min_pallas(
        jnp.asarray(L), t, v, interpret=True,
        valid=None if valid is None else jnp.asarray(valid))
    got = blocked.scatter_min(_t(L), _t(t), _t(v),
                              None if valid is None else _t(valid))
    _eq(want, got)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_scatter_min_matches_mm_relax_rmat12(order):
    s, d, states = _states(12, 7)
    for L in states:
        want = ref_mm.mm_relax(jnp.asarray(L), jnp.asarray(s),
                               jnp.asarray(d), order)
        t, v = mm.mm_update_stream(_t(L), _t(s), _t(d), order)
        _eq(want, blocked.scatter_min(_t(L), t, v))


# ---------------------------------------------------------------------------
# dispatch (ops.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "torch", "cuda"])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("limit", [None, 3000])
def test_mm_relax_backend_matches_reference(backend, order, limit):
    s, d, states = _states(10, 2)
    L = states[1]
    want = ref_ops.mm_relax_backend(
        jnp.asarray(L), jnp.asarray(s), jnp.asarray(d), order=order,
        backend="xla", edge_limit=limit)
    got = ops.mm_relax_backend(_t(L), _t(s), _t(d), order=order,
                               backend=backend, edge_limit=limit)
    _eq(want, got)
    if order == 2:
        unfused = ops.mm_relax_backend(_t(L), _t(s), _t(d), order=2,
                                       backend=backend, edge_limit=limit,
                                       fuse=False)
        _eq(want, unfused)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(ops, name)

    def spy(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)
    monkeypatch.setattr(ops, name, spy)
    return calls


def test_cuda_backend_routes_by_order(monkeypatch):
    fused = _spy(monkeypatch, "fused_relax")
    scatter = _spy(monkeypatch, "scatter_min")
    s, d, states = _states(10, 2)
    L = _t(states[0])
    ops.mm_relax_backend(L, _t(s), _t(d), order=2, backend="cuda")
    assert (len(fused), len(scatter)) == (1, 0)
    ops.mm_relax_backend(L, _t(s), _t(d), order=2, backend="cuda",
                         fuse=False)
    ops.mm_relax_backend(L, _t(s), _t(d), order=1, backend="auto")
    ops.mm_relax_backend(L, _t(s), _t(d), order=3, backend="cuda")
    assert (len(fused), len(scatter)) == (1, 3)
    ops.mm_relax_backend(L, _t(s), _t(d), order=2, backend="torch")
    assert (len(fused), len(scatter)) == (1, 3)


def test_fused_pass_has_no_single_tile_limit(monkeypatch):
    """Deliberate deviation from the reference: on the TPU the fused pass
    was limited to one VMEM tile (n <= 4096); on Hopper it carries every
    order-2 sweep at any n."""
    n_big = 1 << 13
    assert n_big > ref_heur.SINGLE_TILE_MAX_N
    assert not ref_heur.heuristic_plan(n_big, 8 * n_big,
                                       platform="tpu").fuse_relabel
    plan = heuristic_plan(n_big, 8 * n_big, torch.device("cpu"))
    assert plan.backend == "cuda" and plan.fuse_relabel
    fused = _spy(monkeypatch, "fused_relax")
    g = gen.rmat(13, seed=3, device="cpu")
    L = torch.arange(g.n_vertices, dtype=torch.int32)
    got = ops.mm_relax_backend(L, g.src, g.dst, order=2, backend="auto")
    assert fused == [n_big]
    _eq(ref_mm.mm_relax(jnp.asarray(L.numpy()), jnp.asarray(g.src.numpy()),
                        jnp.asarray(g.dst.numpy()), 2), got)


def test_dispatch_errors():
    L = torch.arange(4, dtype=torch.int32)
    e = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.mm_relax_backend(L, e, e, backend="xla")
    with pytest.raises(ValueError, match="order must be >= 1"):
        ops.mm_relax_backend(L, e, e, order=0, backend="cuda")


def test_contour_mm_step_and_fixpoint_match_reference():
    g = ref_gen.components_mix(
        [ref_gen.path(300, seed=1), ref_gen.star(200, seed=2)], seed=3)
    s, d, n = g.to_numpy()
    L0 = np.arange(n, dtype=np.int32)
    want = ref_ops.contour_mm_step(g.src, g.dst, jnp.asarray(L0),
                                   backend="xla")
    _eq(want, ops.contour_mm_step(_t(s), _t(d), _t(L0)))
    ref_out = ref_ops.contour_cc_fixpoint(g, backend="xla")
    port_g = gen.Graph.from_numpy(s, d, n, device="cpu")
    out = ops.contour_cc_fixpoint(port_g)
    _eq(ref_out[0], out[0])
    assert int(out[1]) == int(ref_out[1])
    assert bool(out[2]) == bool(ref_out[2])
    assert out[3].dtype == torch.float32
    assert out[3].item() == float(ref_out[3])
    # the frontier schedule, as the reference's bench fixpoint runs it
    ref_out = ref_ops.contour_cc_fixpoint(g, backend="xla", sampling=2,
                                          compact_every=2)
    out = ops.contour_cc_fixpoint(port_g, sampling=2, compact_every=2)
    _eq(ref_out[0], out[0])
    assert (int(out[1]), bool(out[2])) == (int(ref_out[1]), bool(ref_out[2]))
    assert out[3].item() == float(ref_out[3])



@pytest.mark.parametrize("order", [1, 3])
def test_fixpoint_other_orders_match_reference(order):
    g = ref_gen.components_mix(
        [ref_gen.path(300, seed=1), ref_gen.rmat(8, seed=2)], seed=3)
    ref_out = ref_ops.contour_cc_fixpoint(g, backend="xla", order=order)
    out = ops.contour_cc_fixpoint(
        gen.Graph.from_numpy(*g.to_numpy(), device="cpu"), order=order)
    _eq(ref_out[0], out[0])
    assert (int(out[1]), bool(out[2])) == (int(ref_out[1]), bool(ref_out[2]))
    assert out[3].item() == float(ref_out[3])

def test_block_ref_matches_reference():
    g = ref_gen.rmat(7, seed=4)
    s, d, n = g.to_numpy()
    L0 = np.arange(n, dtype=np.int32)
    _eq(ref_ref.mm_block_ref(g.src, g.dst, jnp.asarray(L0)),
        ref.mm_block_ref(_t(s), _t(d), _t(L0)))
    _eq(ref_ref.mm_sync_ref(g.src, g.dst, jnp.asarray(L0)),
        ref.mm_sync_ref(_t(s), _t(d), _t(L0)))


# ---------------------------------------------------------------------------
# the wrappers' contract
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_without_counting():
    contour_mm.reset_launch_counts()
    s, d, states = _states(10, 2)
    L = _t(states[0])
    blocked.fused_relax(L, _t(s), _t(d))
    blocked.scatter_min(L, _t(s), _t(d))
    assert blocked.fused_relax.launches == 0
    assert blocked.scatter_min.launches == 0
    # the input labels are never written
    np.testing.assert_array_equal(L.numpy(), states[0])


def test_wrappers_check_their_inputs():
    L = torch.arange(4, dtype=torch.int32)
    e = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        blocked.fused_relax(L.long(), e, e)
    with pytest.raises(TypeError, match="int32"):
        blocked.scatter_min(L, e.long(), e)
    with pytest.raises(ValueError, match="mismatch"):
        blocked.fused_relax(L, e, e[:1])
    with pytest.raises(ValueError, match="mismatch"):
        blocked.scatter_min(L, e, e[:1])
    with pytest.raises(TypeError, match="valid"):
        blocked.scatter_min(L, e, e, valid=e)
    # a device with no kernel and no plain version raises
    meta = torch.arange(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        blocked.fused_relax(meta, e.to("meta"), e.to("meta"))
    with pytest.raises(ValueError, match="is on"):
        blocked.fused_relax(L, e.to("meta"), e)



def _i32(*ids):
    return torch.tensor(ids, dtype=torch.int32)


# ids outside [0, n) for n = 8; the plain versions raise IndexError, as
# the kernels do on the card (test_torch_cuda.py)
OUT_OF_RANGE = [
    ("endpoint", lambda L: blocked.fused_relax(L, _i32(0, 8), _i32(1, 2))),
    ("negative_endpoint",
     lambda L: blocked.fused_relax(L, _i32(1), _i32(-1))),
    ("label", lambda L: blocked.fused_relax(torch.where(L == 3, 9, L),
                                            _i32(3), _i32(2))),
    ("target", lambda L: blocked.scatter_min(L, _i32(1, 8), _i32(0, 0))),
    ("negative_target",
     lambda L: blocked.scatter_min(L, _i32(-1), _i32(0))),
]


@pytest.mark.parametrize("name,call", OUT_OF_RANGE,
                         ids=[c[0] for c in OUT_OF_RANGE])
def test_plain_versions_reject_out_of_range_ids(name, call):
    with pytest.raises(IndexError, match=r"outside \[0, 8\)"):
        call(torch.arange(8, dtype=torch.int32))


def test_masked_out_ids_are_not_checked():
    L = torch.arange(8, dtype=torch.int32)
    # past edge_limit, or marked not valid: never followed, so no error
    got = blocked.fused_relax(L, _i32(2, 99), _i32(5, 0), edge_limit=1)
    assert got.tolist() == [0, 1, 2, 3, 4, 2, 6, 7]
    got = blocked.scatter_min(L, _i32(4, -5), _i32(1, 0),
                              valid=torch.tensor([True, False]))
    assert got.tolist() == [0, 1, 2, 3, 1, 5, 6, 7]

def test_build_key_follows_the_sources(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("// one\n")
    p1 = _build.library_path("x", [a])
    assert p1 == _build.library_path("x", [a])
    assert p1.parent == _build.BUILD_DIR and p1.name.startswith("libx-")
    a.write_text("// two\n")
    assert _build.library_path("x", [a]) != p1
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert all(p.exists() for p in blocked.SOURCES)
