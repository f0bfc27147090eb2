"""``repro_torch.solve`` against ``repro.solve``, bit for bit.

Same graphs (built once with numpy and handed to both packages), every
Contour variant; ``labels``, ``iterations``, ``converged`` and
``edges_visited`` must be identical.  Plus warm starts carried across
through ``repro_torch.interop``, the result views and option errors.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.connectivity import SolveOptions, contour, minmap  # noqa: E402
from repro_torch.kernels.contour_mm import ops  # noqa: E402

VARIANTS = ("C-Syn", "C-1", "C-2", "C-m", "C-11mm", "C-1m1m", "C-3")
ISOLATED = 3   # isolated vertices appended to every graph

# the four trees share (n, m) = (300, 299), so the reference compiles one
# program per variant for all of them
GRAPHS = {
    "path": lambda: ref_gen.path(300, seed=1),
    "cycle": lambda: ref_gen.cycle(200, seed=2),
    "star": lambda: ref_gen.star(300, seed=3),
    "caterpillar": lambda: ref_gen.caterpillar(100, 2, seed=4),
    "grid": lambda: ref_gen.grid2d(12, 15),
    "delaunay10": lambda: ref_gen.delaunay_like(10),
    "rmat10": lambda: ref_gen.rmat(10, seed=5),
    "erdos_renyi": lambda: ref_gen.erdos_renyi(300, avg_degree=1.5, seed=7),
    "random_tree": lambda: ref_gen.random_tree(300, seed=8),
    "components_mix": lambda: ref_gen.components_mix(
        [ref_gen.path(60, seed=9), ref_gen.star(40, seed=10),
         ref_gen.rmat(7, seed=11)], seed=12),
}


@functools.lru_cache(maxsize=None)
def _arrays(gname):
    """numpy (src, dst, n) of a graph, with isolated vertices appended."""
    if gname == "self_loop":
        return np.array([2], np.int32), np.array([2], np.int32), 4
    s, d, n = GRAPHS[gname]().to_numpy()
    return s, d, n + ISOLATED


def _pair(gname):
    s, d, n = _arrays(gname)
    return (repro.Graph.from_numpy(s, d, n),
            interop.graph_from_arrays(s, d, n, device="cpu"))


def _assert_same(ref, port):
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert port.labels.dtype == torch.int32
    assert port.iterations.dtype == torch.int32
    assert port.converged.dtype == torch.bool
    assert port.edges_visited.dtype == torch.float32
    assert int(port.iterations) == int(ref.iterations)
    assert bool(port.converged) == bool(ref.converged)
    # bit-identical float32 work counters
    assert (port.edges_visited.numpy().view(np.uint32)
            == np.asarray(ref.edges_visited).view(np.uint32))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("gname", sorted(GRAPHS) + ["self_loop"])
def test_solve_matches_reference(gname, variant):
    ref_g, g = _pair(gname)
    ref = repro.solve(ref_g, variant=variant)
    port = repro_torch.solve(g, variant=variant)
    _assert_same(ref, port)
    assert bool(port.converged)
    assert port.labels.device.type == "cpu"


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_backends_agree_on_default_options(backend):
    ref_g, g = _pair("components_mix")
    ref = repro.solve(ref_g)
    _assert_same(ref, repro_torch.solve(g, backend=backend))


def test_default_solve_records_the_plan():
    _, g = _pair("rmat10")
    res = repro_torch.solve(g)
    assert res.provenance == ("plan:cuda origin=heuristic schedule=masked "
                              "fused=1 device=cpu",)
    pinned = repro_torch.solve(g, backend="torch")
    assert pinned.provenance[0].startswith("plan:torch origin=pinned")


@pytest.mark.parametrize("variant", ["C-2", "C-Syn", "C-1"])
def test_budget_run_reports_not_converged(variant):
    ref_g, g = _pair("path")
    ref = repro.solve(ref_g, variant=variant, max_iters=2)
    port = repro_torch.solve(g, SolveOptions(variant=variant, max_iters=2))
    _assert_same(ref, port)
    assert not bool(port.converged)
    assert int(port.iterations) == 2


def test_warm_start_from_reference_labels_through_interop():
    s, d, n = _arrays("components_mix")
    rng = np.random.default_rng(0)
    extra_s = rng.integers(0, n, 6)
    extra_d = rng.integers(0, n, 6)
    ref_g = repro.Graph.from_numpy(s, d, n)
    ref_first = repro.solve(ref_g)
    ref_next = repro.solve(ref_g.add_edges(extra_s, extra_d),
                           warm_start=ref_first)
    carried = interop.result_from_arrays(
        np.asarray(ref_first.labels), np.asarray(ref_first.iterations),
        np.asarray(ref_first.converged), np.asarray(ref_first.edges_visited),
        device="cpu")
    _assert_same(ref_first, carried)
    g = interop.graph_from_arrays(s, d, n, device="cpu")
    port_next = repro_torch.solve(g.add_edges(extra_s, extra_d),
                                  warm_start=carried)
    _assert_same(ref_next, port_next)
    # the same through SolveOptions.warm_start and a raw label array
    via_opts = repro_torch.solve(
        g.add_edges(extra_s, extra_d),
        SolveOptions(warm_start=np.asarray(ref_first.labels)))
    _assert_same(ref_next, via_opts)


def test_warm_start_from_a_shorter_array_after_growth():
    s, d, n = _arrays("rmat10")
    grow_s = np.array([0, n + 1, n + 4], np.int64)
    grow_d = np.array([n + 2, n + 3, 5], np.int64)
    ref_g = repro.Graph.from_numpy(s, d, n)
    ref_first = repro.solve(ref_g)
    ref_next = repro.solve(ref_g.add_edges(grow_s, grow_d, n_vertices=n + 8),
                           warm_start=ref_first)
    g = interop.graph_from_arrays(s, d, n, device="cpu")
    first = repro_torch.solve(g)
    _assert_same(ref_first, first)
    port_next = repro_torch.solve(g.add_edges(grow_s, grow_d,
                                              n_vertices=n + 8),
                                  warm_start=first)
    _assert_same(ref_next, port_next)
    assert port_next.labels.shape[0] == n + 8


def test_interop_takes_numpy_only():
    with pytest.raises(TypeError, match="numpy"):
        interop.graph_from_arrays(jnp.arange(3), np.arange(3), 4,
                                  device="cpu")
    with pytest.raises(TypeError, match="numpy"):
        interop.result_from_arrays([0, 1], 1, True, device="cpu")
    with pytest.raises(TypeError, match="numpy"):
        interop.result_from_arrays(np.arange(2), jnp.int32(1), True,
                                   device="cpu")


def test_result_views_match_reference():
    ref_g, g = _pair("components_mix")
    ref = repro.solve(ref_g)
    port = repro_torch.solve(g)
    assert port.n_components == ref.n_components
    np.testing.assert_array_equal(port.compact_labels(), ref.compact_labels())
    np.testing.assert_array_equal(port.component_sizes(),
                                  ref.component_sizes())
    n = g.n_vertices
    u = np.arange(n)
    v = np.arange(n)[::-1].copy()
    np.testing.assert_array_equal(port.same_component(u, v),
                                  ref.same_component(u, v))
    assert port.same_component(0, 1) == ref.same_component(0, 1)
    assert isinstance(port.same_component(0, 1), bool)
    np.testing.assert_array_equal(port.component_of(u), ref.component_of(u))
    assert port.component_of(n - 1) == ref.component_of(n - 1)
    for bad in (-1, n, np.array([0, n + 5])):
        with pytest.raises(IndexError):
            ref.component_of(bad)
        with pytest.raises(IndexError):
            port.component_of(bad)
        with pytest.raises(IndexError):
            port.same_component(0, bad)


BAD_OPTIONS = [
    ({"backend": "xla"}, ValueError, "backend"),
    ({"backend": "pallas_blocked"}, ValueError, "backend"),
    ({"max_iters": 0}, ValueError, "max_iters"),
    ({"warmup": -1}, ValueError, "warmup"),
    ({"async_compress": -1}, ValueError, "async_compress"),
    ({"sampling": -1}, ValueError, "sampling"),
    ({"compact_every": -2}, ValueError, "compact_every"),
    ({"variant": "C-7x"}, ValueError, "unknown variant"),
    # the reference's family the port still leaves out ("auto" is
    # registered since)
    ({"algorithm": "distributed"}, ValueError, "unknown algorithm"),
    ({"algorithm": "oocore", "variant": "C-Syn"}, ValueError, "C-Syn"),
    ({"sampling": 2, "variant": "C-Syn"}, ValueError, "C-Syn"),
    ({"compact_every": 4, "variant": "C-Syn"}, ValueError, "C-Syn"),
    ({"sampling_strategy": "nope"}, ValueError, "sampling_strategy"),
    ({"sampling_k": 0}, ValueError, "sampling_k"),
    ({"backend": "cuda_async", "variant": "C-1"}, ValueError,
     "2-order only"),
]


@pytest.mark.parametrize("overrides,err,match", BAD_OPTIONS,
                         ids=[str(b[0]) for b in BAD_OPTIONS])
def test_option_errors(overrides, err, match):
    _, g = _pair("path")
    with pytest.raises(err, match=match):
        repro_torch.solve(g, **overrides)


# the reference's fields the port leaves out: setting one is an error
# ("plan" is ported since, and checked below as the pinned plan it is)
OMITTED = ["mesh", "edge_axes", "local_rounds", "plan", "kernel_fallback",
           "vmem_limit_bytes"]
PINNED_PLAN = "plan"
# the reference's out-of-core fields, ported since: the reference's
# defaults, and a value it refuses fails as loudly
PORTED = {"oocore_chunk_edges": 512, "oocore_round_cap": 0,
          "oocore_local_iters": 0}


@pytest.mark.parametrize("field", OMITTED + sorted(PORTED))
def test_omitted_fields_fail_loudly(field):
    assert field in {f.name for f in dataclasses.fields(repro.SolveOptions)}
    _, g = _pair("path")
    if field in PORTED:
        assert getattr(SolveOptions(), field) == \
            getattr(repro.SolveOptions(), field)
        with pytest.raises(ValueError, match=field):
            repro.SolveOptions(**{field: PORTED[field]}).validate()
        with pytest.raises(ValueError, match=field):
            repro_torch.solve(g, **{field: PORTED[field]})
        return
    if field == PINNED_PLAN:
        # the reference's default, and anything but a plan fails loudly
        assert SolveOptions().plan is None and repro.SolveOptions().plan \
            is None
        with pytest.raises(TypeError, match="ExecutionPlan"):
            repro_torch.solve(g, plan="pallas")
        return
    with pytest.raises(TypeError):
        SolveOptions(**{field: None})
    with pytest.raises(TypeError):
        repro_torch.solve(g, **{field: None})


def test_other_solve_errors():
    _, g = _pair("path")
    with pytest.raises(TypeError, match="SolveOptions"):
        repro_torch.solve(g, options={"variant": "C-2"})
    with pytest.raises(ValueError, match=">= 0"):
        repro_torch.solve(g, warm_start=np.full(g.n_vertices, -1))
    with pytest.raises(ValueError, match="1-D"):
        repro_torch.solve(g, warm_start=np.zeros((2, 2), np.int32))
    assert repro_torch.list_solvers() == ("auto", "contour", "fastsv",
                                          "label_propagation", "oocore",
                                          "union_find")


@pytest.mark.parametrize("it", [1, 3, 7, 29, 100])
@pytest.mark.parametrize("m", [2 ** 24 + 1, 3 * 2 ** 24 + 7, 61_234_567])
def test_edges_visited_is_a_float32_product(it, m):
    """``it * m`` past 2**24 rounds as the reference's float32 multiply."""
    want = np.asarray(jnp.int32(it).astype(jnp.float32) * m)
    got = ops.edges_visited(it, m, "cpu").numpy()
    assert got.view(np.uint32) == want.view(np.uint32)


def test_one_extra_step_after_convergence_changes_nothing():
    """At the reported iteration the labels are final: a further C-2
    step (and the final jump) leaves them as they are."""
    for gname in ("path", "rmat10", "grid", "components_mix"):
        _, g = _pair(gname)
        res = repro_torch.solve(g)
        step = contour._make_step("C-2", 2, 1, "cuda")
        again = minmap.pointer_jump(
            step(res.labels, int(res.iterations), g.src, g.dst))
        assert torch.equal(again, res.labels)
