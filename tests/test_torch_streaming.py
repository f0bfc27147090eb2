"""The port's streaming connectivity against the JAX package's, bit for bit.

``repro_torch.StreamingConnectivity`` on CPU tensors is held against
``repro.StreamingConnectivity`` after every batch: the whole
``state_dict()`` (labels at capacity, the edge store, the sizes and the
counters, float32 ``edges_visited`` by its bits) must be identical, for
several batchings, variants, vertex growth, ``store_edges=False``, empty
batches, a budget of one iteration followed by ``resolve()``, and the
rollback at both fault sites.  ``frontier.adaptive_fixpoint`` with
``active_m0`` and ``streaming.delta_converge`` are held against the
reference's directly, and the registry's capability flags against the
reference's registry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.connectivity import contour as ref_contour  # noqa: E402
from repro.connectivity import frontier as ref_fr  # noqa: E402
from repro.connectivity import registry as ref_registry  # noqa: E402
from repro.connectivity import streaming as ref_streaming  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.oracle import connected_components_oracle  # noqa: E402
from repro.runtime import recovery as ref_recovery  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.connectivity import contour, frontier as fr  # noqa: E402
from repro_torch.connectivity import minmap, registry, streaming  # noqa: E402
from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402
from repro_torch.runtime import FaultInjector, SimulatedFault  # noqa: E402

CPU = "cpu"


def _port(n, **kw):
    return repro_torch.StreamingConnectivity(n, device=CPU, **kw)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same_state(ref, port):
    """Both engines' state dicts, key by key: dtypes, shapes and bits."""
    rs, ps = ref.state_dict(), port.state_dict()
    assert sorted(rs) == sorted(ps)
    for key in rs:
        a, b = np.asarray(rs[key]), _host(ps[key])
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        assert a.shape == b.shape, (key, a.shape, b.shape)
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=key)
    assert port.n_components == ref.n_components


def _shuffled(graph, seed):
    src, dst, n = graph.to_numpy()
    perm = np.random.default_rng(seed).permutation(src.shape[0])
    return src[perm], dst[perm], n


def _slices(m, n_batches):
    return [slice(b * m // n_batches, (b + 1) * m // n_batches)
            for b in range(n_batches)]


GRAPHS = {
    "path": lambda: ref_gen.path(2000, seed=3),
    "rmat": lambda: ref_gen.rmat(10, seed=5),
    "mix": lambda: ref_gen.components_mix(
        [ref_gen.path(300, seed=1), ref_gen.star(200, seed=2),
         ref_gen.grid2d(12, 12)], seed=7),
}


@pytest.mark.parametrize("n_batches", (1, 7, 32))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_stream_equals_reference_after_every_batch(graph, n_batches):
    src, dst, n = _shuffled(GRAPHS[graph](), seed=n_batches)
    ref, port = repro.StreamingConnectivity(n), _port(n)
    for sl in _slices(len(src), n_batches):
        ref.ingest(src[sl], dst[sl])
        port.ingest(src[sl], dst[sl])
        same_state(ref, port)
    assert bool(port.snapshot().converged)
    np.testing.assert_array_equal(
        port.labels.numpy(), connected_components_oracle(src, dst, n))


@pytest.mark.parametrize("variant", ("C-2", "C-m", "C-11mm", "C-1"))
def test_variants_equal_reference(variant):
    src, dst, n = _shuffled(ref_gen.rmat(9, seed=2), seed=4)
    ref = repro.StreamingConnectivity(n, variant=variant)
    port = _port(n, variant=variant)
    for sl in _slices(len(src), 5):
        ref.ingest(src[sl], dst[sl])
        port.ingest(src[sl], dst[sl])
        same_state(ref, port)


@pytest.mark.parametrize("options", (dict(sampling=2),
                                     dict(compact_every=2),
                                     dict(backend="torch")))
def test_frontier_options_equal_reference(options):
    ref_options = {k: ("xla" if v == "torch" else v)
                   for k, v in options.items()}
    src, dst, n = _shuffled(ref_gen.rmat(9, seed=3), seed=5)
    ref = repro.StreamingConnectivity(n, **ref_options)
    port = _port(n, **options)
    for sl in _slices(len(src), 4):
        ref.ingest(src[sl], dst[sl])
        port.ingest(src[sl], dst[sl])
        same_state(ref, port)


def test_c_syn_and_non_streaming_solvers_rejected():
    for kw in (dict(variant="C-Syn"),):
        with pytest.raises(ValueError, match="C-Syn"):
            _port(4, **kw)
        with pytest.raises(ValueError, match="C-Syn"):
            repro.StreamingConnectivity(4, **kw)
    for algorithm in ("fastsv", "union_find", "lp"):
        with pytest.raises(ValueError, match="does not support streaming"):
            _port(4, algorithm=algorithm)


def test_vertex_growth_equals_reference():
    rng = np.random.default_rng(1)
    ref = repro.StreamingConnectivity(4, min_capacity=4)
    port = _port(4, min_capacity=4)
    n = 4
    for grow in (0, 3, 1, 9, 0, 40, 2):
        n += grow
        src = rng.integers(0, n, 5)
        dst = rng.integers(0, n, 5)
        ref.ingest(src, dst, n_vertices=n)
        port.ingest(src, dst, n_vertices=n)
        same_state(ref, port)
        assert port.vertex_capacity == ref.vertex_capacity
        assert port.capacity == ref.capacity
    g = port.graph()
    assert g.n_edges == port.n_edges and g.n_vertices == n
    with pytest.raises(ValueError, match="shrinks"):
        port.ingest([0], [1], n_vertices=3)


def test_store_edges_false_equals_reference():
    src, dst, n = _shuffled(ref_gen.rmat(8, seed=6), seed=2)
    ref = repro.StreamingConnectivity(n, store_edges=False)
    port = _port(n, store_edges=False)
    for sl in _slices(len(src), 6):
        ref.ingest(src[sl], dst[sl])
        port.ingest(src[sl], dst[sl])
        same_state(ref, port)
    assert port.capacity == 0
    for call in (port.graph, port.resolve):
        with pytest.raises(ValueError, match="store_edges=False"):
            call()


def test_empty_batches_validation_and_queries():
    ref, port = repro.StreamingConnectivity(5), _port(5)
    for eng in (ref, port):
        eng.ingest([], [])
        eng.ingest([0, 1], [1, 2])
        eng.ingest([], [], n_vertices=10)
    same_state(ref, port)
    assert port.n_batches == 1 and port.n_components == 8
    assert port.component_of(9) == 9
    assert port.same_component(0, 2) and not port.same_component(0, 3)
    with pytest.raises(ValueError, match="n_vertices"):
        port.ingest([0], [17])
    with pytest.raises(ValueError, match=">= 0"):
        port.ingest([-1], [0])
    with pytest.raises(ValueError, match="equal-length"):
        port.ingest([0, 1], [1])
    for call in (lambda: port.component_of(-1),
                 lambda: port.component_of(10),
                 lambda: port.same_component(0, 10)):
        with pytest.raises(IndexError):
            call()
    # tensors are accepted and bounds-checked too
    with pytest.raises(ValueError, match="n_vertices"):
        port.ingest(torch.tensor([0]), torch.tensor([10]))
    port.ingest(torch.tensor([3]), torch.tensor([9]))
    ref.ingest(np.array([3]), np.array([9]))
    same_state(ref, port)
    port.ingest_graph(repro_torch.Graph.from_numpy(
        np.arange(11), np.arange(1, 12), 12, device=CPU))
    assert port.n_vertices == 12 and port.n_components == 1


def test_budget_of_one_then_resolve_equals_reference():
    src = np.arange(999)
    dst = np.arange(1, 1000)
    perm = np.random.default_rng(4).permutation(999)
    src, dst = src[perm], dst[perm]
    ref = repro.StreamingConnectivity(1000, max_iters=1)
    port = _port(1000, max_iters=1)
    for sl in _slices(999, 3):
        ref.ingest(src[sl], dst[sl])
        port.ingest(src[sl], dst[sl])
        same_state(ref, port)
    assert not bool(port.snapshot().converged)
    ref.resolve()
    port.resolve()
    same_state(ref, port)
    assert bool(port.snapshot().converged)
    assert port.n_components == 1


@pytest.mark.parametrize("site", ("pre", "post_write"))
def test_rollback_at_each_fault_site_equals_reference(site):
    src, dst, n = _shuffled(ref_gen.rmat(8, seed=9), seed=3)
    slices = _slices(len(src), 6)
    ref = repro.StreamingConnectivity(
        n // 2, fault_injector=ref_recovery.FaultInjector(
            fail_at=((3, site),)))
    port = _port(n // 2, fault_injector=FaultInjector(fail_at=((3, site),)))
    for i, sl in enumerate(slices):
        # batch 3 also grows the vertex set: the rollback undoes it
        grow = n if i >= 3 else None
        s, d = ((src[sl], dst[sl]) if i >= 3 else
                (src[sl] % (n // 2), dst[sl] % (n // 2)))
        if i == 3:
            before = port.state_dict()
            with pytest.raises(ref_recovery.SimulatedFault):
                ref.ingest(s, d, n_vertices=grow)
            with pytest.raises(SimulatedFault):
                port.ingest(s, d, n_vertices=grow)
            same_state(ref, port)
            assert port.n_vertices == n // 2 and port.n_batches == 3
            # the label capacity may have grown: identity padding past n
            assert torch.equal(port.labels, before["labels"][:n // 2])
            for key in ("m", "iterations", "edges_visited"):
                assert port.state_dict()[key] == before[key]
        ref.ingest(s, d, n_vertices=grow)
        port.ingest(s, d, n_vertices=grow)
        same_state(ref, port)


def test_supervertex_rewrite_counterexample():
    """The instance of the reference's test where sweeping a batch's
    original endpoints strands vertices: the port's engine (with the
    rewrite) must match the oracle where the raw sweep does not."""
    rng = np.random.default_rng(3)
    src, dst, n = ref_gen.path(600, seed=3).to_numpy()
    perm = rng.permutation(src.shape[0])
    src, dst = src[perm], dst[perm]
    cut = len(src) // 2
    oracle = connected_components_oracle(src, dst, n)
    eng = _port(n)
    eng.ingest(src[:cut], dst[:cut])
    warm = eng.labels.clone()
    k = len(src) - cut
    pad = streaming.next_pow2(k)
    sp = torch.zeros(pad, dtype=torch.int32)
    dp = torch.zeros(pad, dtype=torch.int32)
    sp[:k] = torch.from_numpy(src[cut:].astype(np.int32))
    dp[:k] = torch.from_numpy(dst[cut:].astype(np.int32))
    L_raw = warm
    for _ in range(50):
        L_raw = minmap.pointer_jump(minmap.mm_relax(L_raw, sp, dp, 2))
    assert not np.array_equal(L_raw.numpy(), oracle)
    eng.ingest(src[cut:], dst[cut:])
    np.testing.assert_array_equal(eng.labels.numpy(), oracle)


def _tail_padded(seed, n=300, k=700, pad=1024):
    rng = np.random.default_rng(seed)
    src = np.zeros(pad, np.int32)
    dst = np.zeros(pad, np.int32)
    src[:k] = rng.integers(0, n, k)
    dst[:k] = rng.integers(0, n, k)
    return src, dst, n, k


@pytest.mark.parametrize("sampling,compact_every",
                         [(0, 1), (0, 2), (2, 1), (2, 0)])
def test_adaptive_fixpoint_active_m0_equals_reference(sampling,
                                                      compact_every):
    src, dst, n, k = _tail_padded(sampling * 10 + compact_every)
    ref_step = ref_contour._make_step("C-2", 2, 1, "xla", None)
    ref = ref_fr.adaptive_fixpoint(
        jnp.asarray(src), jnp.asarray(dst), jnp.arange(n, dtype=jnp.int32),
        ref_step, n_vertices=n, sampling=sampling,
        compact_every=compact_every, max_iters=100, active_m0=k)
    port = fr.adaptive_fixpoint(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.arange(n, dtype=torch.int32),
        contour._make_step("C-2", 2, 1, "cuda"), n_vertices=n,
        sampling=sampling, compact_every=compact_every, max_iters=100,
        active_m0=k, loop=cv.loop_ops("cuda"))
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
    assert port[1] == int(ref[1]) and port[2] == bool(ref[2])
    assert (np.float32(port[3]).view(np.uint32)
            == np.asarray(ref[4]).view(np.uint32))
    # the tail is never swept nor counted: fewer edges visited than a
    # run over the whole padded array
    whole = fr.adaptive_fixpoint(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.arange(n, dtype=torch.int32),
        contour._make_step("C-2", 2, 1, "cuda"), n_vertices=n,
        sampling=sampling, compact_every=compact_every, max_iters=100,
        loop=cv.loop_ops("cuda"))
    assert float(port[3]) < float(whole[3])


@pytest.mark.parametrize("backend", ("cuda", "torch"))
def test_delta_converge_equals_reference(backend):
    src, dst, n, k = _tail_padded(7)
    warm_s, warm_d = src[:k // 2], dst[:k // 2]
    warm = np.array(repro.StreamingConnectivity(n).ingest(
        warm_s, warm_d)._labels)
    ref = ref_streaming.delta_converge(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(warm), jnp.int32(k))
    port = streaming.delta_converge(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(warm),
        k, backend=backend)
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
    assert port[1] == int(ref[1]) and port[2] == bool(ref[2])
    assert (np.float32(port[3]).view(np.uint32)
            == np.asarray(ref[3]).view(np.uint32))


def test_registry_flags_equal_reference():
    ours = {s.name: s for s in registry.solver_specs()}
    theirs = {s.name: s for s in ref_registry.solver_specs()}
    shared = sorted(set(ours) & set(theirs))
    assert shared == ["auto", "contour", "distributed", "fastsv",
                      "label_propagation", "oocore", "union_find"]
    for name in shared:
        for flag in ("supports_warm_start", "supports_streaming", "runs_on",
                     "supports_mesh"):
            assert getattr(ours[name], flag) == getattr(theirs[name], flag), \
                (name, flag)


def test_warm_started_engine_equals_reference():
    src, dst, n = _shuffled(ref_gen.rmat(9, seed=11), seed=1)
    cut = len(src) // 2
    warm = connected_components_oracle(src[:cut], dst[:cut], n)
    # a labelling that is not a star forest: compressed on entry
    warm = np.minimum(warm, np.roll(np.arange(n), 1))
    ref = repro.StreamingConnectivity(n, warm_start=warm)
    port = _port(n, warm_start=torch.from_numpy(warm.astype(np.int32)))
    same_state(ref, port)
    ref.ingest(src[cut:], dst[cut:])
    port.ingest(src[cut:], dst[cut:])
    same_state(ref, port)
