"""The port's graph layer against the JAX package's: same edges, same errors."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs import oracle as ref_oracle  # noqa: E402
from repro.graphs import stats as ref_stats  # noqa: E402
from repro.graphs import structs as ref_structs  # noqa: E402

from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.graphs import oracle, stats, structs  # noqa: E402
from repro_torch.graphs.structs import Graph  # noqa: E402

CPU = "cpu"

# (name, builder call) — the same arguments go to both packages
BUILDERS = [
    ("path", lambda g, **d: g.path(60, seed=1, **d)),
    ("path_ordered", lambda g, **d: g.path(20, shuffle_ids=False, **d)),
    ("cycle", lambda g, **d: g.cycle(45, seed=2, **d)),
    ("star", lambda g, **d: g.star(33, seed=3, **d)),
    ("caterpillar", lambda g, **d: g.caterpillar(12, 3, seed=4, **d)),
    ("grid2d", lambda g, **d: g.grid2d(7, 9, **d)),
    ("grid2d_nodiag", lambda g, **d: g.grid2d(5, 6, diagonals=False, **d)),
    ("delaunay_like", lambda g, **d: g.delaunay_like(9, **d)),
    ("rmat", lambda g, **d: g.rmat(9, seed=5, **d)),
    ("rmat_ef16", lambda g, **d: g.rmat(8, edge_factor=16, seed=6, **d)),
    ("erdos_renyi", lambda g, **d: g.erdos_renyi(300, avg_degree=3.0,
                                                 seed=7, **d)),
    ("random_tree", lambda g, **d: g.random_tree(150, seed=8, **d)),
    ("components_mix", lambda g, **d: g.components_mix(
        [g.path(30, seed=9, **d), g.rmat(6, seed=10, **d),
         g.grid2d(4, 4, **d)], seed=11, **d)),
]


def _same_graph(ref, port):
    rs, rd, rn = ref.to_numpy()
    ps, pd, pn = port.to_numpy()
    assert rn == pn
    assert ps.dtype == np.int32 and pd.dtype == np.int32
    np.testing.assert_array_equal(rs, ps)
    np.testing.assert_array_equal(rd, pd)


@pytest.mark.parametrize("name,build", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_generator_gives_reference_edges(name, build):
    ref = build(ref_gen)
    port = build(gen, device=CPU)
    assert port.device.type == "cpu"
    assert port.src.dtype == torch.int32
    _same_graph(ref, port)
    assert port.n_edges == ref.n_edges


def test_paper_suite_makes_the_reference_calls(monkeypatch):
    """The suite builds the same graphs from the same arguments (recorded
    with stub builders: the real suite takes seconds to generate)."""
    def record(module, calls):
        for name in ("path", "cycle", "star", "caterpillar", "grid2d",
                     "delaunay_like", "rmat", "erdos_renyi", "random_tree",
                     "components_mix"):
            def stub(*args, _name=name, **kwargs):
                kwargs.pop("device", None)
                if _name == "components_mix":
                    args = (len(args[0]),) + args[1:]
                calls.append((_name, args, kwargs))
                return _name
            monkeypatch.setattr(module, name, stub)

    ref_calls, port_calls = [], []
    record(ref_gen, ref_calls)
    record(gen, port_calls)
    for small in (True, False):
        ref_suite = ref_gen.paper_suite(small)
        port_suite = gen.paper_suite(small, device=CPU)
        assert list(ref_suite) == list(port_suite)
        assert ref_suite == port_suite
    assert ref_calls == port_calls


def test_from_numpy_without_device_never_lands_on_cpu():
    src, dst = np.array([0, 1]), np.array([1, 2])
    if torch.cuda.is_available():
        assert Graph.from_numpy(src, dst, 3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Graph.from_numpy(src, dst, 3)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gen.path(10)


def test_graph_roundtrip_and_views():
    ref = ref_gen.rmat(7, seed=3)
    port = Graph.from_numpy(*ref.to_numpy(), device=CPU)
    _same_graph(ref, port)
    _same_graph(ref.symmetrized(), port.symmetrized())
    _same_graph(ref.pad_edges(ref.n_edges + 5, fill_vertex=2),
                port.pad_edges(port.n_edges + 5, fill_vertex=2))
    assert port.pad_edges(port.n_edges) is port
    _same_graph(ref.add_edges(np.array([0, 3]), np.array([130, 131]),
                              n_vertices=140),
                port.add_edges(np.array([0, 3]), np.array([130, 131]),
                               n_vertices=140))


def test_from_numpy_rejects_out_of_range_endpoints():
    with pytest.raises(ValueError, match="n_vertices=3"):
        Graph.from_numpy(np.array([0]), np.array([3]), 3, device=CPU)
    with pytest.raises(ValueError, match=">= 0"):
        Graph.from_numpy(np.array([-1]), np.array([1]), 3, device=CPU)



def _i32(*ids):
    return torch.tensor(ids, dtype=torch.int32)


# endpoints outside [0, n) that the port's Graph refuses however it is
# built; the reference's Graph takes them, but the port's sweep kernels
# rely on the check (they follow every id on the main path unwaited)
BAD_GRAPHS = [
    ("direct_too_big",
     lambda: Graph(src=_i32(0, 5), dst=_i32(1, 2), n_vertices=5)),
    ("direct_negative",
     lambda: Graph(src=_i32(0), dst=_i32(-1), n_vertices=5)),
    ("pad_fill_too_big",
     lambda: gen.path(10, device=CPU).pad_edges(12, fill_vertex=10)),
    ("pad_fill_negative",
     lambda: gen.path(10, device=CPU).pad_edges(12, fill_vertex=-1)),
]


@pytest.mark.parametrize("name,build", BAD_GRAPHS,
                         ids=[b[0] for b in BAD_GRAPHS])
def test_graph_rejects_out_of_range_endpoints(name, build):
    with pytest.raises(ValueError, match="n_vertices=|>= 0"):
        build()


def test_graph_requires_matching_int32_edge_tensors():
    with pytest.raises(TypeError, match="int32"):
        Graph(src=_i32(0).long(), dst=_i32(1), n_vertices=2)
    with pytest.raises(ValueError, match="mismatch"):
        Graph(src=_i32(0, 1), dst=_i32(1), n_vertices=2)
    assert Graph(src=_i32(), dst=_i32(), n_vertices=0).n_edges == 0

# (call, args) pairs that must raise the same error in both packages
BAD_EDITS = [
    ("shrink", lambda g: g.add_edges([0], [1], n_vertices=g.n_vertices - 1)),
    ("shape", lambda g: g.add_edges([0, 1], [1])),
    ("too_big", lambda g: g.add_edges([0], [g.n_vertices])),
    ("negative", lambda g: g.add_edges([-1], [2])),
    ("pad_short", lambda g: g.pad_edges(g.n_edges - 1)),
]


@pytest.mark.parametrize("name,edit", BAD_EDITS, ids=[b[0] for b in BAD_EDITS])
def test_edit_errors_match_reference(name, edit):
    ref = ref_gen.path(10, seed=1)
    port = gen.path(10, seed=1, device=CPU)
    with pytest.raises(Exception) as ref_err:
        edit(ref)
    with pytest.raises(Exception) as port_err:
        edit(port)
    assert port_err.type is ref_err.type
    assert str(port_err.value) == str(ref_err.value)


def test_canonicalize_and_csr_match_reference():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    for drop in (True, False):
        a = ref_structs.canonicalize_edges(src, dst, 50, drop_self_loops=drop)
        b = structs.canonicalize_edges(src, dst, 50, drop_self_loops=drop)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(ref_structs.build_csr(src, dst, 50),
                    structs.build_csr(src, dst, 50)):
        np.testing.assert_array_equal(x, y)


def test_oracle_and_stats_copies_match_reference():
    g = ref_gen.components_mix([ref_gen.path(40, seed=1),
                                ref_gen.star(30, seed=2),
                                ref_gen.rmat(6, seed=3)], seed=4)
    s, d, n = g.to_numpy()
    np.testing.assert_array_equal(
        oracle.connected_components_oracle(s, d, n),
        ref_oracle.connected_components_oracle(s, d, n))
    np.testing.assert_array_equal(oracle.rem_union_find(s, d, n),
                                  ref_oracle.rem_union_find(s, d, n))
    a = oracle.connected_components_oracle(s, d, n)
    assert oracle.labels_equivalent(a, a)
    np.testing.assert_array_equal(stats.component_sizes(s, d, n),
                                  ref_stats.component_sizes(s, d, n))
    assert stats.degree_stats(s, d, n) == ref_stats.degree_stats(s, d, n)
    assert stats.degree_skew(s, d, n) == ref_stats.degree_skew(s, d, n)
    assert (stats.approx_max_diameter(s, d, n)
            == ref_stats.approx_max_diameter(s, d, n))
