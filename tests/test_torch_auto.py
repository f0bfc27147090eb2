"""``algorithm="auto"`` and its cost model against the JAX package's.

``planner.resolve_strategy`` must equal the reference's over a grid of
(n, m, skew, pins), with no artifact and with one synthetic schema-7
artifact passed to both; a corrupt or pre-7 artifact falls back to the
heuristic in both.  The degree skew the port computes where the edges
lie equals ``graphs.stats.degree_skew``.  ``solve(g, algorithm="auto")``
equals the reference's bit for bit, provenance's choice included.

Every test sets the port's ``REPRO_TORCH_BENCH_ARTIFACT`` itself
(``monkeypatch``); the reference's variable is ``tests/conftest.py``'s,
a file that does not exist.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.connectivity import planner as ref_planner  # noqa: E402
from repro.connectivity.streaming import \
    StreamingConnectivity as RefStreaming  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs import stats as ref_stats  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.connectivity import StreamingConnectivity  # noqa: E402
from repro_torch.connectivity import planner  # noqa: E402
from repro_torch.connectivity.planner import costmodel  # noqa: E402
from repro_torch.connectivity.solvers import device_degree_skew  # noqa: E402
from repro_torch.graphs import stats  # noqa: E402

ARTIFACT = {
    "schema": 7,
    "strategy_gate": {
        "rmat_small": {"n": 4096, "m": 60000, "degree_skew": 40.0,
                       "sides": {"prefix": {"seconds": [0.3, 0.2]},
                                 "kout": {"seconds": [0.1, 0.12]},
                                 "bfs": {"seconds": [0.5]},
                                 "auto": {"seconds": [0.01]}}},
        "grid": {"n": 65536, "m": 190000, "degree_skew": 1.6,
                 "sides": {"prefix": {"seconds": [0.4]},
                           "kout": {"seconds": [0.9]},
                           "bfs": {"seconds": [0.8, 0.7]}}},
        "star": {"n": 1000000, "m": 999999, "degree_skew": 500000.0,
                 "sides": {"prefix": {"seconds": [1.0]},
                           "bfs": {"seconds": [0.6]}}},
        "unmeasured": {"n": 10, "m": 9, "degree_skew": 1.0,
                       "sides": {"prefix": {"seconds": []}}},
    },
}


@pytest.fixture
def no_artifact(monkeypatch, tmp_path):
    monkeypatch.delenv(costmodel.ENV_BENCH_ARTIFACT, raising=False)
    monkeypatch.setenv("REPRO_BENCH_ARTIFACT", str(tmp_path / "none.json"))


@pytest.fixture
def artifact(tmp_path):
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(ARTIFACT))
    return str(path)


def _same_choice(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.provenance_entry() == ref.provenance_entry()


GRID = list(itertools.product(
    [0, 1, 2, 300, 4096, 1 << 22],
    [0, 1, 299, 60000, 67_108_864],
    [None, 0.0, 1.5, 7.99, 8.0, 55.1, 1e4]))
PINS = [(None, None), ("kout", None), ("bfs", "C-m"), (None, "C-1"),
        ("prefix", "C-2")]


@pytest.mark.parametrize("strategy,variant", PINS)
@pytest.mark.parametrize("with_artifact", [False, True])
def test_resolve_strategy_matches_the_reference(strategy, variant,
                                                with_artifact, no_artifact,
                                                artifact):
    bench = artifact if with_artifact else None
    for n, m, skew in GRID:
        kw = dict(degree_skew=skew, pinned_strategy=strategy,
                  pinned_variant=variant)
        port = planner.resolve_strategy(n, m, bench_path=bench, **kw)
        ref = ref_planner.resolve_strategy(n, m, bench_path=bench, **kw)
        _same_choice(port, ref)


def test_fitted_model_copies_the_nearest_measured_graph(artifact):
    c = planner.resolve_strategy(4000, 61000, degree_skew=35.0,
                                 bench_path=artifact)
    assert (c.origin, c.sampling_strategy, c.neighbor) == \
        ("fitted", "kout", "rmat_small")
    c = planner.resolve_strategy(70000, 200000, degree_skew=1.5,
                                 bench_path=artifact)
    assert (c.sampling_strategy, c.neighbor) == ("prefix", "grid")


CORRUPT = [
    "{ not json",
    json.dumps({"schema": 6, "strategy_gate": ARTIFACT["strategy_gate"]}),
    json.dumps({"schema": 7, "strategy_gate": [1, 2]}),
    json.dumps({"schema": 7, "strategy_gate": {"g": {"n": 5, "m": 4,
                                                     "sides": {}}}}),
    json.dumps({"schema": "seven"}),
]


@pytest.mark.parametrize("text", CORRUPT,
                         ids=[str(i) for i in range(len(CORRUPT))])
def test_corrupt_or_old_artifact_falls_back_to_the_heuristic(text, tmp_path,
                                                             no_artifact):
    path = tmp_path / "bad.json"
    path.write_text(text)
    for n, m, skew in [(4096, 60000, 40.0), (65536, 190000, 1.6)]:
        port = planner.resolve_strategy(n, m, degree_skew=skew,
                                        bench_path=str(path))
        ref = ref_planner.resolve_strategy(n, m, degree_skew=skew,
                                           bench_path=str(path))
        assert port.origin == "heuristic"
        _same_choice(port, ref)


def test_an_artifact_that_is_not_an_object_falls_back(tmp_path):
    """A JSON list where the artifact's object belongs: the port takes the
    heuristic, where the reference raises ``AttributeError`` (a deliberate
    deviation: a broken benchmark file must never break a solve)."""
    path = tmp_path / "list.json"
    path.write_text(json.dumps([7]))
    c = planner.resolve_strategy(4096, 60000, degree_skew=40.0,
                                 bench_path=str(path))
    assert (c.origin, c.sampling_strategy) == ("heuristic", "kout")
    with pytest.raises(AttributeError):
        ref_planner.resolve_strategy(4096, 60000, degree_skew=40.0,
                                     bench_path=str(path))


def test_the_port_reads_its_own_variable_and_has_no_default(
        monkeypatch, artifact, no_artifact):
    # the repo's BENCH_connectivity.json is no default for the port
    assert costmodel.artifact_path() is None
    assert planner.resolve_strategy(4000, 61000, degree_skew=35.0).origin \
        == "heuristic"
    # the reference's variable is not the port's
    monkeypatch.setenv("REPRO_BENCH_ARTIFACT", artifact)
    assert planner.resolve_strategy(4000, 61000, degree_skew=35.0).origin \
        == "heuristic"
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", artifact)
    c = planner.resolve_strategy(4000, 61000, degree_skew=35.0)
    assert (c.origin, c.neighbor) == ("fitted", "rmat_small")


SKEW_GRAPHS = {
    "rmat12": lambda: ref_gen.rmat(12, edge_factor=16, seed=0),
    "star": lambda: ref_gen.star(500, seed=1),
    "grid": lambda: ref_gen.grid2d(20, 31),
    "path": lambda: ref_gen.path(777, seed=2),
    "mix": lambda: ref_gen.components_mix(
        [ref_gen.path(60, seed=9), ref_gen.star(40, seed=10),
         ref_gen.rmat(7, seed=11)], seed=12),
}


@pytest.mark.parametrize("gname", sorted(SKEW_GRAPHS))
def test_device_skew_equals_degree_skew(gname):
    s, d, n = SKEW_GRAPHS[gname]().to_numpy()
    for extra in (0, 5):   # isolated vertices lower the mean
        g = interop.graph_from_arrays(s, d, n + extra, device="cpu")
        want = ref_stats.degree_skew(s, d, n + extra)
        assert stats.degree_skew(s, d, n + extra) == want
        got = device_degree_skew(g.src, g.dst, n + extra)
        assert np.float64(got).view(np.uint64) == \
            np.float64(want).view(np.uint64)


def test_device_skew_of_degenerate_graphs():
    for s, d, n in [(np.zeros(0, np.int32), np.zeros(0, np.int32), 5),
                    (np.array([2], np.int32), np.array([2], np.int32), 4),
                    (np.zeros(0, np.int32), np.zeros(0, np.int32), 0)]:
        g = interop.graph_from_arrays(s, d, n, device="cpu")
        assert device_degree_skew(g.src, g.dst, n) == \
            ref_stats.degree_skew(s, d, n)
    # rmat(12,16)'s skew, far above the heuristic's 8
    s, d, n = ref_gen.rmat(12, edge_factor=16, seed=0).to_numpy()
    assert ref_stats.degree_skew(s, d, n) > 50


AUTO_GRAPHS = {
    "rmat10_16": lambda: ref_gen.rmat(10, edge_factor=16, seed=5),
    "rmat9": lambda: ref_gen.rmat(9, seed=6),
    "grid": lambda: ref_gen.grid2d(12, 15),
    "path": lambda: ref_gen.path(300, seed=1),
    "star": lambda: ref_gen.star(300, seed=3),
    "edgeless": None,
    "one_vertex": None,
}


def _auto_pair(gname):
    if gname == "edgeless":
        s, d, n = np.zeros(0, np.int32), np.zeros(0, np.int32), 6
    elif gname == "one_vertex":
        s, d, n = np.array([0], np.int32), np.array([0], np.int32), 1
    else:
        s, d, n = AUTO_GRAPHS[gname]().to_numpy()
    return (repro.Graph.from_numpy(s, d, n),
            interop.graph_from_arrays(s, d, n, device="cpu"))


def _assert_same_result(ref, port):
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert int(port.iterations) == int(ref.iterations)
    assert bool(port.converged) == bool(ref.converged)
    assert (port.edges_visited.numpy().view(np.uint32)
            == np.asarray(ref.edges_visited).view(np.uint32))


OVERRIDES = [{}, {"sampling_strategy": "bfs"}, {"variant": "C-m"},
             {"sampling": 1, "compact_every": 3}]


@pytest.mark.parametrize("overrides", OVERRIDES,
                         ids=["none", "bfs", "C-m", "schedule"])
@pytest.mark.parametrize("gname", sorted(AUTO_GRAPHS))
def test_auto_solve_matches_the_reference(gname, overrides, no_artifact):
    ref_g, g = _auto_pair(gname)
    ref = repro.solve(ref_g, algorithm="auto", **overrides)
    port = repro_torch.solve(g, algorithm="auto", **overrides)
    _assert_same_result(ref, port)
    # the choice's entry is the reference's, word for word; the plan's
    # line names the port's backends
    assert port.provenance[0] == ref.provenance[0]
    assert port.provenance[0].startswith("auto:solver=contour")
    assert port.provenance[1].startswith("plan:")
    assert port.provenance[2:] == ref.provenance[2:]


def test_auto_picks_kout_on_a_skewed_dense_graph(no_artifact):
    _, g = _auto_pair("rmat10_16")
    res = repro_torch.solve(g, algorithm="auto")
    assert res.provenance[0] == ("auto:solver=contour strategy=kout "
                                 "origin=heuristic")


def test_auto_warm_start_matches_the_reference(no_artifact):
    ref_g, g = _auto_pair("grid")
    warm = np.arange(ref_g.n_vertices)
    warm[50:] = 50
    ref = repro.solve(ref_g, algorithm="auto", warm_start=warm)
    port = repro_torch.solve(g, algorithm="auto", warm_start=warm)
    _assert_same_result(ref, port)


def test_auto_is_registered_as_the_reference_registers_it():
    spec = repro_torch.connectivity.get_solver("auto")
    ref = repro.connectivity.get_solver("auto")
    for field in ("variants", "default_variant", "default_max_iters",
                  "supports_warm_start", "supports_batch",
                  "supports_streaming", "runs_on"):
        assert getattr(spec, field) == getattr(ref, field), field


def test_streaming_auto_behaves_as_the_reference():
    """A stream may name ``auto`` (its spec supports streaming): with a
    variant pinned it streams as Contour does; with none, the first
    ingest fails in both packages (the engine passes the unset variant
    to the step)."""
    s, d, n = ref_gen.rmat(8, seed=4).to_numpy()
    s, d = np.array(s), np.array(d)
    ref = RefStreaming(n, algorithm="auto", variant="C-2")
    port = StreamingConnectivity(n, algorithm="auto", variant="C-2",
                                 device="cpu")
    for lo in range(0, len(s), 300):
        ref.ingest(s[lo:lo + 300], d[lo:lo + 300])
        port.ingest(s[lo:lo + 300], d[lo:lo + 300])
        a, b = ref.snapshot(), port.snapshot()
        np.testing.assert_array_equal(b.labels.numpy(), np.asarray(a.labels))
        assert int(b.iterations) == int(a.iterations)
    ref = RefStreaming(n, algorithm="auto")
    port = StreamingConnectivity(n, algorithm="auto", device="cpu")
    with pytest.raises(Exception) as ref_err:
        ref.ingest(s[:10], d[:10])
    with pytest.raises(type(ref_err.value)):
        port.ingest(s[:10], d[:10])
