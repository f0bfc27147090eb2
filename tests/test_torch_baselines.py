"""The baseline families, ``fastsv``, ``label_propagation`` (``lp``) and
``union_find`` (``connectit``, ``rem``), against ``repro.solve``.

The graphs of ``tests/test_torch_solve.py`` (built once with numpy and
handed to both packages; its four trees share one (n, m), so the
reference compiles once for them): labels, iterations and converged must
be identical, and ``edges_visited`` None, as in the reference; cold,
warm-started, and under a budget at several chunk sizes of the device
loop.  Plus the registry: names, aliases and capability flags.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.connectivity import registry as ref_registry  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.connectivity import get_solver  # noqa: E402
from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402

from test_torch_solve import GRAPHS, _arrays, _pair  # noqa: E402

ALGORITHMS = ("fastsv", "label_propagation", "lp", "union_find",
              "connectit", "rem")


def _assert_same(ref, port):
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert port.labels.dtype == torch.int32
    assert port.labels.device.type == "cpu"
    assert port.iterations.dtype == torch.int32
    assert int(port.iterations) == int(ref.iterations)
    assert port.converged.dtype == torch.bool
    assert bool(port.converged) == bool(ref.converged)
    assert ref.edges_visited is None and port.edges_visited is None


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("gname", sorted(GRAPHS) + ["self_loop"])
def test_family_matches_reference(gname, algorithm):
    ref_g, g = _pair(gname)
    ref = repro.solve(ref_g, algorithm=algorithm)
    port = repro_torch.solve(g, algorithm=algorithm)
    _assert_same(ref, port)
    assert bool(port.converged)


@pytest.mark.parametrize("chunk", [1, 3, 64])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_family_warm_start_matches_reference(algorithm, chunk, monkeypatch):
    """A warm start after new edges, from the reference's labels, and from
    a shorter array after the graph grew vertices."""
    monkeypatch.setattr(cv, "CHUNK", chunk)
    s, d, n = _arrays("components_mix")
    rng = np.random.default_rng(0)
    extra_s = rng.integers(0, n + 4, 6)
    extra_d = rng.integers(0, n + 4, 6)
    ref_g = repro.Graph.from_numpy(s, d, n)
    first = repro.solve(ref_g, algorithm=algorithm)
    grown = ref_g.add_edges(extra_s, extra_d, n_vertices=n + 4)
    ref = repro.solve(grown, algorithm=algorithm, warm_start=first)
    g = repro_torch.Graph.from_numpy(s, d, n, device="cpu")
    port = repro_torch.solve(g.add_edges(extra_s, extra_d, n_vertices=n + 4),
                             algorithm=algorithm,
                             warm_start=np.asarray(first.labels))
    _assert_same(ref, port)


@pytest.mark.parametrize("chunk", [1, 2, 3, 64])
@pytest.mark.parametrize("max_iters", [1, 2, 3])
@pytest.mark.parametrize("algorithm", ["fastsv", "lp", "union_find"])
def test_family_budget_runs_match_reference(algorithm, max_iters, chunk,
                                            monkeypatch):
    """On the path (more iterations than the budget) FastSV and label
    propagation stop at ``max_iters`` with ``converged`` False whatever
    the chunk; Rem takes no budget (one pass, converged)."""
    monkeypatch.setattr(cv, "CHUNK", chunk)
    ref_g, g = _pair("path")
    ref = repro.solve(ref_g, algorithm=algorithm, max_iters=max_iters)
    port = repro_torch.solve(g, algorithm=algorithm, max_iters=max_iters)
    _assert_same(ref, port)
    assert bool(port.converged) == (algorithm == "union_find")


def test_registry_matches_reference():
    """The port registers six families; the baselines, the out-of-core
    solver and ``auto`` with the reference's aliases, budgets, capability
    flags and paper sections."""
    assert repro_torch.list_solvers() == ("auto", "contour", "fastsv",
                                          "label_propagation", "oocore",
                                          "union_find")
    for name in ("fastsv", "label_propagation", "union_find", "oocore",
                 "auto"):
        port = dataclasses.asdict(get_solver(name))
        ref = dataclasses.asdict(ref_registry.get_solver(name))
        for key in ("fn", "variants"):
            port.pop(key)
            ref.pop(key)
        assert port == ref, name
    for alias, name in (("lp", "label_propagation"),
                        ("connectit", "union_find"), ("rem", "union_find"),
                        ("out_of_core", "oocore")):
        assert get_solver(alias).name == name
    with pytest.raises(ValueError, match="takes no variant"):
        repro_torch.solve(_pair("path")[1], algorithm="fastsv",
                          variant="C-2")
