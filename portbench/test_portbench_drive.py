"""Each cell's whole drive on the CPU (configuration and traffic found
by name, the window, the readers, the comparison with the reference),
through the harness's test entry with the port's ``backend="torch"``;
and the benchmark's files against its contract."""
import json
import re
import time

import pytest

torch = pytest.importorskip("torch")

from portbench import harness  # noqa: E402

# each cell at a toy size: the graph's parameters
SMALL = {
    "graph500-kron.s26-solve": {"scale": 9},
    "dimacs10-rgg.n24-solve": {"scale": 10},
}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def run_small(name, trace=False, seed=2 ** 31 + 11, options_extra=None):
    return harness.run_cell(name, seed, 0.2, trace,
                            t_start=time.perf_counter(), device="cpu",
                            sizes=SMALL[name],
                            options={"backend": "torch",
                                     **(options_extra or {})},
                            log=lambda line: None)


def spec():
    return harness.load_spec()


def test_every_cell_has_a_small_size():
    assert {w["name"] for w in spec()["workloads"]} == set(SMALL)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_cell_drives_and_is_correct(name, trace):
    result = run_small(name, trace)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert result["checks"]["mismatched_labels"] == {"value": 0, "limit": 0}
    wanted = {m["name"] for m in harness.metrics_for(spec(), name, trace)}
    got = set(result["metrics"])
    assert got <= wanted
    if not trace:
        # the host clock's metrics exist on any device
        assert {"solve_ms", "solve_p95_ms", "setup_s"} <= got
        assert result["metrics"]["solve_p95_ms"]["value"] > 0
    else:
        assert "iterations" in got and "solve_roofline_share" in got
        assert 0 < result["metrics"]["solve_roofline_share"]["value"] < 100


def test_same_seed_same_work():
    for name in sorted(SMALL):
        assert run_small(name, seed=7)["correct"]
        _, config, traffic = harness.cell_parts(spec(), name)
        make, params = harness.graph_params(config, traffic, SMALL[name])
        edges = {}
        for seed in (7, 8, 7):
            src, dst, _ = make(**params,
                               gen=torch.Generator().manual_seed(seed))
            if seed in edges:
                assert torch.equal(src, edges[seed][0])
                assert torch.equal(dst, edges[seed][1])
            edges[seed] = (src, dst)
        assert not (edges[7][0].shape == edges[8][0].shape
                    and torch.equal(edges[7][0], edges[8][0]))


def test_unknown_workload_is_refused():
    # the second: a configuration and a traffic that exist, but no cell
    for name in ("no-such.cell", "graph500-kron.n24-solve"):
        with pytest.raises(KeyError):
            harness.find_workload(spec(), name)


def test_unknown_generator_is_refused():
    with pytest.raises(KeyError):
        harness.generator("no_such_generator")


class _Raising:
    """A drive whose calls raise from the ``at``-th on."""

    def __init__(self, at, exc):
        self.calls, self.at, self.exc = 0, at, exc

    def call(self):
        self.calls += 1
        if self.calls >= self.at:
            raise self.exc
        return self.calls

    def ok(self, result):
        return True

    def answer(self, result):
        return result


@pytest.mark.parametrize("exc", [RuntimeError("CUDA out of memory"),
                                 ValueError("no plan")])
def test_a_window_ends_at_a_call_that_raises(exc):
    drive = _Raising(3, exc)
    window = harness.Window(drive, torch.device("cpu"),
                            harness.Reservoir(2, 1))
    window.run(60.0)
    assert window.count == 2 and drive.calls == 3
    assert window.errors and type(exc).__name__ in window.errors[0]


@pytest.mark.parametrize("trace", [False, True])
def test_a_call_that_raises_makes_the_run_incorrect(trace, monkeypatch):
    import repro_torch

    real = repro_torch.solve
    count = {"calls": 0}

    def third_raises(*args, **kwargs):
        count["calls"] += 1
        if count["calls"] == 3:
            raise RuntimeError("CUDA out of memory (planted)")
        return real(*args, **kwargs)

    monkeypatch.setattr("repro_torch.solve", third_raises)
    result = run_small("graph500-kron.s26-solve", trace)
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert result["checks"]["failed_calls"]["value"] >= 1
    assert result["attempted"] >= 1


def test_sweep_share_leaves_out_launches_past_the_fixed_point():
    read = harness.reader("sweep_roofline_share")
    nbytes = 3.35e9  # 1 ms at the peak
    calls = [{"iterations": 2,
              "launches": [("contour_fused_relax", 2.0),
                           ("contour_converged_early", 5.0),
                           ("contour_fused_relax", 2.0),
                           ("contour_fused_relax", 0.001)]}]
    record = {"calls": calls, "facts": {"sweep_kernel": "contour_fused_relax",
                                        "sweep_bytes": nbytes}}
    assert read(record) == pytest.approx(50.0)
    record["facts"] = {}
    assert read(record) is None


def test_readers_return_nothing_without_data():
    record = {"walls_s": [], "calls": [], "facts": {}, "peak_bytes": 0,
              "window_s": 0.0, "setup_s": 1.0}
    for m in spec()["per_layer"] + spec()["end_to_end"]:
        if m["name"] != "setup_s":
            assert harness.reader(m["name"])(record) is None, m["name"]


def test_percentile_is_the_nearest_rank():
    read = harness.reader("solve_p95_ms")
    walls = [i / 1000 for i in range(1, 101)]
    assert read({"walls_s": walls}) == pytest.approx(95.0)


def test_benchmark_json_keeps_the_contract():
    s = spec()
    assert s["command"] == ["python3", "portbench/run.py"]
    assert s["paths"] == ["portbench"]
    assert 1 <= s["run_seconds"] <= 51
    e2e = {m["name"] for m in s["end_to_end"]}
    assert {"solve_ms", "solve_p95_ms", "peak_mem_gib", "setup_s"} == e2e
    assert len(s["workloads"]) >= 1
    configs = {c["name"]: c for c in s["configs"]}
    cells = {w["name"] for w in s["workloads"]}
    for c in s["configs"]:
        assert c["file"].startswith("portbench/")
        assert harness.load_json(harness.ROOT / c["file"])["source"] \
            == c["source"]
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for group in ("end_to_end", "per_layer"):
        for m in s[group]:
            assert NAME.match(m["name"])
            assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", cells)) <= cells
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in s["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(s)) < 64 * 1024


class _Event:
    """A stand-in for a CUDA event: a time on the card's clock, in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_calls_align_on_the_profiler_clock_despite_drift_and_a_lost_marker():
    from portbench import tracing

    starts = [_Event(10.0 * k) for k in range(6)]
    # the profiler's clock runs 1e-4 fast against the events'; call 2's
    # marker is missing
    markers = [500.0 + 1e4 * k * (1 + 1e-4) for k in (0, 1, 3, 4, 5)]
    spans = tracing.align_calls(markers, starts, [2.0] * 6)
    assert spans[2] is None
    assert [s[0] for s in spans if s] == markers
    assert spans[0] == (500.0, 2500.0)
    full = tracing.align_calls(markers[:2], starts[:2], [1.0, 1.0])
    assert full == [(markers[0], markers[0] + 1e3), (markers[1],
                                                     markers[1] + 1e3)]
