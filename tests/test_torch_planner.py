"""The port's planner (``repro_torch.connectivity.planner``) against the
JAX package's: plan keys, the plan's config round trip, the tuning
cache's protocol (round trip, corrupt files and entries), the resolution
order pinned > cache > heuristic, and the autotuner's hysteresis with an
injected ``measure``.

Every test points ``REPRO_TORCH_TUNING_CACHE`` at a file of its own
(``monkeypatch``); the reference's cache is ``tests/conftest.py``'s.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.connectivity import planner as ref_planner  # noqa: E402
from repro.connectivity.planner import cache as ref_cache  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.connectivity import planner  # noqa: E402
from repro_torch.connectivity.planner import cache  # noqa: E402
from repro_torch.connectivity.planner.plan import ExecutionPlan  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402

SIZES = [0, 1, 2, 3, 1000, 1024, 1025, 65535, 65536, 1 << 24, (1 << 24) + 1]


@pytest.fixture
def tuning_file(tmp_path, monkeypatch):
    path = str(tmp_path / "tuning.json")
    monkeypatch.setenv(cache.ENV_CACHE_PATH, path)
    return path


@pytest.mark.parametrize("n", SIZES)
def test_plan_key_and_size_bucket_match_the_reference(n):
    assert planner.size_bucket(n) == ref_planner.size_bucket(n)
    for m in SIZES:
        assert planner.plan_key("cpu", n, m) == \
            ref_planner.plan_key("cpu", n, m)
    assert planner.plan_key("cuda", n, 7).startswith("cuda/n")


def test_origins_and_backends():
    assert planner.ORIGINS == ("heuristic", "tuned", "pinned")
    assert "fallback" in ref_planner.ORIGINS  # the reference's, not ported
    assert planner.COMPACT_SCHEDULES == ref_planner.COMPACT_SCHEDULES


def test_config_round_trip_and_equality():
    p = ExecutionPlan(backend="cuda", fuse_relabel=False,
                      compact_schedule="staged", chunk_bucket=1 << 17)
    cfg = p.to_config()
    assert cfg == {"backend": "cuda", "fuse_relabel": False,
                   "compact_schedule": "staged", "chunk_bucket": 1 << 17}
    json.dumps(cfg)
    q = ExecutionPlan.from_config(cfg, origin="tuned", device="cpu")
    assert q.origin == "tuned" and q.device == "cpu"
    assert q.config_equal(p) and p.config_equal(q)
    assert not p.config_equal(None)
    assert not p.config_equal(p.replace(fuse_relabel=True))


BAD_CONFIGS = [
    ({"backend": "cuda", "label_block": 2048}, "unknown"),
    ({"backend": "cuda", "fuse_relabel": 1}, "bool"),
    ({"backend": 3}, "str"),
    ({"backend": "auto"}, "concrete"),
    ({"backend": "xla"}, "concrete"),
    ({"backend": "cuda", "compact_schedule": "eager"}, "compact_schedule"),
    ({"backend": "cuda", "chunk_bucket": 3}, "power of two"),
    ({"backend": "cuda", "chunk_bucket": "8"}, "int"),
    ({"backend": "cuda", "chunk_bucket": True}, "int"),
    ([("backend", "cuda")], "dict"),
]


@pytest.mark.parametrize("config,match", BAD_CONFIGS,
                         ids=[str(i) for i in range(len(BAD_CONFIGS))])
def test_from_config_refuses_unknown_or_mistyped_fields(config, match):
    with pytest.raises(ValueError, match=match):
        ExecutionPlan.from_config(config)


def test_validate_refuses_bad_plans():
    with pytest.raises(ValueError, match="origin"):
        ExecutionPlan(backend="cuda", origin="fallback").validate()
    with pytest.raises(ValueError, match="concrete"):
        ExecutionPlan(backend="auto").validate()


def test_cache_round_trip(tuning_file):
    assert cache.cache_path() == tuning_file
    assert cache.lookup(1000, 5000, "cpu") is None
    plan = ExecutionPlan(backend="torch", compact_schedule="staged",
                         origin="tuned", device="cpu")
    entry = cache.store(1000, 5000, "cpu", plan, time_s=0.25,
                        timings={"x": 0.25}, now=123.0)
    assert entry["origin"] == "tuned" and entry["measured_at"] == 123.0
    got = cache.lookup(1000, 5000, "cpu")
    assert got == plan
    # the same bucket, another size in it; another device type misses
    assert cache.lookup(1024, 8192, "cpu") == plan
    assert cache.lookup(1000, 5000, "cuda") is None
    assert cache.lookup(1025, 5000, "cpu") is None
    payload = json.loads(open(tuning_file).read())
    assert payload["schema"] == cache.CACHE_SCHEMA == ref_cache.CACHE_SCHEMA
    assert list(payload["entries"]) == [planner.plan_key("cpu", 1000, 5000)]
    # the atomic write leaves no temporary file beside the cache
    assert os.listdir(os.path.dirname(tuning_file)) == ["tuning.json"]
    assert cache.entries() == payload["entries"]
    cache.clear()
    assert not os.path.exists(tuning_file)
    assert cache.lookup(1000, 5000, "cpu") is None


def test_cache_rereads_a_file_rewritten_behind_it(tuning_file):
    plan = ExecutionPlan(backend="torch", origin="tuned", device="cpu")
    cache.store(10, 20, "cpu", plan)
    assert cache.lookup(10, 20, "cpu") == plan
    key = planner.plan_key("cpu", 10, 20)
    with open(tuning_file, "w") as f:
        json.dump({"schema": 1, "entries": {key: {
            "config": plan.replace(backend="cuda").to_config(),
            "origin": "tuned"}}}, f)
    os.utime(tuning_file, ns=(1, 1))  # a new mtime, whatever the clock
    assert cache.lookup(10, 20, "cpu").backend == "cuda"


# the same corrupt payload in both packages' caches: both miss
CORRUPT_FILES = [
    "not json at all {",
    "[1, 2, 3]",
    json.dumps({"schema": 2, "entries": {}}),
    json.dumps({"schema": 1, "entries": [1, 2]}),
    json.dumps({"schema": 1, "entries": {"{key}": "a string"}}),
    json.dumps({"schema": 1, "entries": {"{key}": {"config": "x"}}}),
    json.dumps({"schema": 1, "entries": {"{key}": {
        "config": {"backend": "cuda", "tile": 4}, "origin": "tuned"}}}),
    json.dumps({"schema": 1, "entries": {"{key}": {
        "config": {"backend": "nope"}, "origin": "tuned"}}}),
    json.dumps({"schema": 1, "entries": {"{key}": {
        "config": {"backend": "xla"}, "origin": "heuristic"}}}),
    "",
]


@pytest.mark.parametrize("text", CORRUPT_FILES,
                         ids=[str(i) for i in range(len(CORRUPT_FILES))])
def test_corrupt_cache_is_a_miss_as_in_the_reference(text, tuning_file,
                                                     tmp_path):
    with open(tuning_file, "w") as f:
        f.write(text.replace("{key}", planner.plan_key("cpu", 100, 400)))
    ref_path = str(tmp_path / "ref_tuning.json")
    with open(ref_path, "w") as f:
        f.write(text.replace("{key}", ref_planner.plan_key("cpu", 100, 400)))
    assert cache.lookup(100, 400, "cpu") is None
    assert ref_cache.lookup(100, 400, "cpu", path=ref_path) is None


def test_fallback_entry_is_a_miss_a_deliberate_deviation(tuning_file,
                                                         tmp_path):
    """The reference reads an unexpired ``"fallback"`` demotion back (its
    kernel-fallback path writes them); the port has no kernel fallback
    and treats such an entry as a miss."""
    key = planner.plan_key("cpu", 100, 400)
    entry = {"config": {"backend": "torch"}, "origin": "fallback",
             "expires_at": 1e18}
    with open(tuning_file, "w") as f:
        json.dump({"schema": 1, "entries": {key: entry}}, f)
    assert cache.lookup(100, 400, "cpu") is None
    ref_path = str(tmp_path / "ref.json")
    ref_entry = dict(entry, config={"backend": "xla"})
    with open(ref_path, "w") as f:
        json.dump({"schema": 1, "entries": {key: ref_entry}}, f)
    assert ref_cache.lookup(100, 400, "cpu", path=ref_path).origin == \
        "fallback"
    assert not hasattr(planner, "record_kernel_failure")
    assert hasattr(ref_planner, "record_kernel_failure")


def _graph(n=300):
    s, d, n = gen.rmat(8, seed=3, device="cpu").to_numpy()
    return interop.graph_from_arrays(s, d, n, device="cpu")


def test_resolution_order_pinned_then_cache_then_table(tuning_file):
    g = _graph()
    n, m = g.n_vertices, g.n_edges
    table = planner.heuristic_plan(n, m, "cpu")
    assert planner.resolve_plan(n, m, device="cpu") == table
    tuned = table.replace(backend="torch", fuse_relabel=False,
                          origin="tuned")
    cache.store(n, m, "cpu", tuned)
    got = planner.resolve_plan(n, m, device="cpu")
    assert got.origin == "tuned" and got.config_equal(tuned)
    assert planner.resolve_plan(n, m, device="cpu", use_cache=False) == \
        table
    pinned = table.replace(compact_schedule="staged", origin="pinned")
    assert planner.resolve_plan(n, m, plan=pinned, device="cpu") == pinned
    # a forced backend skips the cache: the table with it substituted
    forced = planner.resolve_plan(n, m, backend="cuda", device="cpu")
    assert forced == table.replace(origin="pinned")
    # through the facade
    res = repro_torch.solve(g)
    assert res.provenance[0].startswith("plan:torch origin=tuned")
    res = repro_torch.solve(g, backend="cuda")
    assert res.provenance[0].startswith("plan:cuda origin=pinned")
    res = repro_torch.solve(g, plan=pinned)
    assert res.provenance[0] == pinned.provenance_entry()
    with pytest.raises(TypeError, match="ExecutionPlan"):
        repro_torch.solve(g, plan="cuda")


def test_a_tuned_plan_gives_the_same_labels(tuning_file):
    g = _graph()
    base = repro_torch.solve(g, sampling=2, compact_every=2)
    for cand in planner.candidate_plans(g.n_vertices, g.n_edges, "cpu"):
        cache.store(g.n_vertices, g.n_edges, "cpu",
                    cand.replace(origin="tuned"))
        res = repro_torch.solve(g, sampling=2, compact_every=2)
        assert torch.equal(res.labels, base.labels)
        assert "origin=tuned" in res.provenance[0]


@pytest.mark.parametrize("m", [100, 1 << 15])
def test_candidates_start_with_the_table_and_skip_cuda_async(m):
    cands = planner.candidate_plans(1000, m, "cpu")
    assert cands[0] == planner.heuristic_plan(1000, m, "cpu")
    assert all(c.backend != "cuda_async" for c in cands)
    assert {c.compact_schedule for c in cands} == {"masked", "staged"}
    assert any(not c.fuse_relabel for c in cands)
    labels = [planner.plan_label(c) for c in cands]
    assert len(set(labels)) == len(labels)
    # the reference's candidates also start with its table's plan
    assert ref_planner.candidate_plans(1000, m, "cpu")[0] == \
        ref_planner.heuristic_plan(1000, m, "cpu")


# (ratio of the best other candidate's time to the table's, whether the
# other candidate wins): 5% hysteresis, as the reference's
HYSTERESIS = [(0.99, False), (0.951, False), (0.95, False), (0.949, True),
              (0.5, True), (1.2, False)]


@pytest.mark.parametrize("ratio,wins", HYSTERESIS)
def test_autotune_hysteresis_matches_the_reference(ratio, wins, tuning_file,
                                                   tmp_path):
    g = _graph()
    cands = planner.candidate_plans(g.n_vertices, g.n_edges, "cpu")
    times = {planner.plan_label(c): 1.0 for c in cands}
    times[planner.plan_label(cands[1])] = ratio

    plan, timings = planner.autotune(
        g, measure=lambda graph, p, opts: times[planner.plan_label(p)])
    assert timings == times
    assert plan.origin == "tuned"
    assert plan.config_equal(cands[1] if wins else cands[0])
    assert cache.lookup(g.n_vertices, g.n_edges, "cpu") == plan
    entry = cache.entries()[planner.plan_key("cpu", g.n_vertices,
                                             g.n_edges)]
    assert entry["timings"] == times
    # the reference decides the same on its own candidates
    ref_g = __import__("repro").Graph.from_numpy(*g.to_numpy())
    ref_c = ref_planner.candidate_plans(g.n_vertices, g.n_edges, "cpu")
    ref_t = {ref_planner.plan_label(c): 1.0 for c in ref_c}
    ref_t[ref_planner.plan_label(ref_c[1])] = ratio
    ref_plan, _ = ref_planner.autotune(
        ref_g, platform="cpu", write=False,
        measure=lambda graph, p, opts: ref_t[ref_planner.plan_label(p)])
    assert ref_plan.config_equal(ref_c[1] if wins else ref_c[0])


def test_autotune_write_false_leaves_the_cache(tuning_file):
    g = _graph()
    plan, _ = planner.autotune(g, measure=lambda *a: 1.0, write=False)
    assert plan.origin == "tuned"
    assert not os.path.exists(tuning_file)


def test_autotune_measures_the_real_solve(tuning_file):
    g = _graph()
    plan, timings = planner.autotune(g, repeats=1)
    assert set(timings) == {planner.plan_label(c) for c in
                            planner.candidate_plans(g.n_vertices,
                                                    g.n_edges, "cpu")}
    assert all(t > 0 for t in timings.values())
    res = repro_torch.solve(g)
    assert res.provenance[0] == plan.provenance_entry()
    ref = repro_torch.solve(g, backend="torch")
    assert torch.equal(res.labels, ref.labels)
    assert np.array_equal(res.labels.numpy(),
                          repro_torch.solve(g, plan=planner.heuristic_plan(
                              g.n_vertices, g.n_edges, "cpu")).labels.numpy())
