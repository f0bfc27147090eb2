"""The port's serving engine against the JAX package's.

The engine runs on CPU tensors here (``device="cpu"``); its answers are
held against the reference's solve, its final labels against the
reference engine's, and ``run_simulation`` at the shape of the serving
benchmark's fast spec must end on the reference's ``labels_crc32``,
component count and acknowledged batches.  The primitives and metrics
are the reference's copies and are held to its behaviour; recovery
through the write-ahead log loses no acknowledged ingest; ids out of
range are refused on the host before any gather.
"""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.serving import metrics as ref_metrics  # noqa: E402
from repro.serving import primitives as ref_primitives  # noqa: E402
from repro.serving import simulate as ref_simulate  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime import (FaultInjector, SimulatedFault,  # noqa: E402
                                 StragglerMonitor)
from repro_torch.serving import (BoundedQueue, ConnectivityClient,  # noqa: E402
                                 ConnectivityEngine, DeadlineExceeded,
                                 EngineClosed, QueueFull, ServeRequest,
                                 ServingMetrics, engine as engine_mod,
                                 pow2_bucket)
from repro_torch.serving.simulate import (WorkloadSpec,  # noqa: E402
                                          make_ingest_plan, make_query_plan,
                                          run_simulation)

pytestmark = pytest.mark.serving

CPU = "cpu"


def _engine(n, **kw):
    return ConnectivityEngine(n, device=CPU, **kw)


def _ref_labels(src, dst, n):
    g = repro.Graph.from_numpy(np.asarray(src), np.asarray(dst), n)
    return np.asarray(repro.solve(g).labels)


# ---------------------------------------------------------------------------
# primitives and metrics (the reference's behaviour)
# ---------------------------------------------------------------------------
def test_pow2_bucket_equals_reference():
    for k in (0, 1, 2, 3, 5, 63, 64, 65, 1000):
        for lo in (1, 64):
            assert pow2_bucket(k, lo) == ref_primitives.pow2_bucket(k, lo)


def test_bounded_queue():
    q = BoundedQueue(3, name="query")
    for i in range(3):
        q.put(i)
    with pytest.raises(QueueFull) as ei:
        q.put(9, retry_after=0.25)
    assert ei.value.retry_after == 0.25 and ei.value.name == "query"
    assert q.drain(2) == [0, 1] and len(q) == 1
    assert q.get_nowait() == 2 and q.get_nowait() is None
    t0 = time.monotonic()
    assert q.get_batch(4, timeout=0.02) == []
    assert time.monotonic() - t0 >= 0.015
    with pytest.raises(ValueError):
        BoundedQueue(0)
    req = ServeRequest(payload=None, deadline=time.perf_counter() - 1)
    assert req.expired() and req.begin()
    req = ServeRequest(payload=None)
    assert req.future.cancel() and not req.begin()


def test_metrics_equal_reference():
    rng = np.random.default_rng(0)
    ours, theirs = ServingMetrics(), ref_metrics.ServingMetrics()
    dts = rng.exponential(1e-3, 3000)
    for m in (ours, theirs):
        m.query_latency.record_many(dts[:2000])
        for dt in dts[2000:]:
            m.ingest_visibility.record(float(dt))
        for k in (0, 1, 5, 64, 65, 4096):
            m.batch_sizes.observe(k)
        m.bump("queries_answered", 2000)
        m.bump("restarts")
    assert ours.summary(wall_s=2.0) == theirs.summary(wall_s=2.0)
    assert ServingMetrics.COUNTERS == ref_metrics.ServingMetrics.COUNTERS


def test_workload_plans_equal_reference():
    spec = WorkloadSpec(n_vertices=5000, n_queries=3000, write_ratio=0.01,
                        edges_per_batch=16, target_qps=1e5, seed=4)
    ref_spec = ref_simulate.WorkloadSpec(**dataclasses.asdict(spec))
    for a, b in zip(make_query_plan(spec), ref_simulate.make_query_plan(
            ref_spec)):
        np.testing.assert_array_equal(a, b)
    ours, theirs = make_ingest_plan(spec), ref_simulate.make_ingest_plan(
        ref_spec)
    assert len(ours) == len(theirs) == spec.n_ingest_batches
    for (s, d), (rs, rd) in zip(ours, theirs):
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(d, rd)


# ---------------------------------------------------------------------------
# engine basics
# ---------------------------------------------------------------------------
def test_queries_match_reference(rng):
    n, m = 300, 600
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    want = _ref_labels(src, dst, n)
    with _engine(n) as eng:
        c = ConnectivityClient(eng)
        for i in range(0, m, 100):
            ack = c.ingest(src[i:i + 100], dst[i:i + 100])
        assert ack.batch_index == 5 and ack.n_edges == m
        assert c.n_components() == len(np.unique(want))
        for u, v in rng.integers(0, n, (50, 2)):
            assert c.same_component(int(u), int(v)) == (want[u] == want[v])
            assert c.component_of(int(u)) == want[u]
    assert eng.device == torch.device(CPU)
    np.testing.assert_array_equal(eng.snapshot().labels.numpy(), want)


def test_coalescing_growth_and_visibility():
    with _engine(256) as eng:
        c = ConnectivityClient(eng)
        assert not c.same_component(10, 11)
        c.ingest(np.arange(0, 100, dtype=np.int32),
                 np.arange(1, 101, dtype=np.int32))
        assert c.same_component(10, 11)          # visible after the ack
        futs = [c.same_component_async(i, i + 1) for i in range(99)]
        assert all(f.result(30) for f in futs)
        eng.flush()
        assert eng.metrics.count("query_batches") < 30
        ack = c.ingest(torch.tensor([7, 300]), torch.tensor([300, 301]),
                       n_vertices=512)
        assert ack.n_vertices == 512 and c.same_component(0, 301)
        assert c.map_component_of([0, 301, 400]) == [0, 0, 400]


def test_bad_requests_fail_alone():
    with _engine(16) as eng:
        c = ConnectivityClient(eng)
        with pytest.raises(ValueError, match="n_vertices"):
            c.ingest([0], [99])
        assert c.ingest([0], [1]).batch_index == 0
        with pytest.raises(ValueError, match="equal-length"):
            eng.submit_ingest([0, 1], [1])
        for args in (("n_components", 1), ("component_of", 1, 2),
                     ("nope", 1, 2)):
            with pytest.raises(ValueError):
                eng.submit_query(*args)
        assert c.same_component(0, 1)
    with pytest.raises(EngineClosed):
        eng.submit_query("same_component", 0, 1)
    with pytest.raises(EngineClosed):
        eng.submit_ingest([0], [1])


def test_out_of_range_ids_refused_before_the_gather(monkeypatch):
    seen = []
    gather = engine_mod._gather_pair_labels

    def spy(labels, u, v):
        seen.append(int(max(u.max(), v.max())))
        return gather(labels, u, v)

    monkeypatch.setattr(engine_mod, "_gather_pair_labels", spy)
    with _engine(32) as eng:
        c = ConnectivityClient(eng)
        c.ingest([0], [31])
        futs = [c.component_of_async(32), c.same_component_async(0, 100),
                c.same_component_async(-1, 0), c.same_component_async(0, 31)]
        for f in futs[:3]:
            with pytest.raises(IndexError):
                f.result(10)
        assert futs[3].result(10) is True
        assert c.component_of(31) == 0           # the engine goes on
    assert seen and max(seen) < 32
    # ids in [n, capacity) are padding, not vertices
    stream = eng._stream
    assert stream.vertex_capacity >= 32
    with pytest.raises(IndexError, match="out of range"):
        stream.component_of(stream.n_vertices)


def test_close_drains_or_fails_pending():
    eng = _engine(8)
    fut = eng.submit_query("n_components")
    eng.start()
    eng.close()
    assert fut.result(timeout=5) == 8
    eng = _engine(8)
    fut = eng.submit_query("n_components")
    eng.close(drain=False)
    with pytest.raises(EngineClosed):
        fut.result(timeout=5)


# ---------------------------------------------------------------------------
# flow control: backpressure, deadlines, cancellation
# ---------------------------------------------------------------------------
def test_backpressure_with_retry_after():
    eng = _engine(16, max_pending_queries=4, max_pending_ingests=2)
    for _ in range(4):
        eng.submit_query("n_components")
    with pytest.raises(QueueFull) as ei:
        eng.submit_query("n_components")
    assert ei.value.retry_after > 0.0 and ei.value.name == "query"
    eng.submit_ingest([0], [1])
    eng.submit_ingest([1], [2])
    with pytest.raises(QueueFull):
        eng.submit_ingest([2], [3])
    assert eng.metrics.count("rejected") == 2
    eng.start()
    eng.close()
    assert eng.n_batches == 2


def test_client_retries_through_backpressure_and_budget():
    eng = _engine(16, max_pending_queries=2)
    eng.submit_query("n_components")
    eng.submit_query("n_components")
    with pytest.raises(QueueFull):
        ConnectivityClient(eng, retries=2,
                           retry_sleep=lambda dt: None).n_components()
    sleeps = []

    def sleep_then_start(dt):
        sleeps.append(dt)
        eng.start()
        time.sleep(0.01)

    c = ConnectivityClient(eng, retries=50, retry_sleep=sleep_then_start)
    assert c.n_components() == 16 and sleeps
    eng.close()


def test_deadlines_and_cancellation():
    eng = _engine(16)
    late = eng.submit_query("same_component", 0, 1, timeout=0.01)
    late_ingest = eng.submit_ingest([0], [1], timeout=0.01)
    cancelled = eng.submit_query("same_component", 0, 1)
    assert cancelled.cancel()
    time.sleep(0.05)
    eng.start()
    for f in (late, late_ingest):
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=5)
    eng.flush()
    assert cancelled.cancelled()
    assert eng.metrics.count("deadline_missed") == 2
    assert eng.metrics.count("cancelled") == 1
    assert eng.metrics.count("queries_answered") == 0
    assert eng.n_batches == 0
    eng.close()


# ---------------------------------------------------------------------------
# concurrency: snapshot isolation under load
# ---------------------------------------------------------------------------
def test_concurrency_stress_monotone_answers():
    """More client threads than cores, a short switch interval: every
    answer comes from a committed prefix (connectivity only grows, so a
    True -> False flip for a pair would be a torn or rolled-back read),
    a poisoned batch is never visible, and the final labels equal the
    reference's over what was acknowledged."""
    chains = ((0, 120), (120, 240), (240, 360))
    n = 400
    eng = _engine(n, recoverable=())
    eng.start()
    c = ConnectivityClient(eng)
    stop = threading.Event()
    errors: list = []

    def ingest_chain(lo, hi):
        try:
            for i in range(lo, hi - 1, 10):
                src = np.arange(i, min(i + 10, hi - 1), dtype=np.int32)
                c.ingest(src, src + 1)
                if not c.same_component(int(src[0]), int(src[-1]) + 1):
                    errors.append("acked batch invisible")
        except Exception as exc:  # noqa: BLE001
            errors.append(repr(exc))

    def query(tid):
        seen = {(lo, hi - 1): False for lo, hi in chains}
        try:
            while not stop.is_set():
                for p in seen:
                    ans = c.same_component(*p)
                    if seen[p] and not ans:
                        errors.append(f"answer for {p} went back")
                    seen[p] = seen[p] or ans
                if c.same_component(50, 250) or c.same_component(370, 380):
                    errors.append(f"impossible connection (tid {tid})")
        except Exception as exc:  # noqa: BLE001
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=ingest_chain, args=span,
                                     daemon=True) for span in chains]
                   + [threading.Thread(target=query, args=(t,), daemon=True)
                      for t in range(6)])
        for t in threads:
            t.start()
        for t in threads[:3]:
            t.join(timeout=120)
        poison = FaultInjector(fail_at=((eng.n_batches, "post_write"),))
        eng._stream.fault_injector = poison
        with pytest.raises(SimulatedFault):
            c.ingest([370], [380])
        assert not c.same_component(370, 380)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        stop.set()
        eng.close()
    assert not errors, errors[:10]
    g = eng._stream.graph()
    want = _ref_labels(g.src.numpy(), g.dst.numpy(), n)
    np.testing.assert_array_equal(eng.snapshot().labels.numpy(), want)


# ---------------------------------------------------------------------------
# recovery: checkpoints + write-ahead log
# ---------------------------------------------------------------------------
def _recovery_run(tmp_path, fail_at=(), checkpoint_every=2):
    rng = np.random.default_rng(7)
    n, batches = 128, 10
    src = rng.integers(0, n, (batches, 32)).astype(np.int32)
    dst = rng.integers(0, n, (batches, 32)).astype(np.int32)
    manager = CheckpointManager(str(tmp_path), async_save=False)
    injector = (FaultInjector(fail_at=[(k, "pre") for k in fail_at])
                if fail_at else None)
    eng = _engine(n, manager=manager, checkpoint_every=checkpoint_every,
                  recoverable=(SimulatedFault,), fault_injector=injector,
                  backoff_base=0.001, sleep_fn=lambda dt: None)
    eng.start()
    c = ConnectivityClient(eng)
    acks = [c.ingest(src[k], dst[k]) for k in range(batches)]
    state = eng._stream.state_dict()
    eng.close()
    return eng, acks, state, (src, dst, n)


@pytest.mark.chaos
def test_wal_recovery_loses_no_acknowledged_ingest(tmp_path):
    _, _, clean, (src, dst, n) = _recovery_run(tmp_path / "clean")
    eng, acks, state, _ = _recovery_run(tmp_path / "faulty", fail_at=(3, 7))
    assert [a.batch_index for a in acks] == list(range(10))
    for key in clean:
        assert np.array_equal(np.asarray(state[key]), np.asarray(clean[key]))
    assert eng.restarts == 2
    assert eng.metrics.count("replayed_batches") >= 1
    assert eng.metrics.count("checkpoints") >= 5
    np.testing.assert_array_equal(
        state["labels"][:n].numpy(),
        _ref_labels(src.ravel(), dst.ravel(), n))


@pytest.mark.chaos
def test_recovery_before_any_checkpoint_and_without_manager(tmp_path):
    # a crash before the first checkpoint replays the whole WAL
    eng, acks, state, _ = _recovery_run(tmp_path, fail_at=(1,),
                                        checkpoint_every=100)
    assert len(acks) == 10 and eng.restarts == 1
    assert eng.metrics.count("replayed_batches") == 1
    # without a manager a crash-class fault is a plain retry
    eng = _engine(32, fault_injector=FaultInjector(fail_at=[(1, "pre")]),
                  recoverable=(SimulatedFault,), sleep_fn=lambda dt: None)
    eng.start()
    c = ConnectivityClient(eng)
    c.ingest([0], [1])
    assert c.ingest([1], [2]).batch_index == 1
    assert c.same_component(0, 2) and eng.restarts == 1
    eng.close()


@pytest.mark.chaos
def test_straggler_forces_checkpoint(tmp_path):
    class Scripted(StragglerMonitor):
        def __init__(self, actions):
            super().__init__()
            self.actions = list(actions)

        def start_step(self):
            pass

        def end_step(self):
            return self.actions.pop(0) if self.actions else "ok"

    manager = CheckpointManager(str(tmp_path), async_save=False)
    eng = _engine(32, manager=manager, checkpoint_every=1000,
                  straggler=Scripted(["ok", "checkpoint", "ok"]))
    eng.start()
    c = ConnectivityClient(eng)
    for k in range(3):
        c.ingest([k], [k + 1])
    eng.close()
    assert eng.metrics.count("checkpoints") == 1
    assert eng.metrics.count("straggler_events") == 1
    assert manager.latest_step() == 2


def test_kernel_error_reaches_the_future(monkeypatch):
    """A failure inside the delta solve (as a kernel launch error would
    raise) fails that ingest's future; the stream is rolled back and the
    engine keeps serving; the failed batch is not retried elsewhere."""
    from repro_torch.connectivity import streaming

    calls = []
    real = streaming.delta_converge

    def failing(*args, **kw):
        calls.append(kw["backend"])
        if len(calls) == 2:
            raise RuntimeError("contour_fused_relax launch failed: CUDA "
                               "error 700")
        return real(*args, **kw)

    monkeypatch.setattr(streaming, "delta_converge", failing)
    with _engine(16) as eng:
        c = ConnectivityClient(eng)
        c.ingest([0], [1])
        with pytest.raises(RuntimeError, match="CUDA error"):
            c.ingest([2], [3])
        assert eng.n_batches == 1 and not c.same_component(2, 3)
        c.ingest([2], [3])
        assert c.same_component(2, 3)
    assert calls == ["cuda"] * 3


# ---------------------------------------------------------------------------
# the simulation harness against the reference's
# ---------------------------------------------------------------------------
# the serving benchmark's fast spec (benchmarks/serving.py FAST_SPEC)
FAST_SPEC = dict(n_vertices=20_000, n_queries=20_000, zipf_a=1.3,
                 burst_mean=64.0, write_ratio=0.002, edges_per_batch=64,
                 n_query_threads=4, window=256, seed=0)


def test_simulation_at_fast_spec_equals_reference():
    report, labels = run_simulation(WorkloadSpec(**FAST_SPEC), device=CPU)
    ref, ref_labels = ref_simulate.run_simulation(
        ref_simulate.WorkloadSpec(**FAST_SPEC))
    assert report["failures"] == 0
    for key in ("labels_crc32", "n_components", "n_batches", "n_edges"):
        assert report["final"][key] == ref["final"][key], key
    assert report["acked_batches"] == ref["acked_batches"] == 40
    assert report["counters"]["queries_answered"] == FAST_SPEC["n_queries"]
    np.testing.assert_array_equal(labels, np.asarray(ref_labels))
    assert sorted(report) == sorted(ref)


@pytest.mark.chaos
def test_simulated_crashes_preserve_acks_and_labels(tmp_path):
    spec = WorkloadSpec(n_vertices=256, n_queries=800, edges_per_batch=32,
                        write_ratio=0.01, n_query_threads=2, window=128,
                        seed=5)
    clean, clean_labels = run_simulation(spec, device=CPU)
    faulty, faulty_labels = run_simulation(
        spec, manager=CheckpointManager(str(tmp_path), async_save=False),
        fault_injector=FaultInjector(fail_at=[(2, "pre"), (5, "pre")]),
        checkpoint_every=2, recoverable=(SimulatedFault,),
        sleep_fn=lambda dt: None, device=CPU)
    np.testing.assert_array_equal(faulty_labels, clean_labels)
    assert faulty["acked_batches"] == clean["acked_batches"] == \
        spec.n_ingest_batches
    assert faulty["counters"]["restarts"] == 2
    assert faulty["failures"] == 0
