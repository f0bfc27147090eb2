"""Heavy-traffic simulation harness for the serving engine.

The port's copy of ``repro.serving.simulate``: the same seeded query
and ingest plans, so both packages ingest the same edges in the same
order and end with the same labels.

Drives a real :class:`~repro_torch.serving.engine.ConnectivityEngine`
(real threads, real queues, real device gathers) with a synthetic workload
shaped like the interactive-analytics traffic the paper positions
Contour for (Arachne/Arkouda clients):

* **Zipf-skewed vertices** — queries concentrate on hot vertices
  (``zipf_a``), the regime where coalescing pays (many pending queries
  gather the same few cache lines).
* **Bursty arrivals** — producers emit Poisson-sized bursts back to
  back; ``target_qps`` (optional) spaces bursts with exponential gaps,
  otherwise the harness runs open-loop at capacity with a bounded
  in-flight window (the standard saturation-throughput measurement).
* **Mixed read/write** — a dedicated writer thread interleaves edge
  micro-batch ingests (``write_ratio`` of total operations) whose edge
  endpoints are drawn from the same skewed distribution, so queries
  race commits the way a live service's do.
* **Fault schedule** — an optional
  :class:`~repro_torch.runtime.recovery.FaultInjector` kills ingests
  mid-load; with a ``CheckpointManager`` the engine recovers via
  restore-and-replay and the run's final labels must be bit-identical
  to an uninterrupted run.

``run_simulation`` returns ``(report, labels)``: the metrics summary in
the reference's report shape plus the final committed label array (NumPy) for
bit-exactness comparisons.  The workload is a pure function of
``spec.seed`` — two runs with the same spec commit identical ingest
sequences, which is what makes the recovery comparison meaningful.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Optional

import numpy as np

from repro_torch.serving.client import ConnectivityClient
from repro_torch.serving.engine import ConnectivityEngine

# query-kind mix: overwhelmingly point reads, a sliver of whole-graph
# aggregation (each n_components answer rides one count on the device
# per committed snapshot, so the sliver stays cheap)
P_SAME, P_COMPONENT_OF, P_NCOMP = 0.849, 0.15, 0.001


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Parameters of one simulated traffic run (all seeded)."""

    n_vertices: int = 100_000
    n_queries: int = 1_000_000
    zipf_a: float = 1.3              # vertex skew (lower = hotter head)
    burst_mean: float = 64.0         # mean Poisson burst size
    write_ratio: float = 0.01        # ingest batches / total operations
    edges_per_batch: int = 256
    n_query_threads: int = 4
    window: int = 4096               # per-thread in-flight bound
    target_qps: Optional[float] = None  # None = open-loop at capacity
    query_timeout: Optional[float] = None  # per-request deadline (s)
    seed: int = 0

    @property
    def n_ingest_batches(self) -> int:
        return max(1, int(self.n_queries * self.write_ratio))


def _zipf_vertices(rng: np.random.Generator, a: float, n: int,
                   size: int) -> np.ndarray:
    """Zipf-skewed vertex ids in ``[0, n)`` (rank = vertex id)."""
    z = rng.zipf(a, size=size).astype(np.int64)
    return ((z - 1) % n).astype(np.int32)


def make_query_plan(spec: WorkloadSpec):
    """Precompute the full query stream: kinds, endpoints, burst sizes.

    Precomputing keeps the producer threads' steady-state loop free of
    RNG calls — the harness measures the engine, not NumPy.
    """
    rng = np.random.default_rng(spec.seed)
    q = spec.n_queries
    r = rng.random(q)
    kinds = np.where(r < P_SAME, 0, np.where(r < P_SAME + P_COMPONENT_OF,
                                             1, 2)).astype(np.int8)
    us = _zipf_vertices(rng, spec.zipf_a, spec.n_vertices, q)
    vs = _zipf_vertices(rng, spec.zipf_a, spec.n_vertices, q)
    n_bursts = max(1, int(q / max(spec.burst_mean, 1.0)))
    bursts = rng.poisson(spec.burst_mean, size=2 * n_bursts) + 1
    gaps = (rng.exponential(spec.burst_mean / spec.target_qps,
                            size=2 * n_bursts)
            if spec.target_qps else np.zeros(2 * n_bursts))
    return kinds, us, vs, bursts, gaps


def make_ingest_plan(spec: WorkloadSpec):
    """Precompute the deterministic ingest schedule (seeded off-stream
    from the query RNG so query volume never perturbs the committed
    edge sequence)."""
    rng = np.random.default_rng(spec.seed + 0x5EED)
    k = spec.n_ingest_batches
    src = _zipf_vertices(rng, spec.zipf_a, spec.n_vertices,
                         k * spec.edges_per_batch)
    dst = rng.integers(0, spec.n_vertices, size=k * spec.edges_per_batch,
                       dtype=np.int32)
    return [(src[i * spec.edges_per_batch:(i + 1) * spec.edges_per_batch],
             dst[i * spec.edges_per_batch:(i + 1) * spec.edges_per_batch])
            for i in range(k)]


KIND_NAMES = ("same_component", "component_of", "n_components")


def _query_producer(client: ConnectivityClient, spec: WorkloadSpec,
                    kinds, us, vs, bursts, gaps, failures: list):
    engine = client.engine
    outstanding = []
    i, n = 0, kinds.shape[0]
    bi = 0
    while i < n:
        take = int(bursts[bi % bursts.shape[0]])
        gap = float(gaps[bi % gaps.shape[0]])
        bi += 1
        for j in range(i, min(i + take, n)):
            kind = KIND_NAMES[kinds[j]]
            try:
                if kind == "same_component":
                    fut = client.same_component_async(
                        int(us[j]), int(vs[j]), timeout=spec.query_timeout)
                elif kind == "component_of":
                    fut = client.component_of_async(
                        int(us[j]), timeout=spec.query_timeout)
                else:
                    fut = client.n_components_async(
                        timeout=spec.query_timeout)
            except Exception as exc:  # noqa: BLE001 — report, keep loading
                failures.append(("submit", kind, repr(exc)))
                continue
            outstanding.append(fut)
            if len(outstanding) >= spec.window:
                drain = outstanding[:spec.window // 2]
                del outstanding[:spec.window // 2]
                for f in drain:
                    _settle(f, failures)
        i += take
        if gap > 0:
            time.sleep(gap)
        if engine._worker_error is not None:
            break
    for f in outstanding:
        _settle(f, failures)


def _settle(fut, failures: list) -> None:
    try:
        fut.result(timeout=120)
    except Exception as exc:  # noqa: BLE001 — tallied, not fatal
        failures.append(("result", type(exc).__name__, str(exc)[:80]))


def _ingest_producer(client: ConnectivityClient, plan, acked: list,
                     failures: list, pace_s: float):
    for bi, (src, dst) in enumerate(plan):
        try:
            ack = client.ingest(src, dst, timeout=None)
            acked.append(ack.batch_index)
        except Exception as exc:  # noqa: BLE001 — a lost ack is the signal
            failures.append(("ingest", bi, repr(exc)))
        if pace_s > 0:
            time.sleep(pace_s)


def run_simulation(
    spec: WorkloadSpec,
    *,
    engine: Optional[ConnectivityEngine] = None,
    manager=None,
    fault_injector=None,
    ingest_pace_s: float = 0.0,
    **engine_kwargs,
) -> tuple[dict, np.ndarray]:
    """Run one traffic simulation; returns ``(report, final_labels)``.

    ``engine_kwargs`` reach the :class:`ConnectivityEngine` constructor
    (checkpoint cadence, recoverable set, solver options, ``device``...).
    Pass a pre-built ``engine`` to drive a custom one instead.
    """
    own_engine = engine is None
    if own_engine:
        engine = ConnectivityEngine(
            spec.n_vertices, manager=manager,
            fault_injector=fault_injector, **engine_kwargs)
    engine.start()
    client = ConnectivityClient(engine, retries=1_000)

    kinds, us, vs, bursts, gaps = make_query_plan(spec)
    ingest_plan = make_ingest_plan(spec)
    shares = np.array_split(np.arange(spec.n_queries),
                            spec.n_query_threads)
    acked: list = []
    failures: list = []
    threads = [threading.Thread(
        target=_query_producer,
        args=(client, spec, kinds[s], us[s], vs[s], bursts, gaps, failures),
        name=f"query-producer-{t}", daemon=True)
        for t, s in enumerate(shares)]
    threads.append(threading.Thread(
        target=_ingest_producer,
        args=(client, ingest_plan, acked, failures, ingest_pace_s),
        name="ingest-producer", daemon=True))

    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    engine.flush(timeout=300.0)
    wall = time.perf_counter() - t0

    labels = engine.snapshot().labels.cpu().numpy()
    report = engine.metrics.summary(wall)
    report["spec"] = dataclasses.asdict(spec)
    report["final"] = {
        "n_batches": engine.n_batches,
        "n_vertices": engine.n_vertices,
        "n_edges": engine._stream.n_edges,
        "n_components": engine._stream.n_components,
        "labels_crc32": int(zlib.crc32(labels.tobytes())),
    }
    report["acked_batches"] = len(acked)
    report["failures"] = len(failures)
    report["failure_sample"] = [list(f) for f in failures[:5]]
    if own_engine:
        engine.close()
    return report, labels
