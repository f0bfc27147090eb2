"""Serving observability: latency percentiles, histograms, counters.

The port's copy of ``repro.serving.metrics``.

The metrics layer is deliberately boring and allocation-light — it sits
on the engine's hot loop.  Latencies append to a growable float array
(amortised O(1), 8 bytes/sample — a million-query run costs 8 MB);
histograms count into power-of-two buckets (the same bucketing rule the
query batches are padded by, so the batch-size histogram doubles as a
census of the gather's shapes); counters take a tiny lock because
producers increment them from client threads.

``ServingMetrics.summary()`` flattens everything into the plain-dict
shape of the reference's serving report (``BENCH_serving.json``), so
the two packages' reports compare key for key.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch.serving.primitives import pow2_bucket

PERCENTILES = (50.0, 95.0, 99.0)


class LatencyRecorder:
    """Append-only latency samples (seconds) with percentile summaries."""

    def __init__(self):
        self._buf = np.empty(1024, np.float64)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def record(self, dt: float) -> None:
        if self._n == self._buf.shape[0]:
            self._buf = np.concatenate([self._buf, np.empty_like(self._buf)])
        self._buf[self._n] = dt
        self._n += 1

    def record_many(self, dts: Iterable[float]) -> None:
        dts = np.asarray(list(dts) if not isinstance(dts, np.ndarray)
                         else dts, np.float64)
        need = self._n + dts.shape[0]
        if need > self._buf.shape[0]:
            self._buf = np.concatenate(
                [self._buf, np.empty(max(need, self._buf.shape[0]),
                                     np.float64)])
        self._buf[self._n:need] = dts
        self._n = need

    def samples(self) -> np.ndarray:
        return self._buf[:self._n]

    def summary_ms(self) -> Dict[str, float]:
        """p50/p95/p99 + mean/max in milliseconds (zeros when empty)."""
        if self._n == 0:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0,
                    "mean": 0.0, "max": 0.0, "count": 0}
        s = self.samples() * 1e3
        pcts = np.percentile(s, PERCENTILES)
        return {"p50": float(pcts[0]), "p95": float(pcts[1]),
                "p99": float(pcts[2]), "mean": float(s.mean()),
                "max": float(s.max()), "count": int(self._n)}


class Pow2Histogram:
    """Counting histogram over power-of-two buckets.

    ``observe(v)`` counts ``v`` into bucket ``pow2_bucket(v)`` (0 gets
    its own bucket, so an idle queue is visible as such).  Serialises to
    ``{bucket: count}`` with string keys for JSON.
    """

    def __init__(self):
        self._counts: Dict[int, int] = {}

    def observe(self, value: int, count: int = 1) -> None:
        b = 0 if value <= 0 else pow2_bucket(value)
        self._counts[b] = self._counts.get(b, 0) + count

    @property
    def total(self) -> int:
        return sum(self._counts.values())

    def to_dict(self) -> Dict[str, int]:
        return {str(k): self._counts[k] for k in sorted(self._counts)}


class ServingMetrics:
    """All engine observability in one bag (see module docstring).

    Single-writer fields (latency recorders, histograms) are touched
    only by the engine worker thread; the counters are incremented from
    client threads too and take ``_lock``.
    """

    COUNTERS = ("queries_answered", "ingests_committed", "edges_ingested",
                "rejected", "deadline_missed", "cancelled",
                "query_batches", "ingest_ticks", "restarts", "checkpoints",
                "replayed_batches", "straggler_events")

    def __init__(self):
        self.query_latency = LatencyRecorder()
        # submit -> commit-visible: the ingest-to-visibility lag
        self.ingest_visibility = LatencyRecorder()
        self.batch_sizes = Pow2Histogram()       # coalesced query batches
        self.ingest_queue_depth = Pow2Histogram()  # sampled once per tick
        self.query_queue_depth = Pow2Histogram()
        self._lock = threading.Lock()
        self._counters = {k: 0 for k in self.COUNTERS}

    def bump(self, counter: str, by: int = 1) -> None:
        with self._lock:
            self._counters[counter] += by

    def count(self, counter: str) -> int:
        with self._lock:
            return self._counters[counter]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def summary(self, wall_s: Optional[float] = None) -> dict:
        """Flatten to the serving report's shape."""
        c = self.counters()
        out = {
            "latency_ms": self.query_latency.summary_ms(),
            "ingest_visibility_ms": self.ingest_visibility.summary_ms(),
            "batch_size_hist": self.batch_sizes.to_dict(),
            "queue_depth_hist": {
                "ingest": self.ingest_queue_depth.to_dict(),
                "query": self.query_queue_depth.to_dict(),
            },
            "counters": c,
        }
        if wall_s is not None and wall_s > 0:
            out["wall_s"] = float(wall_s)
            out["throughput_qps"] = c["queries_answered"] / wall_s
            out["ingest_batches_per_s"] = c["ingests_committed"] / wall_s
        return out
