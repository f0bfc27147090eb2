"""Connectivity-as-a-service: the async request-batching engine.

The port's counterpart of ``repro.serving.engine`` (DESIGN.md §13).
:class:`ConnectivityEngine` turns one
:class:`~repro_torch.connectivity.streaming.StreamingConnectivity` into
a multi-client service, in the JetStream/continuous-batching mold:

* **Two bounded queues, one worker.**  Clients submit edge-ingest and
  ``same_component``/``component_of``/``n_components`` requests into
  separate :class:`~repro_torch.serving.primitives.BoundedQueue`\\ s; a single
  worker thread owns the stream, so every mutation is serialised and
  every answer comes from a *committed* snapshot (snapshot isolation for
  free — concurrent readers can never observe a mid-ingest state,
  because mid-ingest states only ever exist inside the worker's call
  frame, and a failed ingest rolls back atomically before anyone else
  runs).  Full queues reject with a ``retry_after`` hint instead of
  blocking (backpressure must shed load at the edge).

* **Coalesced, bucketed query batches.**  Each tick the worker drains
  every pending query, packs the gather-shaped ones
  (``same_component``/``component_of``) into one ``(u, v)`` pair batch
  padded to a power-of-two bucket, and answers them with a single
  gather on the device against the engine's label array *at capacity*:
  one copy to the card, one indexing, one copy back, whatever the
  batch's size.  ``n_components`` answers ride a count made on the
  device once per committed snapshot.

* **Deadlines and cancellation.**  A request cancelled while queued is
  dropped unanswered (``Future`` cancel protocol); one whose deadline
  passed before the coalescer reached it resolves to
  :class:`DeadlineExceeded` without paying for a gather slot.

* **Recovery without dropping acks.**  With a ``CheckpointManager`` the
  engine checkpoints the stream every ``checkpoint_every`` committed
  batches (or immediately when a straggler monitor escalates) and keeps
  the committed-but-not-yet-checkpointed suffix in a host-side WAL.  A
  recoverable fault during ingest (a crash-class fault) discards the
  live engine, restores the last checkpoint, replays the WAL suffix,
  and retries — so an ingest whose future resolved OK (an *ack*) can
  never be lost, and the recovered stream is bit-identical to an
  uninterrupted one (DESIGN.md §12's atomic-ingest + deterministic-
  replay argument, applied to a live service).  Without a manager,
  ingest atomicity alone makes recoverable faults plain retries.

**The card.**  The worker thread issues every operation on the device
(the engine's device is made current in it); producer threads only
hand numpy arrays to the queues.  Queries and ingests are validated on
the host against the committed vertex count before they reach the
device: a CUDA gather with an id out of range raises a device-side
assert that poisons the context for every later request.  A kernel
that fails in an ingest fails that request's future (the stream rolls
back); it is never retried on a plain path.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch.connectivity.options import SolveOptions
from repro_torch.connectivity.result import ComponentResult
from repro_torch.connectivity.streaming import StreamingConnectivity
from repro_torch.graphs.structs import DeviceLike, resolve_device
from repro_torch.runtime.recovery import (FaultInjector, SimulatedFault,
                                          backoff_delay)
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.primitives import (BoundedQueue, QueueFull,
                                            ServeRequest, pow2_bucket)

QUERY_KINDS = ("same_component", "component_of", "n_components")
# floor for the query-batch bucket: tiny batches all share one shape
MIN_QUERY_BUCKET = 64


class EngineClosed(RuntimeError):
    """The engine is shut down; the request was not (or will not be)
    served."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before the engine answered it."""


@dataclasses.dataclass(frozen=True)
class IngestAck:
    """Successful-ingest acknowledgement (the ingest future's value).

    Once a client holds an ack, the batch is committed and — when the
    engine checkpoints — durable: recovery replays it, never drops it.

    Attributes:
      batch_index: position of the batch in the stream (0-based).
      n_vertices: logical vertex count after the batch.
      n_edges: real edges ingested so far (cumulative).
      visibility_lag_s: submit-to-committed wall time — how stale a
        query issued at submit time could have been.
    """

    batch_index: int
    n_vertices: int
    n_edges: int
    visibility_lag_s: float


@dataclasses.dataclass(frozen=True)
class _Query:
    kind: str
    u: int = 0
    v: int = 0


@dataclasses.dataclass(frozen=True)
class _Ingest:
    src: np.ndarray
    dst: np.ndarray
    n_vertices: Optional[int]


def _gather_pair_labels(labels: torch.Tensor, u: np.ndarray,
                        v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One gather on the labels' device for a whole coalesced query
    batch: ``(labels[u], labels[v])`` on the host.

    ``labels`` is the stream's label array at pow2 *capacity* and
    ``u``/``v`` are pow2-bucketed host arrays; they go to the device in
    one copy and the answers come back in one.  Bounds are validated on
    the host before this call: an index out of range on the card is a
    device-side assert.
    """
    uv = torch.from_numpy(np.stack([u, v])).to(labels.device)
    out = labels[uv].cpu().numpy()
    return out[0], out[1]


class ConnectivityEngine:
    """Async request-batching service over a streaming connectivity core.

    Example::

        eng = ConnectivityEngine(n_vertices=1_000_000)
        eng.start()
        ack = eng.submit_ingest(src, dst).result()     # committed
        fut = eng.submit_query("same_component", 0, 42)
        connected = fut.result()
        eng.close()

    Most callers want the
    :class:`~repro_torch.serving.client.ConnectivityClient` façade
    instead of raw futures.

    Args:
      n_vertices: initial vertex count of the stream.
      options / overrides: engine :class:`SolveOptions`, as for
        :class:`StreamingConnectivity`.
      max_pending_ingests / max_pending_queries: queue depth bounds;
        full queues reject with
        :class:`~repro_torch.serving.primitives.QueueFull` carrying a
        ``retry_after`` estimate.
      max_query_batch: coalescer drain bound per tick (also the largest
        gather bucket).
      manager: optional
        :class:`~repro_torch.checkpoint.manager.CheckpointManager`
        enabling crash-restart recovery (checkpoint cadence + WAL replay).
      checkpoint_every: checkpoint cadence in committed batches.
      recoverable: exception types treated as engine crashes (restore +
        replay + retry); anything else fails the ingest future and the
        stream stays intact (ingest is atomic).
      max_restarts: recovery budget across the engine's lifetime.
      backoff_base / backoff_factor / backoff_cap / sleep_fn: restart
        backoff schedule (0 = none), injectable for tests.
      straggler: optional :class:`StragglerMonitor` fed per-ingest wall
        time; a ``"checkpoint"``/``"evict"`` escalation forces an
        immediate out-of-cadence checkpoint.
      fault_injector: chaos hook threaded to the stream's ingest sites.
      metrics: a :class:`ServingMetrics` to record into (fresh if None).
      device: the stream's device; ``cuda`` unless named (tests pass
        ``"cpu"``).
    """

    def __init__(
        self,
        n_vertices: int,
        options: Optional[SolveOptions] = None,
        *,
        max_pending_ingests: int = 256,
        max_pending_queries: int = 8192,
        max_query_batch: int = 4096,
        manager=None,
        checkpoint_every: int = 64,
        recoverable: Tuple[Type[BaseException], ...] = (SimulatedFault,),
        max_restarts: int = 5,
        backoff_base: float = 0.0,
        backoff_factor: float = 2.0,
        backoff_cap: float = 30.0,
        sleep_fn=time.sleep,
        straggler: Optional[StragglerMonitor] = None,
        fault_injector: Optional[FaultInjector] = None,
        metrics: Optional[ServingMetrics] = None,
        device: DeviceLike = None,
        **overrides,
    ):
        if max_query_batch < 1:
            raise ValueError(
                f"max_query_batch must be >= 1, got {max_query_batch}")
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        self._options = options
        self._overrides = dict(overrides)
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            # the worker thread makes it current: name the caller's
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._fault_injector = fault_injector
        self._initial_n = int(n_vertices)
        self._stream = self._fresh_stream(n_vertices)
        self._ingest_q = BoundedQueue(max_pending_ingests, name="ingest")
        self._query_q = BoundedQueue(max_pending_queries, name="query")
        self.max_query_batch = int(max_query_batch)
        self._manager = manager
        self._checkpoint_every = int(checkpoint_every)
        self._recoverable = tuple(recoverable)
        self._max_restarts = int(max_restarts)
        self._restarts = 0
        self._backoff = (float(backoff_base), float(backoff_factor),
                         float(backoff_cap))
        self._sleep_fn = sleep_fn
        self._straggler = straggler
        self.metrics = metrics if metrics is not None else ServingMetrics()
        # committed-but-not-checkpointed suffix: [(batch_idx, _Ingest)]
        self._wal: List[Tuple[int, _Ingest]] = []
        self._ewma_tick = 1e-3          # service-rate estimate (s/tick)
        self._closed = False
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None

    def _fresh_stream(self, n_vertices: int) -> StreamingConnectivity:
        return StreamingConnectivity(
            n_vertices, self._options,
            fault_injector=self._fault_injector, device=self._device,
            **self._overrides)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ConnectivityEngine":
        """Spawn the worker thread (idempotent)."""
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run, name="connectivity-engine", daemon=True)
            self._worker.start()
        return self

    def __enter__(self) -> "ConnectivityEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, drain: bool = True) -> None:
        """Stop accepting requests; by default serve what is queued first.

        ``drain=False`` fails all still-pending requests with
        :class:`EngineClosed` instead.
        """
        self._closed = True
        if not drain:
            for q in (self._ingest_q, self._query_q):
                for req in q.drain():
                    self._resolve_exc(req, EngineClosed("engine closed"))
        self._wake.set()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._worker_error is not None:
            raise self._worker_error

    def flush(self, timeout: float = 60.0) -> None:
        """Block until both queues are empty and the worker is idle."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._worker_error is not None:
                raise self._worker_error
            if (len(self._ingest_q) == 0 and len(self._query_q) == 0
                    and self._idle.is_set()):
                return
            time.sleep(50e-6)
        raise TimeoutError(f"engine did not drain within {timeout}s")

    # -- introspection ---------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self._stream.n_vertices

    @property
    def n_batches(self) -> int:
        return self._stream.n_batches

    @property
    def restarts(self) -> int:
        return self._restarts

    @property
    def device(self) -> torch.device:
        return self._device

    def snapshot(self) -> ComponentResult:
        """Committed-state snapshot (worker-thread coherent: callers see
        some committed prefix, never a mid-ingest state)."""
        return self._stream.snapshot()

    # -- submission (client threads) -------------------------------------
    def _retry_after(self, queue: BoundedQueue) -> float:
        # service-rate heuristic: pending work / coalesced throughput,
        # floored at one tick
        pending = len(queue)
        ticks = 1.0 + pending / max(self.max_query_batch, 1)
        return self._ewma_tick * ticks

    def _submit(self, queue: BoundedQueue, payload,
                timeout: Optional[float]) -> Future:
        if self._closed:
            raise EngineClosed("engine closed")
        if self._worker_error is not None:
            raise self._worker_error
        now = time.perf_counter()
        req = ServeRequest(
            payload=payload, submitted=now,
            deadline=None if timeout is None else now + timeout)
        try:
            queue.put(req, retry_after=self._retry_after(queue))
        except QueueFull:
            self.metrics.bump("rejected")
            raise
        self._wake.set()
        return req.future

    def submit_query(self, kind: str, u: Optional[int] = None,
                     v: Optional[int] = None, *,
                     timeout: Optional[float] = None) -> Future:
        """Enqueue one query; the future resolves to its answer.

        ``same_component(u, v)`` -> bool; ``component_of(u)`` -> int
        (min vertex id of the component); ``n_components`` -> int.
        ``timeout`` is a *deadline*: if the coalescer reaches the
        request later than that, the future fails with
        :class:`DeadlineExceeded` instead of answering stale.
        """
        if kind not in QUERY_KINDS:
            raise ValueError(f"kind {kind!r} not one of {QUERY_KINDS}")
        if kind == "same_component":
            q = _Query(kind, int(u), int(v))
        elif kind == "component_of":
            if v is not None:
                raise ValueError("component_of takes a single vertex")
            q = _Query(kind, int(u), int(u))
        else:
            if u is not None or v is not None:
                raise ValueError("n_components takes no vertices")
            q = _Query(kind)
        return self._submit(self._query_q, q, timeout)

    def submit_ingest(self, src, dst, n_vertices: Optional[int] = None, *,
                      timeout: Optional[float] = None) -> Future:
        """Enqueue one edge micro-batch; resolves to an :class:`IngestAck`.

        The arrays are snapshotted to host NumPy at submit time (the WAL
        must be able to replay them after the caller mutates its
        buffers); a tensor is copied to the host here, in the caller's
        thread.
        """
        src, dst = (x.cpu().numpy() if isinstance(x, torch.Tensor) else x
                    for x in (src, dst))
        src = np.array(src, np.int32)
        dst = np.array(dst, np.int32)
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError(
                f"src/dst must be equal-length 1-D, got {src.shape} vs "
                f"{dst.shape}")
        return self._submit(
            self._ingest_q, _Ingest(src, dst, n_vertices), timeout)

    # -- worker loop -----------------------------------------------------
    def _run(self) -> None:
        # idle is only truthful while the worker is actually parked in
        # the wait branch below; it starts cleared so flush() cannot
        # return while the first tick is in flight
        self._idle.clear()
        try:
            # this thread issues every operation of the stream
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            while True:
                t0 = time.perf_counter()
                self.metrics.ingest_queue_depth.observe(len(self._ingest_q))
                self.metrics.query_queue_depth.observe(len(self._query_q))
                # queries first: reads coalesce against the committed
                # snapshot between ingest ticks
                batch = self._query_q.drain(self.max_query_batch)
                ingest = self._ingest_q.get_nowait()
                if batch:
                    self._answer_queries(batch)
                if ingest is not None:
                    self._ingest_tick(ingest)
                if batch or ingest is not None:
                    dt = time.perf_counter() - t0
                    self._ewma_tick = 0.9 * self._ewma_tick + 0.1 * dt
                    continue
                if self._closed:
                    return
                self._idle.set()
                self._wake.wait(timeout=5e-3)
                self._wake.clear()
                self._idle.clear()
        except BaseException as exc:  # noqa: BLE001 — fail loudly via futures
            self._worker_error = exc
            for q in (self._ingest_q, self._query_q):
                for req in q.drain():
                    self._resolve_exc(req, EngineClosed(
                        f"engine worker died: {exc!r}"))
            raise
        finally:
            self._idle.set()

    @staticmethod
    def _resolve_exc(req: ServeRequest, exc: Exception) -> None:
        if req.begin():
            req.future.set_exception(exc)

    # -- query coalescer -------------------------------------------------
    def _answer_queries(self, batch: Sequence[ServeRequest]) -> None:
        now = time.perf_counter()
        live: List[ServeRequest] = []
        for req in batch:
            if req.expired(now):
                self.metrics.bump("deadline_missed")
                self._resolve_exc(req, DeadlineExceeded(
                    "query deadline passed before the coalescer reached it"))
            elif req.begin():
                live.append(req)
            else:
                self.metrics.bump("cancelled")
        if not live:
            return
        self.metrics.bump("query_batches")
        n = self._stream.n_vertices
        gathers = [r for r in live if r.payload.kind != "n_components"]
        counts = [r for r in live if r.payload.kind == "n_components"]
        if counts:
            # one count on the device per committed snapshot
            k = self._stream.n_components
            for req in counts:
                req.future.set_result(k)
        if gathers:
            us = np.fromiter((r.payload.u for r in gathers), np.int32,
                             len(gathers))
            vs = np.fromiter((r.payload.v for r in gathers), np.int32,
                             len(gathers))
            # host-side bounds check against the committed vertex count:
            # an id out of range must never reach the device's gather
            # (see module docstring)
            bad = (us < 0) | (us >= n) | (vs < 0) | (vs >= n)
            if bad.any():
                ok: List[ServeRequest] = []
                for req, is_bad in zip(gathers, bad):
                    if is_bad:
                        req.future.set_exception(IndexError(
                            f"vertex id out of range for n_vertices={n} "
                            f"(query {req.payload.kind}({req.payload.u}, "
                            f"{req.payload.v}))"))
                    else:
                        ok.append(req)
                gathers = ok
                us, vs = us[~bad], vs[~bad]
        if gathers:
            bucket = pow2_bucket(len(gathers), MIN_QUERY_BUCKET)
            self.metrics.batch_sizes.observe(len(gathers))
            up = np.zeros(bucket, np.int32)
            vp = np.zeros(bucket, np.int32)
            up[:len(gathers)] = us
            vp[:len(gathers)] = vs
            lu, lv = _gather_pair_labels(self._stream._labels, up, vp)
            lu = lu[:len(gathers)]
            lv = lv[:len(gathers)]
            for i, req in enumerate(gathers):
                if req.payload.kind == "same_component":
                    req.future.set_result(bool(lu[i] == lv[i]))
                else:
                    req.future.set_result(int(lu[i]))
        done = time.perf_counter()
        self.metrics.query_latency.record_many(
            [done - r.submitted for r in live])
        self.metrics.bump("queries_answered", len(live))

    # -- ingest tick + recovery ------------------------------------------
    def _ingest_tick(self, req: ServeRequest) -> None:
        if req.expired():
            self.metrics.bump("deadline_missed")
            self._resolve_exc(req, DeadlineExceeded(
                "ingest deadline passed before the engine reached it"))
            return
        if not req.begin():
            self.metrics.bump("cancelled")
            return
        self.metrics.bump("ingest_ticks")
        ing: _Ingest = req.payload
        batch_idx = self._stream.n_batches
        while True:
            try:
                if self._straggler is not None:
                    self._straggler.start_step()
                self._stream.ingest(ing.src, ing.dst,
                                    n_vertices=ing.n_vertices)
                break
            except self._recoverable as exc:
                # crash class: the live engine is gone — restore the
                # last checkpoint, replay the acked suffix, retry
                self._restarts += 1
                self.metrics.bump("restarts")
                if self._restarts > self._max_restarts:
                    req.future.set_exception(exc)
                    raise
                base, factor, cap = self._backoff
                delay = backoff_delay(self._restarts, base=base,
                                      factor=factor, cap=cap)
                if delay > 0:
                    self._sleep_fn(delay)
                self._restore_and_replay()
                batch_idx = self._stream.n_batches
            except Exception as exc:  # noqa: BLE001 — per-request failure
                # caller-bug class (bad ids, shapes): ingest rolled back
                # atomically, the stream is intact — fail this request
                # only
                req.future.set_exception(exc)
                return
        if self._manager is not None:
            self._wal.append((batch_idx, ing))
        committed = self._stream.n_batches
        forced = False
        if self._straggler is not None:
            action = self._straggler.end_step()
            if action in ("checkpoint", "evict"):
                self.metrics.bump("straggler_events")
                forced = True
        if self._manager is not None and (
                forced or committed % self._checkpoint_every == 0):
            self._checkpoint(committed)
        lag = time.perf_counter() - req.submitted
        self.metrics.ingest_visibility.record(lag)
        self.metrics.bump("ingests_committed")
        self.metrics.bump("edges_ingested", int(ing.src.shape[0]))
        req.future.set_result(IngestAck(
            batch_index=batch_idx,
            n_vertices=self._stream.n_vertices,
            n_edges=self._stream.n_edges,
            visibility_lag_s=lag))

    def _checkpoint(self, committed: int) -> None:
        self._stream.save(self._manager, committed)
        self._manager.wait()
        self.metrics.bump("checkpoints")
        # checkpointed batches no longer need host-side replay state
        self._wal = [(i, b) for i, b in self._wal if i >= committed]

    def _restore_and_replay(self) -> None:
        """Rebuild the stream after a crash-class fault.

        With a manager: restore the last checkpoint and replay the WAL
        suffix (every committed batch after it) — acks are never lost.
        Without one, ingest atomicity means the in-memory stream is
        still exactly the committed state; there is nothing to rebuild.
        """
        if self._manager is None:
            return
        if self._manager.latest_step() is not None:
            self._stream, step = StreamingConnectivity.restore(
                self._manager, self._options,
                fault_injector=self._fault_injector, device=self._device,
                **self._overrides)
        else:
            # no checkpoint yet: the WAL holds *every* committed batch,
            # so a cold rebuild from the engine's initial vertex count
            # replays the whole committed prefix
            self._stream, step = self._fresh_stream(self._initial_n), 0
        for _, b in sorted(((i, b) for i, b in self._wal if i >= step),
                           key=lambda e: e[0]):
            self._stream.ingest(b.src, b.dst, n_vertices=b.n_vertices)
            self.metrics.bump("replayed_batches")
