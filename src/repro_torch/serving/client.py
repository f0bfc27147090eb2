"""Client façade over :class:`~repro_torch.serving.engine.ConnectivityEngine`.

The port's copy of ``repro.serving.client``.

The engine speaks futures; most callers want one of two ergonomic
surfaces on top:

* **Sync** — ``client.same_component(u, v)`` blocks until the coalescer
  answers (optionally bounded by ``timeout``, which doubles as the
  server-side deadline: a request the engine cannot reach in time fails
  with :class:`~repro_torch.serving.engine.DeadlineExceeded` rather than
  answering stale).

* **Async** — the ``*_async`` variants return
  :class:`concurrent.futures.Future`\\ s so a client thread can keep
  hundreds of requests in flight (the whole point of the coalescer:
  concurrent pending queries become one gather on the device).  ``Future.
  cancel()`` works while the request is still queued.

``retries`` makes the client cooperate with engine backpressure: a
:class:`~repro_torch.serving.primitives.QueueFull` rejection sleeps the
suggested ``retry_after`` (doubled per consecutive rejection, capped at
``RETRY_CAP_S`` — the engine's hint is an EWMA of recent tick times,
which undershoots badly during a cold start, while the kernels build
and the first batches warm the card) and resubmits, up to the budget.
"""
from __future__ import annotations

import time
from concurrent.futures import Future
from typing import List, Optional

from repro_torch.serving.engine import ConnectivityEngine, IngestAck
from repro_torch.serving.primitives import QueueFull

RETRY_CAP_S = 0.25


class ConnectivityClient:
    """Sync/async request surface for one :class:`ConnectivityEngine`.

    Args:
      engine: the (started) engine to talk to.
      retries: resubmission budget when the engine rejects with
        backpressure; 0 = surface :class:`QueueFull` immediately.
      retry_sleep: sleep function (injectable for tests); receives the
        backed-off ``retry_after`` hint.
    """

    def __init__(self, engine: ConnectivityEngine, *, retries: int = 12,
                 retry_sleep=time.sleep):
        self.engine = engine
        self.retries = int(retries)
        self._sleep = retry_sleep

    def _with_backpressure(self, submit) -> Future:
        attempt = 0
        while True:
            try:
                return submit()
            except QueueFull as exc:
                attempt += 1
                if attempt > self.retries:
                    raise
                self._sleep(min(max(exc.retry_after, 1e-4)
                                * 2.0 ** (attempt - 1), RETRY_CAP_S))

    # -- async surface ---------------------------------------------------
    def same_component_async(self, u: int, v: int, *,
                             timeout: Optional[float] = None) -> Future:
        return self._with_backpressure(
            lambda: self.engine.submit_query("same_component", u, v,
                                             timeout=timeout))

    def component_of_async(self, v: int, *,
                           timeout: Optional[float] = None) -> Future:
        return self._with_backpressure(
            lambda: self.engine.submit_query("component_of", v,
                                             timeout=timeout))

    def n_components_async(self, *,
                           timeout: Optional[float] = None) -> Future:
        return self._with_backpressure(
            lambda: self.engine.submit_query("n_components",
                                             timeout=timeout))

    def ingest_async(self, src, dst, n_vertices: Optional[int] = None, *,
                     timeout: Optional[float] = None) -> Future:
        return self._with_backpressure(
            lambda: self.engine.submit_ingest(src, dst, n_vertices,
                                              timeout=timeout))

    # -- sync surface ----------------------------------------------------
    def same_component(self, u: int, v: int, *,
                       timeout: Optional[float] = None) -> bool:
        return self.same_component_async(u, v, timeout=timeout).result(
            timeout)

    def component_of(self, v: int, *,
                     timeout: Optional[float] = None) -> int:
        return self.component_of_async(v, timeout=timeout).result(timeout)

    def n_components(self, *, timeout: Optional[float] = None) -> int:
        return self.n_components_async(timeout=timeout).result(timeout)

    def ingest(self, src, dst, n_vertices: Optional[int] = None, *,
               timeout: Optional[float] = None) -> IngestAck:
        """Submit one edge micro-batch and block for its ack.

        A returned :class:`IngestAck` means the batch is committed —
        subsequent queries observe it, and with checkpointing enabled a
        crash-restarted engine replays it (zero acked-ingest loss).
        """
        return self.ingest_async(src, dst, n_vertices,
                                 timeout=timeout).result(timeout)

    def map_component_of(self, vertices, *,
                         timeout: Optional[float] = None) -> List[int]:
        """Bulk helper: fan a vertex list into in-flight queries, gather
        the answers in order (exercises the coalescer from one thread)."""
        futs = [self.component_of_async(int(v), timeout=timeout)
                for v in vertices]
        return [f.result(timeout) for f in futs]
