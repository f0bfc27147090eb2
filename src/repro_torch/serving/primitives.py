"""Generic request/queue primitives of the serving layer.

The port's copy of ``repro.serving.primitives``, for its connectivity
engine (``repro_torch.serving.engine``) and its LM server
(``repro_torch.launch.serve``).

* :class:`BoundedQueue` — thread-safe FIFO with **reject-not-block**
  admission: a full queue raises :class:`QueueFull` carrying a
  ``retry_after`` hint instead of blocking the producer, the JetStream
  backpressure idiom (an overloaded engine must shed load at the edge,
  not wedge every client thread).  Consumers drain in batches
  (``drain``/``get_batch``) so a coalescer takes everything pending in
  one lock acquisition.

* :class:`SlotPool` — a fixed pool of integer slots handed out lowest
  first: the LM server's continuous-batching resource model.

* :class:`ServeRequest` — payload + :class:`concurrent.futures.Future`
  + submit timestamp + optional deadline.  The future carries the
  answer to sync *and* async callers; ``begin()`` resolves the
  cancellation race (a request cancelled while queued is never
  answered).

* :func:`pow2_bucket` — the repo-wide bucketing rule (ring-buffer
  sizes, ingest padding, query-batch shapes all quantise to powers of
  two).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, List, Optional


def pow2_bucket(k: int, lo: int = 1) -> int:
    """Smallest power of two >= max(k, lo).

    The shared bucketing rule: padding every dynamic extent (ingest
    batch, query batch, ring capacity) to a power-of-two bucket keeps
    the number of distinct shapes logarithmic in the largest extent ever
    seen (the reference's compile caches; here the caching allocator's
    block sizes).
    """
    k = max(int(k), int(lo), 1)
    return 1 << (k - 1).bit_length()


class QueueFull(Exception):
    """Admission rejected: the queue is at capacity (backpressure).

    Attributes:
      name: queue name (e.g. ``"ingest"`` / ``"query"``).
      depth: capacity at rejection time.
      retry_after: suggested client wait in seconds before retrying
        (an engine-side service-rate estimate; 0.0 when unknown).
    """

    def __init__(self, name: str, depth: int, retry_after: float = 0.0):
        super().__init__(
            f"{name} queue full (depth {depth}); retry after "
            f"{retry_after * 1e3:.1f} ms")
        self.name = name
        self.depth = depth
        self.retry_after = float(retry_after)


class BoundedQueue:
    """Thread-safe bounded FIFO with reject-not-block admission.

    ``maxsize=None`` disables the bound (e.g. a serve-to-completion
    admission queue that holds the whole request list).
    """

    def __init__(self, maxsize: Optional[int] = None, name: str = "queue"):
        if maxsize is not None and maxsize < 1:
            raise ValueError(f"maxsize must be >= 1 or None, got {maxsize}")
        self.maxsize = maxsize
        self.name = name
        self._items: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def put(self, item: Any, retry_after: float = 0.0) -> None:
        """Append ``item``; raises :class:`QueueFull` at capacity."""
        with self._lock:
            if self.maxsize is not None and len(self._items) >= self.maxsize:
                raise QueueFull(self.name, self.maxsize, retry_after)
            self._items.append(item)
            self._not_empty.notify()

    def get_nowait(self) -> Optional[Any]:
        """Pop the head, or None when empty (never blocks)."""
        with self._lock:
            return self._items.popleft() if self._items else None

    def drain(self, max_items: Optional[int] = None) -> List[Any]:
        """Pop up to ``max_items`` (all, when None) in FIFO order.

        One lock acquisition for the whole batch — the coalescer's
        fast path.
        """
        with self._lock:
            k = len(self._items) if max_items is None \
                else min(max_items, len(self._items))
            return [self._items.popleft() for _ in range(k)]

    def get_batch(self, max_items: int, timeout: float) -> List[Any]:
        """Block until >= 1 item (or ``timeout``), then drain a batch."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while not self._items:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._not_empty.wait(remaining):
                    if not self._items:
                        return []
            k = min(max_items, len(self._items))
            return [self._items.popleft() for _ in range(k)]


class SlotPool:
    """Fixed pool of integer slots (continuous-batching resource model).

    ``acquire`` hands out the lowest free slot id or None; ``release``
    returns it.  Thread-safe, though the LM server drives it from one
    thread.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))  # pop() -> lowest id
        self._lock = threading.Lock()

    def acquire(self) -> Optional[int]:
        with self._lock:
            return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        with self._lock:
            if not 0 <= slot < self.n_slots or slot in self._free:
                raise ValueError(f"bad release of slot {slot}")
            self._free.append(slot)
            self._free.sort(reverse=True)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def n_busy(self) -> int:
        return self.n_slots - self.n_free


@dataclasses.dataclass
class ServeRequest:
    """A queued request: payload + future + timing metadata.

    ``submitted`` is a ``time.perf_counter`` stamp (latency measurement);
    ``deadline`` is an absolute ``perf_counter`` deadline or None.
    """

    payload: Any
    future: Future = dataclasses.field(default_factory=Future)
    submitted: float = dataclasses.field(default_factory=time.perf_counter)
    deadline: Optional[float] = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline

    def begin(self) -> bool:
        """Claim the request for execution.

        Returns False when the client cancelled it while queued — the
        worker must then drop it unanswered.  After a True return the
        request can no longer be cancelled (the standard
        ``Future.set_running_or_notify_cancel`` protocol).
        """
        return self.future.set_running_or_notify_cancel()
