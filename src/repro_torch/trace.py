"""Spans and counters of the port's solve path, on the profiler's clock.

The one span system of the port.  A span is a named interval of the
host's work (``solve``, ``solve.plan``, ``loop.chunk``, one kernel
launch, one read of a device value); a counter adds numbers to the open
request.  Each span records its name, its start and end, its own id,
its parent's id and its request's id: a span opened with no span open on
its thread starts a new request, so ``solve``'s span is the root of its
call and every span of the call shares the call's id.

Recording is on while a ``torch.profiler`` session runs (torch's own
fast flag, ``torch.autograd.profiler._is_profiler_enabled``) or inside
:func:`recording`.  Off, :func:`span` returns one shared no-op object
and :func:`count` returns at once: neither reads a clock, allocates or
touches the stack of open spans.  On, each span also opens
``torch.profiler.record_function(name)``, so under
``profile(activities=[CPU, CUDA])`` the spans sit in the chrome trace
over the kernels they launch.  Stamps are ``time.time_ns()``: the Unix
clock that the profiler's events are given in.

The store lives in memory and holds at most :data:`MAX_SPANS` spans;
past that it drops them and counts how many it dropped::

    from repro_torch import solve, trace

    with trace.recording():
        solve(graph)
    snap = trace.snapshot()   # {"spans": [Span, ...], "counters": {...},
                              #  "dropped": 0}
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler

# the store's bound: spans, and requests holding counters
MAX_SPANS = 1 << 20


class Span(NamedTuple):
    """One recorded span: times in ns on the profiler's (Unix) clock;
    ``parent`` is None at a request's root, whose ``id`` is the
    ``request``."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: int


class _Off:
    """The no-op span every call shares while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()
_spans: list = []
# request id -> {counter name: value}; counts outside a request go to None
_counters: dict = {}
_dropped = 0
_recording = 0
_ids = itertools.count(1)
_local = threading.local()
# guards the store's read-modify-writes across threads
_lock = threading.Lock()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "request", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.request = top.id, top.request
        else:
            self.parent, self.request = None, self.id
        stack.append(self)
        self.range = _profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _dropped
        end = time.time_ns()
        self.range.__exit__(exc_type, exc, tb)
        _local.stack.pop()
        record = Span(self.name, self.start, end, self.id, self.parent,
                      self.request)
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(record)
            else:
                _dropped += 1
        return False


def span(name: str, suffix: Optional[str] = None):
    """A context manager timing the host's work inside it, named ``name``
    (``name + suffix`` with a suffix, joined only while recording)."""
    if not (_profiler._is_profiler_enabled or _recording):
        return _OFF
    return _Span(name if suffix is None else name + suffix)


def count(name: str, by=1) -> None:
    """Add ``by`` to the counter ``name`` of the open request."""
    global _dropped
    if not (_profiler._is_profiler_enabled or _recording):
        return
    stack = _stack()
    request = stack[0].request if stack else None
    with _lock:
        counters = _counters.get(request)
        if counters is None:
            if len(_counters) >= MAX_SPANS:
                _dropped += 1
                return
            counters = _counters[request] = {}
        counters[name] = counters.get(name, 0) + by


@contextmanager
def recording():
    """Record spans and counters inside, into an emptied store."""
    global _recording
    clear()
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def snapshot() -> dict:
    """The store: ``spans`` (:class:`Span` in the order they ended),
    ``counters`` ({request: {name: value}}) and ``dropped``."""
    with _lock:
        return {"spans": list(_spans),
                "counters": {r: dict(c) for r, c in _counters.items()},
                "dropped": _dropped}


def clear() -> None:
    """Empty the store."""
    global _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0
