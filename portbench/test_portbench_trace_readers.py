"""The readers of the program's own spans and counters (``prologue_ms``,
``relaunch_ms``, ``host_reads``, ``loop_useful_share``) on a hand-built
store, on an empty one, and on a solve recorded on the CPU."""
import pytest

torch = pytest.importorskip("torch")

from portbench import harness  # noqa: E402
from repro_torch import SolveOptions, solve, trace  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.trace import Span  # noqa: E402

READERS = ("prologue_ms", "relaunch_ms", "host_reads", "loop_useful_share")
MS = 1_000_000  # ns


def _call(request, t0, reads, launches, enqueued, iterations, init=True):
    """A solve request at ``t0`` ms: ``reads`` and ``launches`` are
    ``(start, end)`` in ms from ``t0``."""
    ids = iter(range(request + 1, request + 100))
    spans = [Span("solve", t0 * MS, (t0 + 50) * MS, request, None, request)]
    if init:
        spans.append(Span("contour.init", (t0 + 0.5) * MS, (t0 + 0.6) * MS,
                          next(ids), request, request))
    for kind, items in (("read.loop", reads),
                        ("launch.contour_fused_relax", launches)):
        for s, e in items:
            spans.append(Span(kind, (t0 + s) * MS, (t0 + e) * MS, next(ids),
                              request, request))
    counters = {"loop.enqueued": enqueued, "loop.iterations": iterations}
    return spans, {request: counters}


def _store(*calls, other=()):
    spans, counters = list(other), {}
    for s, c in calls:
        spans += s
        counters.update(c)
    return {"spans": spans, "counters": counters, "dropped": 0}


@pytest.fixture
def read(monkeypatch):
    def read_with(store):
        monkeypatch.setattr(trace, "snapshot", lambda: store)
        return {name: harness.reader(name)({}) for name in READERS}
    return read_with


def test_the_readers_arithmetic(read):
    # call 1: a read at 10-11 relaunched at 11.25, a read at 20-21 that
    # no launch follows; call 2: one read at 5-6, relaunched at 6.75
    one = _call(100, 0.0, [(10, 11), (20, 21)], [(1, 2), (11.25, 12)], 8, 5)
    two = _call(200, 100.0, [(5, 6)], [(1, 2), (6.75, 7)], 4, 3, init=False)
    # a request whose root is not a solve is left out
    other = [Span("solve.result", 0, MS, 300, None, 300),
             Span("read.counts", 0, MS, 301, 300, 300)]
    got = read(_store(one, two, other=other))
    assert got["prologue_ms"] == pytest.approx(0.5)        # call 1 alone
    assert got["relaunch_ms"] == pytest.approx((0.25 + 0.75) / 2)
    assert got["host_reads"] == pytest.approx(1.5)
    assert got["loop_useful_share"] == pytest.approx(100 * 8 / 12)


def test_the_readers_find_nothing_in_an_empty_store(read):
    assert read(_store()) == dict.fromkeys(READERS)
    trace.clear()
    assert {name: harness.reader(name)({}) for name in READERS} \
        == dict.fromkeys(READERS)


def test_the_readers_on_a_recorded_solve():
    g = gen.path(100, device="cpu")
    try:
        with trace.recording():
            for _ in range(2):
                result = solve(g, SolveOptions(backend="torch"))
        got = {name: harness.reader(name)({}) for name in READERS}
    finally:
        trace.clear()
    assert int(result.iterations) == 5
    assert got["host_reads"] == 2           # one read a chunk of 4
    assert got["loop_useful_share"] == pytest.approx(100 * 5 / 8)
    assert got["prologue_ms"] > 0
    # the plain backend launches no kernel: nothing to relaunch
    assert got["relaunch_ms"] == 0
