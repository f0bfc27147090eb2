"""The port's spans and counters (``repro_torch.trace``) on the solve path.

On the CPU: tracing off records nothing and does nothing; under
``recording()`` a solve is one request whose spans form a tree, with the
loop's counters.  Marked ``cuda`` (skipped without a card): the spans'
stamps and the profiler's events on one clock, and a launch span for
every launch a wrapper counts.  JAX-free::

    PYTHONPATH=src python -m pytest -q tests/test_torch_trace.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import SolveOptions, solve, trace  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels import contour_mm  # noqa: E402
from repro_torch.kernels.contour_mm import converged  # noqa: E402

PLAIN = SolveOptions(backend="torch")
# the spans of one dense Contour solve (launches come on the card)
SOLVE_SPANS = {"solve", "solve.resolve", "solve.plan", "contour.init",
               "contour.loop", "loop.chunk", "read.loop", "contour.finish",
               "solve.result"}


@pytest.fixture(autouse=True)
def empty_store():
    trace.clear()
    yield
    trace.clear()


class _Untouchable:
    """Raises on any use: what tracing off must not reach."""

    def __getattr__(self, name):
        raise AssertionError(f"tracing off reached .{name}")

    def __call__(self, *args, **kwargs):
        raise AssertionError("tracing off made a span")


def test_off_records_reads_no_clock_and_makes_nothing(monkeypatch):
    g = gen.path(100, device="cpu")
    for name in ("time", "_local", "_Span", "_counters"):
        monkeypatch.setattr(trace, name, _Untouchable())
    assert trace.span("x") is trace.span("y")
    assert trace.span("launch.", "k") is trace.span("x")
    result = solve(g, PLAIN)
    assert int(result.iterations) == 5
    monkeypatch.undo()
    assert trace.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


def _tree(snap):
    spans = snap["spans"]
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == 1
    root = roots[0]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.request == root.id
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    return root, by_id


@pytest.mark.parametrize("k, iterations, chunks", [
    (16, 3, 1),    # converges mid-chunk
    (30, 4, 1),    # converges on the chunk's last iteration
    (100, 5, 2),   # one read past the first chunk
])
def test_a_solve_is_one_request_with_the_loops_counters(k, iterations,
                                                        chunks):
    g = gen.path(k, device="cpu")
    with trace.recording():
        result = solve(g, PLAIN)
    assert int(result.iterations) == iterations
    snap = trace.snapshot()
    root, by_id = _tree(snap)
    assert root.name == "solve"
    names = [s.name for s in snap["spans"]]
    assert set(names) == SOLVE_SPANS
    assert names.count("loop.chunk") == chunks
    assert names.count("read.loop") == chunks
    for s in snap["spans"]:
        if s.name in ("loop.chunk", "read.loop"):
            assert by_id[s.parent].name == "contour.loop"
        if s.name in ("contour.init", "contour.loop", "contour.finish",
                      "solve.resolve", "solve.plan", "solve.result"):
            assert by_id[s.parent].name == "solve"
    assert snap["counters"] == {root.id: {
        "loop.enqueued": converged.CHUNK * chunks,
        "loop.iterations": iterations}}
    assert snap["dropped"] == 0


def test_requests_nest_counters_and_recording_starts_empty():
    g = gen.path(16, device="cpu")
    with trace.recording():
        solve(g, PLAIN)
    with trace.recording():
        solve(g, PLAIN)
        solve(g, PLAIN)
        trace.count("outside", 2)
    snap = trace.snapshot()
    roots = [s for s in snap["spans"] if s.parent is None]
    assert [r.name for r in roots] == ["solve", "solve"]
    assert roots[0].id != roots[1].id
    assert snap["counters"][None] == {"outside": 2}
    assert snap["counters"][roots[1].id]["loop.iterations"] == 3


def test_the_store_bound_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with trace.recording():
        for name in "abcde":
            with trace.span(name):
                pass
        for request in range(4):
            with trace.span("r"):
                trace.count("n")
    snap = trace.snapshot()
    assert [s.name for s in snap["spans"]] == ["a", "b", "c"]
    # 2 + 4 spans past the bound, and a request's counters past it
    assert snap["dropped"] == 7
    assert len(snap["counters"]) == 3


def test_threads_keep_their_own_requests_and_lose_no_count():
    import os
    import sys
    import threading

    workers, rounds = 2 * (os.cpu_count() or 4), 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording():
            def work():
                with trace.span("job"):
                    for _ in range(rounds):
                        with trace.span("step"):
                            trace.count("n")
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = trace.snapshot()
    jobs = {s.id for s in snap["spans"] if s.name == "job"}
    assert len(jobs) == workers
    assert all(s.request in jobs and s.parent == s.request
               for s in snap["spans"] if s.name == "step")
    assert len(snap["spans"]) == workers * (rounds + 1)
    assert snap["counters"] == {j: {"n": rounds} for j in jobs}


def test_a_span_closes_on_an_error_and_the_stack_unwinds():
    with trace.recording():
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise ValueError("x")
        with trace.span("next"):
            pass
    spans = {s.name: s for s in trace.snapshot()["spans"]}
    assert spans["inner"].parent == spans["outer"].id
    assert spans["next"].parent is None


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_and_the_profiler_share_one_clock(cuda):
    from torch.profiler import ProfilerActivity, profile

    L = torch.arange(1 << 20, dtype=torch.int32, device=cuda).flip(0)
    L = torch.minimum(L, torch.arange(1 << 20, dtype=torch.int32,
                                      device=cuda))
    converged.pointer_jump(L)           # builds and loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.span("warm"):
            pass
        torch.cuda.synchronize()
        converged.pointer_jump(L)
        torch.cuda.synchronize()
    ours = [s for s in trace.snapshot()["spans"]
            if s.name == "launch.contour_pointer_jump"]
    assert len(ours) == 1
    span = ours[0]
    events = list(prof.profiler.kineto_results.events())
    ranges = [e for e in events if e.name() == span.name
              and e.device_type() != torch.autograd.DeviceType.CUDA]
    assert len(ranges) == 1
    assert abs(ranges[0].start_ns() - span.start_ns) <= 50_000
    kernels = [e for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "jump_kernel" in e.name()]
    assert len(kernels) == 1
    assert span.start_ns <= kernels[0].start_ns() <= span.end_ns + 2_000_000


@pytest.mark.cuda
def test_launch_spans_equal_the_wrappers_launch_counts(cuda):
    g = gen.rmat(14, seed=5, device=cuda)
    solve(g)                            # builds and loads the libraries
    torch.cuda.synchronize()
    contour_mm.reset_launch_counts()
    with trace.recording():
        result = solve(g)
        torch.cuda.synchronize()
    spans = [s.name for s in trace.snapshot()["spans"]]
    launched = 0
    for wrapper in contour_mm.KERNELS + contour_mm.LOOP_KERNELS:
        name = f"launch.contour_{wrapper.__name__}"
        assert spans.count(name) == wrapper.launches, name
        launched += wrapper.launches
    assert launched > 0
    assert launched == sum(1 for s in spans if s.startswith("launch."))
    assert spans.count("read.loop") == spans.count("loop.chunk") >= 1
    assert int(result.iterations) >= 1
