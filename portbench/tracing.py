"""What a traced run (``--trace 1``) records, from the benchmark's side.

The port's kernels are launched through ``ctypes`` from libraries that
``nvcc`` built, and ``torch.profiler`` does not see them.  So:

* :class:`KernelClock` wraps every launcher of the connectivity
  libraries the process has loaded with a pair of CUDA events on the
  current stream (the stream the launcher is handed), grouped by call.
* :class:`SyncCounter` counts the host's waits for the device, as
  ``torch.cuda.set_sync_debug_mode("warn")`` flags them, by the source
  line of the innermost frame of the port on the stack, and marks each
  with a CUDA event so that an idle gap can be named by the wait before
  it.
* :func:`profiler_kernels` reads torch's own device work (kernels,
  copies, fills) from ``torch.profiler``'s kineto events.
* :func:`idle_gaps` puts both on one time line, aligned call by call
  through a marker kernel launched right after the call's first event,
  and names each gap on the device by what the host did before it.
"""
from __future__ import annotations

import bisect
import ctypes
import sys
import warnings
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

# a launcher takes the stream last and at least two more arguments; the
# libraries' queries (``contour_fleet_device``, ``_shapes``) take one
MIN_LAUNCH_ARGS = 3
# the connectivity libraries (``repro_torch/kernels/_build.py`` names)
LIBRARY_PREFIX = "contour"
# the marker kernel's op: one element negated, nothing in the port uses it
MARKER_KERNEL = "neg_kernel"


class _Timed:
    """A launcher that records CUDA events around each call."""

    def __init__(self, fn, name: str, clock: "KernelClock"):
        self._fn = fn
        self.__name__ = name
        self._clock = clock

    def __call__(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = self._fn(*args)
        end.record()
        self._clock.record(self.__name__, start, end)
        return rc


class KernelClock:
    """CUDA events around every launch of the port's kernels."""

    def __init__(self):
        self.calls: List[list] = []
        self._current: Optional[list] = None
        self._wrapped: List[Tuple[ctypes.CDLL, str, object]] = []

    def install(self, libraries: Dict[str, ctypes.CDLL]) -> List[str]:
        """Wrap the launchers of the loaded connectivity libraries; returns
        their names.  A library loads and declares its functions on first
        use, so install after the warm-up."""
        names = []
        for lib_name, lib in libraries.items():
            if not lib_name.startswith(LIBRARY_PREFIX):
                continue
            for name, fn in list(vars(lib).items()):
                if not isinstance(fn, ctypes._CFuncPtr):
                    continue
                if len(fn.argtypes or ()) < MIN_LAUNCH_ARGS:
                    continue
                setattr(lib, name, _Timed(fn, name, self))
                self._wrapped.append((lib, name, fn))
                names.append(name)
        return sorted(names)

    def uninstall(self) -> None:
        for lib, name, fn in self._wrapped:
            setattr(lib, name, fn)
        self._wrapped.clear()

    def begin_call(self) -> None:
        self._current = []
        self.calls.append(self._current)

    def end_call(self) -> None:
        self._current = None

    def record(self, name: str, start, end) -> None:
        if self._current is not None:
            self._current.append((name, start, end))

    def resolve(self, call_starts) -> List[List[Tuple[str, float, float]]]:
        """Each call's launches as ``(name, start_ms, end_ms)`` from the
        call's start event (synchronizes)."""
        torch.cuda.synchronize()
        out = []
        for t0, launches in zip(call_starts, self.calls):
            out.append([(name, t0.elapsed_time(s), t0.elapsed_time(e))
                        for name, s, e in launches])
        return out


class SyncCounter:
    """Counts the host's synchronizations, by site, call by call."""

    def __init__(self, package_dir: Path, marks: bool = True):
        self._ours = str(package_dir)
        self._marks = marks
        self.calls: List[Counter] = []
        self.marks: List[list] = []
        self._current: Optional[Counter] = None
        self._saved = None

    def _site(self) -> Optional[str]:
        """The innermost frame of the port on the stack, or None where the
        wait is not the port's (the benchmark's own)."""
        frame = sys._getframe(2)
        while frame is not None:
            if frame.f_code.co_filename.startswith(self._ours):
                name = Path(frame.f_code.co_filename).name
                return f"{name}:{frame.f_lineno}"
            frame = frame.f_back
        return None

    def _record(self, message, category, filename, lineno, file=None,
                line=None):
        if self._current is None or "synchroniz" not in str(message):
            return
        site = self._site()
        if site is None:
            return
        self._current[site] += 1
        if self._marks:
            # an event at the wait: it completes when the work before it
            # does, which is where the device goes idle if the host waits
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[-1].append((site, ev))

    def begin_call(self) -> None:
        self._current = Counter()
        self.calls.append(self._current)
        self.marks.append([])
        torch.cuda.set_sync_debug_mode("warn")

    def end_call(self) -> None:
        torch.cuda.set_sync_debug_mode("default")
        self._current = None

    def __enter__(self):
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        self._saved = warnings.showwarning
        warnings.showwarning = self._record
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = self._saved
        self._catch.__exit__(*exc)


def profiler_kernels(prof) -> List[Tuple[str, float, float]]:
    """torch's device work in a finished ``torch.profiler.profile``:
    ``(name, start_us, end_us)`` of every kernel, copy and fill."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        out.append((ev.name(), ev.start_ns() / 1e3, ev.end_ns() / 1e3))
    return sorted(out, key=lambda k: k[1])


def align_calls(markers_us, starts, spans_ms, tolerance_us: float = 200.0):
    """Each call's ``(start, end)`` on the profiler's clock, or None where
    its marker kernel is missing from the trace.

    With a marker for every call they pair in order.  Otherwise the calls
    are walked from the last: each takes the marker nearest the time that
    its start event's distance from the last matched call predicts,
    within ``tolerance_us`` (distances between neighbours, so the two
    clocks' drift over the window does not add up)."""
    if len(markers_us) == len(starts):
        return [(m, m + 1e3 * ms) for m, ms in zip(markers_us, spans_ms)]
    out = [None] * len(starts)
    if not markers_us:
        return out
    anchor_call, anchor_us = len(starts) - 1, markers_us[-1]
    out[-1] = (anchor_us, anchor_us + 1e3 * spans_ms[-1])
    j = len(markers_us) - 2
    for i in range(len(starts) - 2, -1, -1):
        want = anchor_us - 1e3 * starts[i].elapsed_time(starts[anchor_call])
        while j > 0 and abs(markers_us[j - 1] - want) <= \
                abs(markers_us[j] - want):
            j -= 1
        if j >= 0 and abs(markers_us[j] - want) <= tolerance_us:
            anchor_call, anchor_us = i, markers_us[j]
            out[i] = (anchor_us, anchor_us + 1e3 * spans_ms[i])
            j -= 1
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_gaps(call_spans_us, launches, marks, torch_kernels,
              min_gap_us: float = 2.0):
    """Idle time on the device inside each call, summed by what preceded
    each gap on the host: ``{name: seconds}``.

    ``call_spans_us`` are the calls' ``(start, end)`` on the profiler's
    clock, found from their marker kernels; ``launches`` and ``marks``
    are each call's port launches ``(name, start_ms, end_ms)`` and sync
    marks ``(site, ms)`` from the call's start event.  A gap that begins
    where a sync mark lies (within ``min_gap_us``) is the host's wait and
    what followed it, named by the sync's site; any other gap is the
    host's enqueueing, named by the work that ends it.
    """
    gaps: Counter = Counter()
    begins = [s for _, s, _ in torch_kernels]
    for (c0, c1), call_launches, call_marks in zip(call_spans_us, launches,
                                                   marks):
        lo, hi = bisect.bisect_left(begins, c0), bisect.bisect_left(begins, c1)
        busy = [(s, min(e, c1), name) for name, s, e in torch_kernels[lo:hi]]
        for name, s, e in call_launches:
            busy.append((c0 + 1e3 * s, c0 + 1e3 * e, name))
        busy.sort()
        sync_at = sorted(c0 + 1e3 * t for _, t in call_marks)
        sites = [site for site, _ in sorted(call_marks, key=lambda m: m[1])]
        end = c0
        for s, e, name in busy:
            if s - end >= min_gap_us:
                label = f"enqueue before {name[:60]}"
                for t, site in zip(sync_at, sites):
                    if abs(t - end) <= min_gap_us or end <= t <= s:
                        label = f"after sync at {site}"
                        break
                gaps[label] += (s - end) / 1e6
            end = max(end, e)
        if c1 - end >= min_gap_us:
            gaps["after the last work of the call"] += (c1 - end) / 1e6
    return gaps
