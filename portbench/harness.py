"""Drive one cell of ``BENCHMARK.json``: set up, measure, check, report.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:

* ``portbench/configs/<config>.json`` (the entry's ``file``): the
  generator, its published parameters, the ``SolveOptions`` and the
  guarantee;
* ``portbench/traffic/<traffic>.json``: which drive runs the window
  (``"drive"``), parameter overrides for the graph (``"graph"``) and the
  drive's own parameters;
* ``portbench/drives/<drive>.py``: a ``Drive`` class, one user request a
  ``call()``;
* ``portbench/metrics/<metric>.py``: ``read(record)``, the metric's value
  from the run's record, or None where it finds nothing to read;
* a generator is a function of ``portbench/graphs.py``, named by the
  configuration's ``"generator"``.

:func:`run_cell` is the whole run after the check for a card: the entry
of ``run.py`` on the card and of the CPU tests.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench import graphs, tracing

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_workload(spec: dict, name: str) -> dict:
    """The cell's entry in ``BENCHMARK.json``."""
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_parts(spec: dict, name: str):
    """``(workload, config, traffic)`` of a cell, each a dict."""
    workload = find_workload(spec, name)
    entry = next(c for c in spec["configs"] if c["name"] == workload["config"])
    config = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{workload['traffic']}.json")
    return workload, config, traffic


def metrics_for(spec: dict, name: str, trace: bool) -> List[dict]:
    """The metrics a run of cell ``name`` reports."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str):
    safe = metric.replace(".", "_").replace("-", "_")
    return _module(HERE / "metrics" / f"{metric}.py",
                   f"portbench_metric_{safe}").read


def drive_class(kind: str):
    return _module(HERE / "drives" / f"{kind}.py",
                   f"portbench_drive_{kind}").Drive


def generator(name: str):
    """A generator of ``graphs.py`` by name."""
    fn = getattr(graphs, name, None)
    if not callable(fn):
        raise KeyError(f"no generator {name!r} in portbench/graphs.py")
    return fn


def graph_params(config: dict, traffic: dict, sizes: Optional[dict] = None):
    """The generator and its keyword arguments: the configuration's
    parameters, under the traffic's ``graph`` overrides, under ``sizes``
    (the CPU tests' small sizes)."""
    params = dict(config["params"])
    params.update(traffic.get("graph", {}))
    params.update(sizes or {})
    name = params.pop("generator", config["generator"])
    return generator(name), params


def forbidden_modules(names=None) -> List[str]:
    """JAX or the JAX package among the loaded modules (or ``names``),
    compared by whole top-level names (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of ``k`` of the calls' answers, drawn from the
    seed (reservoir sampling: the count of calls is not known ahead)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: List[tuple] = []
        self.seen = 0

    def offer(self, index: int, answer) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((index, answer))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = (index, answer)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """The traced run's instruments around each call (on the card)."""

    def __init__(self):
        from repro_torch.kernels import _build

        self.clock = tracing.KernelClock()
        self.kernels = self.clock.install(dict(_build._LOADED))
        self.syncs = tracing.SyncCounter(ROOT / "src" / "repro_torch")
        self.marker = torch.zeros(1, dtype=torch.int32, device="cuda")
        self.starts: List = []
        self.ends: List = []
        # the device's activity alone: recording every aten op on the
        # host would slow the calls it times
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self.syncs.__enter__()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.syncs.__exit__(*exc)
        self.clock.uninstall()

    def begin_call(self) -> None:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self.marker.neg_()
        self.starts.append(start)
        self.clock.begin_call()
        self.syncs.begin_call()

    def end_call(self) -> None:
        self.syncs.end_call()
        self.clock.end_call()
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.ends.append(end)

    def finish(self, record: dict) -> dict:
        """Fill the record's traced parts; returns the breakdown."""
        launches = self.clock.resolve(self.starts)
        spans_ms = [s.elapsed_time(e) for s, e in zip(self.starts, self.ends)]
        marks = [[(site, t0.elapsed_time(ev)) for site, ev in call]
                 for t0, call in zip(self.starts, self.syncs.marks)]
        for call, ls, syncs in zip(record["calls"], launches,
                                   self.syncs.calls):
            call["launches"] = [(name, e - s) for name, s, e in ls]
            call["host_syncs"] = sum(syncs.values())
        device_ops = tracing.profiler_kernels(self.prof)
        markers = [s for name, s, _ in device_ops
                   if tracing.MARKER_KERNEL in name]
        spans = tracing.align_calls(markers, self.starts, spans_ms)
        if not any(spans):
            return {"device_ops": _top(device_ops)}
        # the profiler runs over the traced window alone: the union of
        # its device intervals is the card's busy time in that window
        record["device_busy_s"] = sum(
            e - s for s, e in tracing._merge(
                (s, e) for _, s, e in device_ops)) / 1e6
        busy = 0.0
        walls = []
        begins = [s for _, s, _ in device_ops]
        for span, call in zip(spans, record["calls"]):
            if span is None:
                continue
            c0, c1 = span
            lo, hi = bisect.bisect_left(begins, c0), bisect.bisect_left(begins,
                                                                        c1)
            inside = [(s, min(e, c1)) for _, s, e in device_ops[lo:hi]]
            busy += sum(e - s for s, e in tracing._merge(inside)) / 1e6
            walls.append(call["wall_s"])
        record["traced_matched_walls_s"] = walls
        record["traced_matched_busy_s"] = busy
        kept = [i for i, span in enumerate(spans) if span is not None]
        gaps = tracing.idle_gaps([spans[i] for i in kept],
                                 [launches[i] for i in kept],
                                 [marks[i] for i in kept], device_ops)
        return {"device_ops": _top(device_ops),
                "idle_gaps": [[name, s] for name, s in gaps.most_common(10)]}


def _short(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][:80] or name[:80]


def _top(device_ops) -> List[list]:
    totals: Dict[str, float] = {}
    for name, s, e in device_ops:
        key = _short(name)
        totals[key] = totals.get(key, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:10]]


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


class Window:
    """Calls of a drive, one after another, for a time: each call's wall
    from its start to ``synchronize()``; every answer offered to the
    sample; with a tracer, the instruments around each call and the
    call's facts read after it."""

    def __init__(self, drive, device, sample: Reservoir, tracer=None,
                 first: int = 0, collect: bool = False):
        self.drive, self.device, self.sample = drive, device, sample
        self.tracer = tracer
        self.first = first
        self.collect = collect
        self.walls: List[float] = []
        self.info: List[dict] = []
        self.failed = 0
        self.errors: List[str] = []
        self.seconds = 0.0

    @property
    def calls(self) -> int:
        return self.first + len(self.walls)

    @property
    def count(self) -> int:
        return len(self.walls)

    def run(self, seconds: float) -> None:
        drive, tracer = self.drive, self.tracer
        if tracer:
            tracer.__enter__()
        t0 = time.perf_counter()
        try:
            while True:
                start = time.perf_counter()
                if tracer:
                    tracer.begin_call()
                try:
                    result = drive.call()
                except (RuntimeError, ValueError, IndexError) as exc:
                    self.errors.append(f"{type(exc).__name__}: {exc}"[:500])
                    break
                finally:
                    if tracer:
                        tracer.end_call()
                _sync(self.device)
                end = time.perf_counter()
                self.walls.append(end - start)
                if not drive.ok(result):
                    self.failed += 1
                self.sample.offer(self.calls - 1, drive.answer(result))
                if self.collect:
                    self.info.append({**drive.info(result),
                                      "wall_s": end - start})
                del result
                if end - t0 >= seconds:
                    break
        finally:
            self.seconds = time.perf_counter() - t0
            if tracer:
                tracer.__exit__(None, None, None)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda",
             sizes: Optional[dict] = None,
             options: Optional[dict] = None, log=print):
    """One run of a cell after the check for a card; returns the result
    line's dict.  ``sizes`` and ``options`` (the CPU tests' small graphs
    and ``backend="torch"``) override the configuration's."""
    spec = load_spec()
    _, config, traffic = cell_parts(spec, name)
    device = torch.device(device)
    make, params = graph_params(config, traffic, sizes)
    solve_options = dict(config.get("solve_options", {}))
    solve_options.update(options or {})
    drive = drive_class(traffic["drive"])(make, params, traffic, device,
                                          seed, solve_options)
    for _ in range(int(traffic.get("warmup_calls", 1))):
        drive.answer(drive.call())
    _sync(device)
    log(f"workload {name} seed {seed} facts "
        f"{json.dumps(drive.facts(), sort_keys=True)}")

    sample = Reservoir(int(traffic.get("sample_calls", 2)), seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    # a traced run's first half runs as untraced, for the host clock's
    # per-layer metrics; its second half under the instruments
    plain = Window(drive, device, sample)
    plain.run(seconds / 2 if trace else seconds)
    traced = None
    tracer = None
    if trace and not plain.errors:
        tracer = Tracer() if device.type == "cuda" else None
        traced = Window(drive, device, sample, tracer, first=plain.calls,
                        collect=True)
        traced.run(seconds / 2)
    windows = [w for w in (plain, traced) if w is not None]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    walls = plain.walls
    errors = [e for w in windows for e in w.errors]
    # a call that raised gave no answer: it failed
    failed = sum(w.failed for w in windows) + len(errors)
    record = {"walls_s": walls, "window_s": plain.seconds,
              "setup_s": setup_s, "peak_bytes": peak, "facts": drive.facts(),
              "calls": traced.info if traced else [],
              "traced_window_s": traced.seconds if traced else 0.0}
    breakdown = tracer.finish(record) if tracer else None
    log(f"calls {len(walls)} window_s {plain.seconds!r} setup_s "
        f"{setup_s!r} samples_beyond_p95 "
        f"{len(walls) - math.ceil(0.95 * len(walls))}")
    if traced:
        its = sorted({c.get('iterations') for c in traced.info})
        log(f"traced calls {traced.count} window_s {traced.seconds!r} "
            f"iterations {its}")
    if tracer:
        log(f"traced kernels {tracer.kernels}")
    log(f"provenance {drive.provenance()}")

    # the program's state goes before the reference runs on the card
    drive.release()
    tracer = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked = [index for index, _ in sample.items]
    counts = [drive.mismatches(answer) for _, answer in sample.items]
    sample.items.clear()
    wrong = sum(counts)
    failed += sum(1 for c in counts if c)
    checks = {
        "mismatched_labels": {"value": wrong, "limit": 0},
        "failed_calls": {"value": failed, "limit": 0},
    }
    correct = wrong == 0 and failed == 0 and bool(checked)
    log(f"checked calls {checked} (of {sample.seen})")
    for line in errors:
        log(f"error {line}")

    metrics = {}
    for m in metrics_for(spec, name, trace):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    if trace and "device_busy_s" in record:
        dev["busy_s"] = record["device_busy_s"]
        dev["window_s"] = record["traced_window_s"]
    attempted = sum(w.count for w in windows) + len(errors)
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result line as the last line on standard output."""
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
