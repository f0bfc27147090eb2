#!/usr/bin/env python3
"""Time the fleets' walls through ``solve_batch`` (dense C-2, C-11mm and
C-Syn) and the fleet's no-change test of one or more checkouts on one
CUDA GPU, in turns.

Each checkout named by ``--root`` runs in a process of its own (its own
``repro_torch`` and ``chip_smoke``, its kernels built from its own
sources), in the order given, so that two versions are compared on one
card in one call: parent, change, change, parent, repeated as often as
the spread asks.  On ``chip_smoke.py``'s rmat fleet (1024 x rmat(12,16)),
delaunay fleet (256 x delaunay_like(14)) and ragged fleet (512 graphs of
2^8 to 2^14 vertices) each process takes, for each variant, the cold
wall (the first solve), the warm wall (host clock to ``synchronize()``,
mean of ``chip_smoke.REPS`` solves), the card's busy time of one solve
(``torch.profiler``: the union of its device events) and, from another
profiled solve, each kernel's device time summed over its launches, the
iterations and,
where the checkout has them, the launches of each route.  On each fleet
it also times the no-change test (``converged.labels_unchanged_batched``,
CUDA events, mean of ``chip_smoke.REPS`` calls, fresh state words before
each, with this file's own timer so that every checkout is timed alike)
live (one C-Syn iteration from identity against identity) and at
the fixed point (against a copy), its plain version, the solo
``labels_unchanged`` over the same flat labels in both states, and the
wrapper's host time a call (host clock, no synchronize, least and mean
of ``HOST_ROUNDS`` rounds of ``HOST_CALLS`` calls).  The fleets are
made anew at each invocation, by its first process, and kept under
``build/fleet_walls/`` for its later ones.  Run from the root of a
checkout::

    python3 tools/fleet_walls.py --root build/parent --root . --root . \\
        --root build/parent

It prints the card's name and power limit, one JSON line a process and
a last line with each checkout's least, mean and greatest warm wall and
busy time over its processes, and writes them to
``chiprun_out/fleet_walls.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "fleet_walls.jsonl"
CACHE = ROOT / "build" / "fleet_walls"
KINDS = ("rmat", "delaunay", "ragged")
VARIANTS = ("C-2", "C-11mm", "C-Syn")
HOST_ROUNDS, HOST_CALLS = 5, 100


def one(root: Path) -> dict:
    """The walls of the checkout at ``root``, in this process."""
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs

    with cs.ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda m: m.load_library(),
                      (cs.blocked, cs.cv, cs.fleet)))
    CACHE.mkdir(parents=True, exist_ok=True)
    row = {"root": str(root), "fleets": {}}
    for kind in KINDS:
        path = CACHE / f"{kind}.pt"
        if not path.exists():
            host, sizes = cs.stack_graphs(cs.fleet_graphs(kind),
                                          with_sizes=True)
            torch.save({"src": host.src, "dst": host.dst,
                        "n": host.n_vertices, "sizes": sizes}, path)
        saved = torch.load(path)
        batched = cs.Graph(src=saved["src"].to(cs.DEVICE),
                           dst=saved["dst"].to(cs.DEVICE),
                           n_vertices=saved["n"])
        out = {}
        for variant in VARIANTS:
            def run():
                return cs.solve_batch(batched, batch_sizes=saved["sizes"],
                                      variant=variant)

            cs.sync()
            cs.reset_launch_counts()
            t0 = time.perf_counter()
            res = run()
            cs.sync()
            cold_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in cs.launch_counts().items() if v}
            routes = {k: v for k, v in cs.route_counts().items()
                      if launches.get(k)}
            out[variant] = {"cold_ms": cold_ms, "warm_ms": cs.host_ms(run),
                            "busy_ms": cs.device_idle(run).get("busy_ms"),
                            "kernels_ms": kernels_ms(run),
                            "iterations_max": int(res.iterations.max()),
                            "launches": launches, "routes": routes}
        out["tests"] = tests_ms(cs, batched)
        row["fleets"][cs.fleet_name(kind)] = out
        del batched
    return row


def tests_ms(cs, batched) -> dict:
    """The fleet's no-change test, its plain version and the solo test
    over the same labels, live and at the fixed point (module
    docstring)."""
    cv, blocked = cs.cv, cs.blocked
    lanes_b = int(batched.src.shape[0])
    n = batched.n_vertices
    off = blocked.lane_offsets(lanes_b, n, cs.DEVICE)
    L0 = (cs.torch.arange(n, dtype=cs.torch.int32, device=cs.DEVICE)
          .expand(lanes_b, n) + off).reshape(-1).contiguous()
    # C-Syn's first iteration: one order-2 sweep, no jump
    L1 = blocked.fused_relax_batched_plain(L0, batched.src, batched.dst, n)
    Lf = (cs.solve_batch(batched).labels + off).reshape(-1).contiguous()
    Lf_copy = Lf.clone()
    state = cv.fleet_state(lanes_b, cs.DEVICE)
    solo = cv.loop_state(cs.DEVICE)

    def fresh():
        state.lanes.zero_()
        state.fleet.zero_()

    out = {"B": lanes_b, "n": n, "labels": lanes_b * n}
    for key, (a, b) in (("live", (L1, L0)), ("fixed", (Lf, Lf_copy))):
        out[key] = {
            "ms": time_each_ms(cs, lambda: cv.labels_unchanged_batched(
                a, b, n, state), setup=fresh),
            "plain_ms": time_each_ms(
                cs, lambda: cv.labels_unchanged_batched_plain(a, b, n, state),
                setup=fresh),
            "solo_ms": time_each_ms(cs, lambda: cv.labels_unchanged(
                a, b, state=solo), setup=solo.zero_)}
    per_call = []
    for _ in range(HOST_ROUNDS):
        cs.sync()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            cv.labels_unchanged_batched(Lf, Lf_copy, n, state)
        per_call.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        cs.sync()
    out["host_us_a_call"] = {"min": min(per_call),
                             "mean": sum(per_call) / len(per_call)}
    return out


def time_each_ms(cs, fn, setup) -> float:
    """Mean device time of ``fn()`` over ``chip_smoke.REPS`` calls, each
    between its own CUDA events with ``setup()`` before it, the card held
    busy once for all the calls and before each (this checkout's
    ``chip_smoke.time_each_ms``, kept here so that every checkout is
    timed alike)."""
    import torch

    for _ in range(2):
        setup()
        fn()
    cs.sync()
    pairs = []
    torch.cuda._sleep(cs.HOLD_CYCLES * cs.REPS)
    for _ in range(cs.REPS):
        torch.cuda._sleep(cs.HOLD_CYCLES)
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    cs.sync()
    return sum(s.elapsed_time(e) for s, e in pairs) / cs.REPS


def kernels_ms(fn) -> dict:
    """One profiled call of ``fn``: each device kernel's time, summed over
    its launches, by name (the name cut at its template or argument
    list)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            name = e.name().replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + e.duration_ns() / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def spread(rows: list) -> dict:
    """Each checkout's least, mean and greatest warm wall and busy time,
    by fleet and variant, and the no-change test's times, over its
    processes."""
    seen: dict = {}
    for row in rows:
        for fleet_name, out in row["fleets"].items():
            for variant, one_row in out.items():
                if variant == "tests":
                    one_row = {f"{state}_{key}": one_row[state][key]
                               for state in ("live", "fixed")
                               for key in ("ms", "solo_ms")}
                    one_row["host_us"] = out["tests"]["host_us_a_call"][
                        "min"]
                for key, x in one_row.items():
                    if key in ("warm_ms", "busy_ms") or variant == "tests":
                        seen.setdefault(row["root"], {}).setdefault(
                            fleet_name, {}).setdefault(
                            variant, {}).setdefault(key, []).append(x)
    for by_fleet in seen.values():
        for by_variant in by_fleet.values():
            for keys in by_variant.values():
                for key, xs in keys.items():
                    xs = [x for x in xs if x is not None]
                    keys[key] = {"n": len(xs), "min": min(xs, default=None),
                                 "mean": sum(xs) / len(xs) if xs else None,
                                 "max": max(xs, default=None)}
    return seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(Path(args.one).resolve())), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("fleet_walls: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    rows = [{"device": cs.device_line(), "torch": torch.__version__,
             "cuda": torch.version.cuda}]
    shutil.rmtree(CACHE, ignore_errors=True)
    for root in args.root or ["."]:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    rows.append({"spread": spread(rows[1:])})
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with OUT.open("w") as f:
        for row in rows:
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
