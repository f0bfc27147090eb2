#!/usr/bin/env python3
"""Where a distributed solve's host time goes, on a 1-rank NCCL mesh on
one CUDA GPU.

Times, with the host clock, each call a round of the dense distributed
loop (``connectivity.distributed``) makes: the labels' and the flag's
``all_reduce``, K6 ``converged_early`` and the flag's conversion, the
plain loop step, K1 ``fused_relax`` and K7 ``pointer_jump`` with the
loop's ``done`` word; then whole warm solves: dense C-2 (``solve(g)``),
``solve(g, mesh=mesh)`` and ``distributed_contour`` alone.  Each figure
is the mean host time of a call enqueued back to back (``enqueue_us``)
and to the card's ``synchronize()`` (``to_sync_us``).  A call whose two
figures agree is bound by the host.  Run from the root of a checkout::

    python3 tools/mesh_host_costs.py [--scale 18] [--reps 200]

It prints the card's name and power limit and one JSON line per call,
and writes them to ``chiprun_out/mesh_host_costs.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import solve  # noqa: E402
from repro_torch.connectivity import distributed  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels.contour_mm import blocked  # noqa: E402
from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402
from repro_torch.runtime import Mesh  # noqa: E402

OUT = ROOT / "chiprun_out" / "mesh_host_costs.jsonl"


def host_us(fn, reps: int) -> dict:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"enqueue_us": (t1 - t0) / reps * 1e6,
            "to_sync_us": (t2 - t0) / reps * 1e6, "reps": reps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_host_costs: no CUDA device", file=sys.stderr)
        return 1
    card = cs.device_line()
    print(card, flush=True)
    cs.build_all()
    OUT.parent.mkdir(exist_ok=True)
    rows = []
    with tempfile.TemporaryDirectory(prefix="mesh_host_") as directory:
        dist.init_process_group("nccl", init_method=f"file://{directory}/s",
                                rank=0, world_size=1)
        try:
            mesh = Mesh(np.array([0]), ("data",))
            g = gen.rmat(args.scale, edge_factor=cs.RMAT_EDGE_FACTOR,
                         device=mesh.device)
            L = torch.arange(g.n_vertices, dtype=torch.int32,
                             device=mesh.device)
            state = cv.loop_state(mesh.device)
            done = cv.done_word(state)
            flag = torch.ones(1, dtype=torch.int32, device=mesh.device)
            reps, solves = args.reps, max(args.reps // 10, 5)
            calls = {
                "all_reduce_labels": (lambda: dist.all_reduce(
                    L, op=dist.ReduceOp.MIN), reps),
                "all_reduce_flag": (lambda: dist.all_reduce(
                    flag, op=dist.ReduceOp.MIN), reps),
                "converged_early": (lambda: cv.converged_early(
                    L, g.src, g.dst), reps),
                "converged_early_to_flag": (lambda: cv.converged_early(
                    L, g.src, g.dst).to(torch.int32).reshape(1), reps),
                "loop_step_plain": (lambda: cv.loop_step_plain(
                    state, flag[0]), reps),
                "fused_relax_done": (lambda: blocked.fused_relax(
                    L, g.src, g.dst, check=False, done=done), reps),
                "pointer_jump_done": (lambda: cv.pointer_jump(L, done),
                                      reps),
                "solve_dense_c2": (lambda: solve(g), solves),
                "solve_mesh": (lambda: solve(g, mesh=mesh), solves),
                "distributed_contour": (
                    lambda: distributed.distributed_contour(
                        g, mesh, backend="cuda"), solves),
            }
            for name, (fn, count) in calls.items():
                rows.append({"call": name, "graph": f"rmat({args.scale},"
                             f"{cs.RMAT_EDGE_FACTOR})", "card": card,
                             **host_us(fn, count)})
                print(json.dumps(rows[-1]), flush=True)
            res = solve(g, mesh=mesh)
            rows.append({"call": "solve_mesh_iterations",
                         "iterations": int(res.iterations),
                         "dense_c2_iterations": int(solve(g).iterations)})
            print(json.dumps(rows[-1]), flush=True)
        finally:
            dist.destroy_process_group()
    with open(OUT, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
