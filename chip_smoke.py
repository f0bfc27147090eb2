#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
with ``nvcc`` (sm_90a), holds each kernel against its plain PyTorch
version at the main path's shapes, then drives ``repro_torch.solve`` — the
port's main path, Contour C-2 on the CUDA kernels — on two graphs of the
paper's sizes and checks the labels against the ``torch`` backend and
against scipy's connected components.  Every phase prints one JSON line;
any failed check raises and the script exits non-zero.  The lines before
the last are the card's name and power limit (as ``nvidia-smi`` prints
them) and one ``{"kernels": [...]}`` object; the last line is
``{"ok": true, "device": {...}}``.

Run from the root of a checkout, on a machine with one CUDA GPU::

    python3 chip_smoke.py

It needs numpy, scipy, torch built for CUDA and ``nvcc``; it imports
nothing of JAX.  Without a CUDA device it exits with code 1 and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import solve  # noqa: E402
from repro_torch.connectivity import minmap  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.contour_mm import blocked, ops  # noqa: E402

DEVICE = "cuda"
# rmat(22, 16) is the size of the paper's soc-LiveJournal1
RMAT_EDGE_FACTOR = 16
# calls per CUDA-event or host-clock timing
REPS = 20
# H100 SXM published peaks (NVIDIA data sheet) behind each bound_ms: HBM
# bandwidth, and the float32 rate outside the tensor cores, the table's
# closest entry for the kernels' int32 min/compare work
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

REPLACES = {
    "fused_relax": "src/repro/kernels/contour_mm/blocked.py:236 "
                   "(fused_relax_pallas)",
    "scatter_min": "src/repro/kernels/contour_mm/blocked.py:92 "
                   "(binned_scatter_min_pallas)",
}
SOURCE = "src/repro_torch/kernels/contour_mm/csrc/contour_mm.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Mean device time of ``fn()`` over ``REPS`` calls (CUDA events)."""
    for _ in range(2):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / REPS


def host_ms(fn) -> float:
    """Mean host-clock time of ``fn()`` to ``synchronize()``, ``REPS``
    calls."""
    for _ in range(2):
        fn()
    sync()
    total = 0.0
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        sync()
        total += time.perf_counter() - t0
    return total / REPS * 1e3


def raises_index_error(fn) -> bool:
    try:
        fn()
    except IndexError:
        return True
    return False


def bound(bytes_moved: int, ops: int) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "ops": ops}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def c2_states(g, count: int):
    """Identity labels and the first ``count`` C-2 iterations' labels."""
    L = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
    states = [L]
    for _ in range(count):
        L = minmap.pointer_jump(minmap.mm_relax(L, g.src, g.dst, 2))
        states.append(L)
    return states


def scipy_labels(g) -> np.ndarray:
    """Min-vertex-id component labels from scipy's connected_components."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    s, d, n = g.to_numpy()
    adj = coo_matrix((np.ones(len(s), np.int8), (s, d)), shape=(n, n))
    _, lab = connected_components(adj.tocsr(), directed=False)
    _, first = np.unique(lab, return_index=True)  # min id per component
    return first[lab].astype(np.int32)


def phase_kernels(g, star) -> dict:
    """Phase 3: each kernel against its plain version, then its times."""
    states = c2_states(g, 3)
    m = g.n_edges
    err = {"fused_relax": 0, "scatter_min": 0}
    checks = 0
    gen_ = torch.Generator(device=g.device).manual_seed(0)
    for L in states:
        for limit in (None, m // 2):
            a = blocked.fused_relax(L, g.src, g.dst, edge_limit=limit)
            b = blocked.fused_relax_plain(L, g.src, g.dst, limit)
            sync()
            err["fused_relax"] = max(err["fused_relax"], max_abs_err(a, b))
            checks += 1
        for order in (1, 2, 3):
            t, v = minmap.mm_update_stream(L, g.src, g.dst, order)
            valid = torch.rand(t.shape, device=g.device, generator=gen_) < 0.5
            for vd in (None, valid):
                a = blocked.scatter_min(L, t, v, vd)
                b = blocked.scatter_min_plain(L, t, v, vd)
                sync()
                err["scatter_min"] = max(err["scatter_min"],
                                         max_abs_err(a, b))
                checks += 1
            del t, v, valid
    # hub contention: every spoke's update lands on one vertex
    sL = torch.arange(star.n_vertices, dtype=torch.int32, device=g.device)
    st, sv = minmap.mm_update_stream(sL, star.src, star.dst, 2)
    for name, a, b in (
            ("scatter_min", blocked.scatter_min(sL, st, sv),
             blocked.scatter_min_plain(sL, st, sv)),
            ("fused_relax", blocked.fused_relax(sL, star.src, star.dst),
             blocked.fused_relax_plain(sL, star.src, star.dst))):
        sync()
        err[name] = max(err[name], max_abs_err(a, b))
        checks += 1
    if any(err.values()):
        raise AssertionError(f"kernel differs from its plain version: {err}")
    # one endpoint outside [0, n): each kernel raises IndexError
    bad = g.src.clone()
    bad[m // 2] = g.n_vertices
    for call in (lambda: blocked.fused_relax(states[0], bad, g.dst),
                 lambda: blocked.scatter_min(states[0], bad, g.dst)):
        if not raises_index_error(call):
            raise AssertionError("a kernel took an id outside [0, n)")
        checks += 1
    del bad

    # times at the main path's shapes: the first sweep (identity labels),
    # where the most atomics land; order 2 for fused_relax (every C-2
    # sweep), order 1 for scatter_min (C-11mm's warm-up sweeps); called as
    # the main path calls them, without waiting for the range flag
    L0 = states[0]
    n = g.n_vertices
    t1, v1 = minmap.mm_update_stream(L0, g.src, g.dst, 1)
    t1_long = t1.long()
    k = int(t1.shape[0])
    fused = {
        "name": "fused_relax", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["fused_relax"],
        "max_abs_err": err["fused_relax"],
        "ms": time_ms(
            lambda: blocked.fused_relax(L0, g.src, g.dst, check=False)),
        "plain_ms": time_ms(
            lambda: blocked.fused_relax_plain(L0, g.src, g.dst)),
        "library_ms": None,
        "shape": {"n": n, "m": m},
        # read L, src, dst once, write L_out once; per edge one min for z
        # and four compares against the gathered labels
        **bound(4 * n + 8 * m + 4 * n, 5 * m),
    }
    scatter = {
        "name": "scatter_min", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["scatter_min"],
        "max_abs_err": err["scatter_min"],
        "ms": time_ms(
            lambda: blocked.scatter_min(L0, t1, v1, check=False)),
        "plain_ms": time_ms(lambda: blocked.scatter_min_plain(L0, t1, v1)),
        "library_ms": time_ms(
            lambda: L0.scatter_reduce(0, t1_long, v1, "amin")),
        "shape": {"n": n, "updates": k, "order": 1},
        # read L, targets, values once, write L_out once; one compare per
        # update
        **bound(4 * n + 8 * k + 4 * n, k),
    }
    sk = int(st.shape[0])
    hub = {
        "graph": f"star({star.n_vertices})", "updates": sk,
        "scatter_min_ms": time_ms(
            lambda: blocked.scatter_min(sL, st, sv, check=False)),
        "scatter_reduce_ms": time_ms(
            lambda: sL.scatter_reduce(0, st.long(), sv, "amin")),
        "fused_relax_ms": time_ms(
            lambda: blocked.fused_relax(sL, star.src, star.dst, check=False)),
        **bound(8 * star.n_vertices + 8 * sk, sk),
    }
    emit({"phase": "kernels_vs_plain", "checks": checks,
          "states": len(states), "fused_relax": fused,
          "scatter_min": scatter, "hub_contention": hub})
    return {"fused_relax": fused, "scatter_min": scatter}


def iteration_parts(g, L) -> dict:
    """Device ms of each step of one C-2 iteration at labels ``L``."""
    return {
        "fused_relax_ms": time_ms(
            lambda: blocked.fused_relax(L, g.src, g.dst, check=False)),
        "pointer_jump_ms": time_ms(lambda: minmap.pointer_jump(L)),
        "converged_early_ms": time_ms(
            lambda: minmap.converged_early(L, g.src, g.dst)),
    }


def loop_cost(g, res) -> dict:
    """A warm C-2 solve against the same device work with no host read.

    The replay enqueues the solve's iterations (the sweep, one
    pointer-jump round, and ``converged_early``, whose flag is computed
    but never read) and the final jump, back to back.  The difference in
    host-clock time is what the loop's per-iteration flag reads and the
    facade's host work add.  The replay's device time bounds the solve's
    busy time from above, so ``1 - replay_device_ms / solve_ms`` bounds
    the device's idle share inside the solve from below.
    """
    iters = int(res.iterations)

    def replay():
        L = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
        for _ in range(iters):
            L = ops.mm_relax_backend(L, g.src, g.dst, order=2,
                                     backend="cuda")
            L = minmap.pointer_jump(L, rounds=1)
            minmap.converged_early(L, g.src, g.dst)
        return minmap.pointer_jump(L, rounds=1)

    if not torch.equal(replay(), res.labels):
        raise AssertionError("the replay does not repeat the solve")
    solve_ms = host_ms(lambda: solve(g))
    replay_ms = host_ms(replay)
    replay_device_ms = time_ms(replay)
    return {"iterations": iters, "solve_ms": solve_ms,
            "replay_ms": replay_ms, "replay_device_ms": replay_device_ms,
            "host_reads_ms": solve_ms - replay_ms,
            "host_reads_ms_per_iteration": (solve_ms - replay_ms) / iters,
            "idle_share_at_least": 1 - replay_device_ms / solve_ms}


def drive(g, name: str, variant: str, reference: np.ndarray) -> dict:
    """One main-path solve with the launch counts read around it."""
    torch.cuda.reset_peak_memory_stats()
    sync()
    blocked.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, variant=variant)
    sync()
    wall = time.perf_counter() - t0
    launches = {"fused_relax": blocked.fused_relax.launches,
                "scatter_min": blocked.scatter_min.launches}
    peak = torch.cuda.max_memory_allocated()
    plain = solve(g, variant=variant, backend="torch")
    sync()
    for field in ("labels", "iterations", "converged", "edges_visited"):
        if not torch.equal(getattr(res, field), getattr(plain, field)):
            raise AssertionError(f"{name} {variant}: {field} differs from "
                                 "the torch backend")
    if not bool(res.converged):
        raise AssertionError(f"{name} {variant}: not converged")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"{name} {variant}: labels differ from scipy")
    # the same solve again, with the allocator's blocks already cached
    t0 = time.perf_counter()
    solve(g, variant=variant)
    sync()
    wall_warm = time.perf_counter() - t0
    out = {"phase": "main_path", "graph": name, "variant": variant,
           "n": g.n_vertices, "m": g.n_edges, "wall_s": wall,
           "wall_warm_s": wall_warm,
           "iterations": int(res.iterations),
           "edges_visited": float(res.edges_visited),
           "edges_per_s": float(res.edges_visited) / wall,
           "peak_bytes": peak, "launches": launches,
           "provenance": list(res.provenance or ()),
           "n_components": res.n_components}
    if variant == "C-2":
        L0 = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
        out["parts_first_iteration"] = iteration_parts(g, L0)
        out["parts_at_fixed_point"] = iteration_parts(g, res.labels)
        out["loop_cost"] = loop_cost(g, res)
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rmat-scale", type=int, default=22)
    ap.add_argument("--delaunay-scale", type=int, default=24)
    ap.add_argument("--star-scale", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()

    # 1. device
    t0 = time.perf_counter()
    card = device_line()
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "seconds": time.perf_counter() - t0})

    # 2. build every kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    blocked.load_library()
    log = _build.BUILD_LOGS.get(blocked.LIBRARY, "")
    emit({"phase": "build", "library": blocked.LIBRARY,
          "sources": [str(p.relative_to(ROOT)) for p in blocked.SOURCES],
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln],
          "seconds": time.perf_counter() - t0})

    # graphs: the sizes of the paper's soc-LiveJournal1 and delaunay_n24
    t0 = time.perf_counter()
    rmat = gen.rmat(args.rmat_scale, edge_factor=RMAT_EDGE_FACTOR,
                    device=DEVICE)
    t_rmat = time.perf_counter() - t0
    delaunay = gen.delaunay_like(args.delaunay_scale, device=DEVICE)
    star = gen.star(1 << args.star_scale, device=DEVICE)
    rmat_name = f"rmat({args.rmat_scale},{RMAT_EDGE_FACTOR})"
    delaunay_name = f"delaunay_like({args.delaunay_scale})"
    emit({"phase": "graphs", "seconds": time.perf_counter() - t0,
          "rmat_seconds": t_rmat,
          rmat_name: [rmat.n_vertices, rmat.n_edges],
          delaunay_name: [delaunay.n_vertices, delaunay.n_edges]})

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    kernels = phase_kernels(rmat, star)
    del star
    emit({"phase": "kernels_vs_plain_done",
          "seconds": time.perf_counter() - t0})

    # 4. the main path at real size; 5. the second kernel on the main
    # entry point (C-11mm's order-1 warm-up sweeps)
    t0 = time.perf_counter()
    ref_rmat = scipy_labels(rmat)
    ref_delaunay = scipy_labels(delaunay)
    emit({"phase": "scipy_reference", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    runs = [drive(delaunay, delaunay_name, "C-2", ref_delaunay),
            drive(rmat, rmat_name, "C-2", ref_rmat)]
    if not all(r["launches"]["fused_relax"] > 0 for r in runs):
        raise AssertionError("the main path did not launch fused_relax")
    c11 = drive(rmat, rmat_name, "C-11mm", ref_rmat)
    if c11["launches"]["scatter_min"] <= 0:
        raise AssertionError("C-11mm did not launch scatter_min")
    runs.append(c11)
    emit({"phase": "main_path_done", "seconds": time.perf_counter() - t0})

    # 6. the kernels line: launches summed over the main-path runs
    line = []
    for name in ("fused_relax", "scatter_min"):
        k = dict(kernels[name])
        k["launches"] = sum(r["launches"][name] for r in runs)
        k["max_abs_diff"] = k["max_abs_err"]
        k["kernel_ms"] = k["ms"]
        line.append(k)
    print(card, flush=True)
    emit({"kernels": line, "seconds_total": time.perf_counter() - t_all})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
