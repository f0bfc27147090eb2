#!/usr/bin/env python3
"""Time design variants of the sweep kernels K1 ``fused_relax`` and K2
``scatter_min`` side by side on one CUDA GPU.

The variants are instances of the templates in ``tools/sweep_variants.cu``
(what happens to an item's updates: the test of the output label, the
warp vote, a warp combine of all slots or only hot ones, before or after
the test; lanes on items 32 apart or on 4 consecutive items by one
16-byte load; items a lane; registers) with three grid sizes.  Beside
them it times the port's shipped kernels (``repro_torch.kernels.
contour_mm.blocked``) and, with ``--parent``, the kernels of an earlier
``contour_mm.cu`` with the one-edge-a-thread C interface (``git show
<commit>:src/repro_torch/kernels/contour_mm/csrc/contour_mm.cu``).

Graphs are made on the card: rmat(22, 16) with Graph500's parameters
(torch's generator, so not the numpy generator's edges), delaunay_like(24)
(the same grid as ``repro_torch.graphs.generators``) and star(1 << 20);
labels in the C-2 states 0-3 and at the fixed point.  Every variant's
labels must equal ``mm_relax`` / ``scatter_reduce``; times are CUDA-event
means of 20 calls (each a copy of L into the output and one launch),
taken in two passes in opposite orders and averaged.  Run from the root
of a checkout::

    python3 tools/sweep_variants.py [--parent OLD.cu] [--out FILE]

It writes every row to ``--out`` (default
``chiprun_out/sweep_variants.json``) and prints one line per state.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.connectivity import minmap  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.contour_mm import blocked  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
BUILD = ROOT / "build" / "sweep_variants"
P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

# flags of sweep_variants.cu
TEST, VOTE, COMBINE_ALL, COMBINE_FIRST, EARLY_GATE = 1, 2, 4, 32, 1024
# name: (flags, layout (1: 16-byte loads), items a lane, min blocks an SM
# (1: registers left to the compiler), grid: blocks an SM, 0 for one wave
# of resident blocks, -1 for one step a warp with no grid stride).  The
# shipped kernels are early_gate_ept2 (fused_relax) and early_gate_minb8
# (scatter_min).
VARIANTS = {
    "test_vote": (TEST | VOTE, 0, 4, 8, 0),
    "test_vote_no_stride": (TEST | VOTE, 0, 4, 8, -1),
    "test_vote_ept2_no_stride": (TEST | VOTE, 0, 2, 8, -1),
    "vote_no_test": (VOTE, 0, 4, 8, -1),
    "all_after_test": (TEST | VOTE | COMBINE_ALL, 0, 4, 8, -1),
    "all_before_test": (TEST | VOTE | COMBINE_ALL | COMBINE_FIRST,
                        0, 4, 8, -1),
    "test_vote_16B": (TEST | VOTE, 1, 4, 8, -1),
    "all_before_test_16B": (TEST | VOTE | COMBINE_ALL | COMBINE_FIRST,
                            1, 4, 8, -1),
    "early_gate": (TEST | VOTE | EARLY_GATE, 0, 4, 1, -1),
    "early_gate_ept2": (TEST | VOTE | EARLY_GATE, 0, 2, 8, -1),
    "early_gate_minb8": (TEST | VOTE | EARLY_GATE, 0, 4, 8, -1),
}
REPS = 20


def build(source: Path, name: str):
    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(source)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stderr


def canonical(s, d, n):
    lo, hi = torch.minimum(s, d), torch.maximum(s, d)
    keep = lo != hi
    key = torch.unique(lo[keep] * n + hi[keep])
    return (key // n).int(), (key % n).int(), n


def rmat(scale, edge_factor, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, m = 1 << scale, (1 << scale) * edge_factor
    a, b, c = 0.57, 0.19, 0.19
    a_norm, c_norm = a / (a + b), c / (1 - a - b)
    s = torch.zeros(m, dtype=torch.int64, device=dev)
    d = torch.zeros_like(s)
    for bit in range(scale):
        rows = torch.rand(m, device=dev, generator=gen) > a + b
        p_col = torch.where(rows, c_norm, a_norm)
        cols = torch.rand(m, device=dev, generator=gen) > p_col
        s |= rows.long() << bit
        d |= cols.long() << bit
    perm = torch.randperm(n, device=dev, generator=gen)
    return canonical(perm[s], perm[d], n)


def delaunay_like(scale, dev):
    n = 1 << scale
    rows = 1 << (scale // 2)
    idx = torch.arange(n, device=dev).reshape(rows, n // rows)
    s = torch.cat([idx[:, :-1].ravel(), idx[:-1, :].ravel(),
                   idx[:-1, :-1].ravel()])
    d = torch.cat([idx[:, 1:].ravel(), idx[1:, :].ravel(),
                   idx[1:, 1:].ravel()])
    return canonical(s, d, n)


def star(n, dev, seed=0):
    hub = int(torch.randint(n, (1,), generator=torch.Generator().manual_seed(
        seed)))
    v = torch.arange(n, device=dev)
    v = v[v != hub]
    return canonical(torch.full_like(v, hub), v, n)


def c2_states(src, dst, n, dev):
    """Identity labels, C-2 states 1-3 and the fixed point."""
    L = torch.arange(n, dtype=torch.int32, device=dev)
    out = [("0", L)]
    for i in range(1, 200):
        nxt = minmap.pointer_jump(minmap.mm_relax(L, src, dst, 2))
        if torch.equal(nxt, L):
            out.append((f"fixed ({i - 1} iterations)", L))
            return out
        L = nxt
        if i <= 3:
            out.append((str(i), L))
    raise AssertionError("no fixed point in 200 iterations")


def time_ms(fn) -> float:
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "sweep_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.time()
    jobs = [(SOURCE, "sweep_variants")]
    if args.parent is not None:
        jobs.append((args.parent.resolve(), "sweep_parent"))
    with ThreadPoolExecutor(len(jobs) + 1) as ex:
        shipped = ex.submit(blocked.load_library)
        built = list(ex.map(lambda j: build(*j), jobs))
        shipped.result()
    var, log = built[0]
    var.variant_fused_relax.argtypes = [I32] * 5 + [P] * 4 + [I64] * 2 + \
        [P] * 3
    var.variant_scatter_min.argtypes = [I32] * 5 + [P] * 4 + [I64] * 2 + \
        [P] * 3
    parent = built[1][0] if len(built) > 1 else None
    if parent is not None:
        parent.contour_fused_relax.argtypes = [P, P, P, P, I64, I64, P, P]
        parent.contour_scatter_min.argtypes = [P, P, P, P, P, I64, I64, P,
                                               P]
    print(json.dumps({"built_s": time.time() - t0, "ptxas": [
        line for line in log.splitlines() if "registers" in line
        or "Compiling entry" in line]}), flush=True)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k1(name, L, out, src, dst, counter=None):
        if name == "shipped":
            return blocked.fused_relax_sweep(L, src, dst, check=False)
        n, m = L.shape[0], src.shape[0]
        out.copy_(L)
        if name == "parent":
            rc = parent.contour_fused_relax(L.data_ptr(), out.data_ptr(),
                                            src.data_ptr(), dst.data_ptr(), m,
                                            n, None, stream())
        else:
            rc = var.variant_fused_relax(
                *VARIANTS[name][:5], L.data_ptr(), out.data_ptr(),
                src.data_ptr(), dst.data_ptr(), m, n, None,
                None if counter is None else counter.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"{name}: launch returned {rc}")
        return out

    def k2(name, L, out, t, v, counter=None):
        if name == "shipped":
            return blocked.scatter_min_sweep(L, t, v, check=False)
        n, k = L.shape[0], t.shape[0]
        out.copy_(L)
        if name == "parent":
            rc = parent.contour_scatter_min(L.data_ptr(), out.data_ptr(),
                                            t.data_ptr(), v.data_ptr(), None,
                                            k, n, None, stream())
        else:
            rc = var.variant_scatter_min(
                *VARIANTS[name][:5], L.data_ptr(), out.data_ptr(),
                t.data_ptr(), v.data_ptr(), k, n, None,
                None if counter is None else counter.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"{name}: launch returned {rc}")
        return out

    names = (["parent"] if parent is not None else []) + ["shipped"] + \
        list(VARIANTS)
    rows = []
    graphs = (("star(1<<20)", lambda: star(1 << 20, dev), 2),
              ("rmat(22,16)", lambda: rmat(22, 16, dev), 1),
              ("delaunay_like(24)", lambda: delaunay_like(24, dev), 1))
    for gname, make, order in graphs:
        src, dst, n = make()
        states = c2_states(src, dst, n, dev)
        if gname.startswith("star"):
            states = states[:1]
        for sname, L in states:
            t, v = minmap.mm_update_stream(L, src, dst, order)
            want1 = minmap.mm_relax(L, src, dst, 2)
            want2 = L.scatter_reduce(0, t.long(), v, "amin",
                                     include_self=True)
            out = torch.empty_like(L)
            row = {"graph": gname, "state": sname, "n": n,
                   "m": int(src.shape[0]), "updates": int(t.shape[0]),
                   "order": order, "copy_ms": time_ms(lambda: out.copy_(L)),
                   "variants": {}}
            for name in names:
                c1 = torch.zeros(4, dtype=torch.int64, device=dev)
                c2 = torch.zeros(4, dtype=torch.int64, device=dev)
                if not torch.equal(k1(name, L, out, src, dst, c1), want1):
                    raise AssertionError(f"{name} K1 differs on {gname}")
                if not torch.equal(k2(name, L, out, t, v, c2), want2):
                    raise AssertionError(f"{name} K2 differs on {gname}")
                row["variants"][name] = {
                    "k1_ms": [], "k2_ms": [],
                    "k1_counts_per_edge": [x / src.shape[0]
                                           for x in c1.tolist()],
                    "k2_counts_per_update": [x / t.shape[0]
                                             for x in c2.tolist()]}
            for order_ in (names, names[::-1]):
                for name in order_:
                    r = row["variants"][name]
                    r["k1_ms"].append(time_ms(
                        lambda: k1(name, L, out, src, dst)))
                    r["k2_ms"].append(time_ms(lambda: k2(name, L, out, t, v)))
            for r in row["variants"].values():
                r["k1_mean_ms"] = sum(r["k1_ms"]) / 2
                r["k2_mean_ms"] = sum(r["k2_ms"]) / 2
            rows.append(row)
            print(json.dumps({
                "graph": gname, "state": sname,
                "k1_k2_ms": {k: [r["k1_mean_ms"], r["k2_mean_ms"]]
                             for k, r in row["variants"].items()}}),
                flush=True)
            del t, v, want1, want2, out
        del src, dst, states
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({
        "device": torch.cuda.get_device_name(0), "variants": VARIANTS,
        "rows": rows}))
    print(json.dumps({"seconds": time.time() - t0, "out": str(args.out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
