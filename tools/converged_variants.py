#!/usr/bin/env python3
"""Time design variants of the early-convergence kernel K6
``converged_early`` side by side on one CUDA GPU.

The variants are instances of the template in
``tools/converged_variants.cu``: the edge streams alone (the HBM floor),
the streams and the two first-level label gathers (the gather floor), and
the full predicate with 16-byte stream loads, 4-16 edges a lane, an L2
policy (labels evict-last, streams evict-first and not in L1), the L1
carveout at its maximum, the root read once a distinct label a warp or a
lane, a table of the hubs' labels in shared memory made on the card
from the edges (``hub_table``), and a cache of labels in shared memory
that each block fills itself.  Beside them it times the port's shipped
kernel (``repro_torch.kernels.contour_mm.converged``), also on
``src[1:]``/``dst[1:]`` (its scalar path); and, with ``--parent``, the
kernel of another ``converged.cu`` with the same C interface (``git
show <commit>:src/repro_torch/kernels/contour_mm/csrc/converged.cu``).

Graphs are made on the card as ``tools/sweep_variants.py`` makes them:
rmat(22, 16) with Graph500's parameters and delaunay_like(24) (with
``--numpy-graphs``, by the port's seeded numpy generators, the graphs of
``chip_smoke.py``, in some minutes on the host); labels in
the C-2 states 0-2 (a witness in every warp's first step) and at the
fixed point (a full pass).  Every variant's flag must equal
``converged_early_plain`` at edge limits m, m - 1, m // 2, m // 4, 1 and
0 (the floors: their own partial predicate), and a test with the loop's
step must leave ``[flag, 1, 0, 0]``.  Times are CUDA-event means of 20
calls, each between its own events with a fresh loop state before it
(the card held busy while the host enqueues), taken in two passes in
opposite orders and averaged; at the fixed point in four settings: the
labels as the call before left them (``warm``), just written by a jump
round that stores them evict-first or plainly (``after_jump_stcs``,
``after_jump_plain``), and after an L2 flush (``flushed``).  The jump
round itself is timed with both stores.  Run from the root of a
checkout::

    python3 tools/converged_variants.py [--parent OLD.cu] [--numpy-graphs]
        [--only NAME,NAME] [--out FILE]

It writes every row to ``--out`` (default
``chiprun_out/converged_variants.json``) and prints one line per state.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import sweep_variants as sv  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# name: (id in converged_variants.cu, hub table bits or 0, its ways: 1
# for HUB, 2 for HUB2, 0 for a cache the kernel fills itself (S*, no
# table from the host).  V1/V2 are the floors; the others compute the
# predicate.  W_* read the exit words every step without the L2 policy,
# H_* add the two-way hub table, H_bad and H_late* fill it later.
VARIANTS = {
    "V1_streams": (1, 0, 0), "V2_gathers": (2, 0, 0),
    "V2_policy": (3, 0, 0), "V3_j1": (4, 0, 0), "V3": (5, 0, 0),
    "V3_j4": (6, 0, 0), "V4_no_carve": (7, 0, 0), "V4": (8, 0, 0),
    "V4_j4": (9, 0, 0), "V5_match_root": (10, 0, 0),
    "V6_lane_root": (11, 0, 0), "V7_hub12": (12, 12, 1),
    "V7_hub13": (12, 13, 1), "V6_j1": (13, 0, 0),
    "V2_j1": (20, 0, 0), "W_j1": (21, 0, 0), "W_lane": (22, 0, 0),
    "W_lane_j2": (23, 0, 0), "H_256_13": (24, 13, 2),
    "H_512_13": (25, 13, 2), "H_1024_14": (26, 14, 2),
    "H_1024_14_j2": (27, 14, 2), "H_bad": (28, 14, 2),
    "H_late": (29, 14, 2), "H_late_bad": (30, 14, 2),
    "S2": (31, 14, 0), "S1": (32, 14, 0), "S2_late": (33, 14, 0),
    "S2_512_13": (34, 13, 0),
}
FLOORS = ("V1_streams", "V2_gathers", "V2_policy", "V2_j1")
# the port's kernel, and on src[1:], dst[1:] (not 16-byte aligned: its
# scalar path)
SHIPPED = ("shipped", "shipped_src[1:]")
REPS = 20
HOLD_CYCLES = 200_000
HBM_BYTES_PER_S = 3.35e12


def build(source: Path, name: str):
    out = ROOT / "build" / "converged_variants" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(source)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    return ctypes.CDLL(str(out)), out, proc.stdout + proc.stderr


def sass_loads(library: Path) -> dict:
    """The global-load opcodes (``LDG.*``) of each function of the
    library, with their counts, from ``cuobjdump -sass``."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for section in sass.split("Function : ")[1:]:
        name, _, body = section.partition("\n")
        ops = {}
        for op in re.findall(r"\b(LDG[\w.]*)", body):
            ops[op] = ops.get(op, 0) + 1
        out[name.strip()] = ops
    return out


def hub_table(dst, n: int, bits: int, ways: int):
    """The hub table for the HUB (``ways`` 1) and HUB2 (2) variants:
    ``1 << bits`` ids, slot or bucket by bucket, each a vertex among the
    ``1 << bits`` most frequent destinations (the most frequent of those
    that hash to it first) or -1; made on the card.  Returns the table,
    its build time (ms, CUDA events) and the share of destination reads
    it serves."""
    size = 1 << bits
    bucket_bits = bits - (ways - 1)
    dev = dst.device
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    count = torch.bincount(dst.long(), minlength=n)
    top = torch.topk(count, min(size, n)).indices

    def bucket(ids):
        return ((ids.long() * 2654435761) & 0xFFFFFFFF) >> (32 - bucket_bits)

    b = bucket(top)
    order = torch.sort(b, stable=True).indices   # by bucket, then by rank
    sb = b[order]
    pos = torch.arange(sb.numel(), device=dev)
    start_of = torch.full((1 << bucket_bits,), sb.numel(), dtype=torch.long,
                          device=dev).scatter_reduce_(0, sb, pos, "amin")
    way = pos - start_of[sb]
    keep = way < ways
    table = torch.full((size,), -1, dtype=torch.int32, device=dev)
    table[sb[keep] * ways + way[keep]] = top[order[keep]].int()
    end.record()
    end.synchronize()
    rows = table.view(-1, ways)[bucket(dst)]
    share = float((rows == dst[:, None]).any(1).float().mean())
    return table, start.elapsed_time(end), share


def time_each_ms(fn, setup) -> float:
    """Mean device time of ``fn()`` over ``REPS`` calls, each between its
    own CUDA events with ``setup()`` (untimed) before it; the card spins
    before each setup so that the host has enqueued the call first."""
    for _ in range(2):
        setup()
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(REPS):
        torch.cuda._sleep(HOLD_CYCLES)
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / REPS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--numpy-graphs", action="store_true",
                    help="the port's seeded numpy generators (the graphs "
                         "of chip_smoke.py; minutes on the host)")
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names to time (the "
                         "shipped and parent kernels always)")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "converged_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.time()
    jobs = [(SOURCE, "converged_variants")]
    if args.parent is not None:
        jobs.append((args.parent.resolve(), "converged_parent"))
    with ThreadPoolExecutor(len(jobs) + 1) as ex:
        shipped_lib = ex.submit(cv.load_library)
        built = list(ex.map(lambda j: build(*j), jobs))
        shipped = shipped_lib.result()
    var, var_path, log = built[0]
    var.variant_converged.argtypes = [I32, P, P, P, I64, I64, P, I32, P,
                                      I32, P, P]
    var.variant_converged.restype = I32
    var.variant_jump.argtypes = [I32, P, P, I64, P]
    var.variant_jump.restype = I32
    parent = built[1][0] if len(built) > 1 else None
    if parent is not None:
        parent.contour_converged_early.argtypes = \
            shipped.contour_converged_early.argtypes
        parent.contour_converged_early.restype = I32
    shipped_path = _build.library_path(cv.LIBRARY, cv.SOURCES)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "device": card, "built_s": time.time() - t0,
        "ptxas": [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln
                  or "Compiling entry" in ln],
        "shipped_ptxas": [ln.strip() for ln in
                          _build.BUILD_LOGS.get(cv.LIBRARY, "").splitlines()
                          if "registers" in ln or "spill" in ln],
        "sass_loads": {**sass_loads(var_path), **sass_loads(shipped_path)}}),
        flush=True)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    sink = torch.zeros(1, dtype=torch.int32, device=dev)

    def run(name, L, src, dst, m, n, state, step, hub):
        if name == "parent" or name in SHIPPED:
            lib = parent if name == "parent" else shipped
            rc = lib.contour_converged_early(
                L.data_ptr(), src.data_ptr(), dst.data_ptr(), m, n,
                state.data_ptr(), step, stream())
        else:
            vid, bits, ways = VARIANTS[name]
            rc = var.variant_converged(
                vid, L.data_ptr(), src.data_ptr(), dst.data_ptr(), m, n,
                state.data_ptr(), step,
                None if not ways else hub[bits, ways].data_ptr(), bits,
                sink.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"{name}: launch returned {rc}")

    def jump(streaming, L, out):
        rc = var.variant_jump(int(streaming), L.data_ptr(), out.data_ptr(),
                              L.shape[0], stream())
        if rc:
            raise RuntimeError(f"jump: launch returned {rc}")

    flush = torch.empty(4 * torch.cuda.get_device_properties(0).L2_cache_size
                        // 4, dtype=torch.int32, device=dev)
    names = (["parent"] if parent is not None else []) + list(SHIPPED) + \
        [v for v in VARIANTS
         if args.only is None or v in args.only.split(",")]
    rows = []

    def numpy_graph(g):
        return g.src, g.dst, g.n_vertices

    if args.numpy_graphs:
        graphs = (("rmat(22,16)", lambda: numpy_graph(
                      gen.rmat(22, edge_factor=16, device=dev))),
                  ("delaunay_like(24)", lambda: numpy_graph(
                      gen.delaunay_like(24, device=dev))))
    else:
        graphs = (("rmat(22,16)", lambda: sv.rmat(22, 16, dev)),
                  ("delaunay_like(24)", lambda: sv.delaunay_like(24, dev)))
    for gname, make in graphs:
        src, dst, n = make()
        m = int(src.shape[0])
        states = sv.c2_states(src, dst, n, dev)
        states = states[:3] + states[-1:]
        hub, hub_info = {}, {}
        for bits, ways in sorted({VARIANTS[v][1:] for v in names
                                  if v in VARIANTS and VARIANTS[v][2]}):
            hub[bits, ways], ms, share = hub_table(dst, n, bits, ways)
            hub_info[f"{bits} bits, {ways}-way"] = {
                "build_ms": ms, "dst_reads_served": share}
        bound_ms = (8 * m + 4 * n) / HBM_BYTES_PER_S * 1e3
        for sname, L in states:
            fixed = sname.startswith("fixed")
            state = cv.loop_state(dev)

            def call(name, labels=None, limit=m, step=1):
                s_, d_, k = src, dst, limit
                if name == "shipped_src[1:]":
                    s_, d_, k = src[1:], dst[1:], max(limit - 1, 0)
                run(name, L if labels is None else labels, s_, d_, k, n,
                    state, step, hub)

            # the flags
            for name in names:
                for limit in (m, m - 1, m // 2, m // 4, 1, 0):
                    s_, d_, k = src, dst, limit
                    if name == "shipped_src[1:]":
                        s_, d_, k = src[1:], dst[1:], max(limit - 1, 0)
                    if name == "V1_streams":
                        want = True
                    elif name in FLOORS:
                        want = bool(torch.equal(L[s_[:k].long()],
                                                L[d_[:k].long()]))
                    else:
                        want = bool(cv.converged_early_plain(L, s_, d_, k))
                    state.zero_()
                    call(name, limit=limit, step=0)
                    got = int(state[cv.BAD]) == 0
                    state.zero_()
                    call(name, limit=limit, step=1)
                    if got != want or state.tolist() != [int(want), 1, 0, 0]:
                        raise AssertionError(
                            f"{name} on {gname} state {sname} limit {limit}: "
                            f"flag {got}, state {state.tolist()}, plain "
                            f"{want}")
            row = {"graph": gname, "state": sname, "n": n, "m": m,
                   "bound_ms": bound_ms, "hub": hub_info,
                   "flag": bool(cv.converged_early_plain(L, src, dst)),
                   "ms": {name: {} for name in names}}
            buf = torch.empty_like(L)
            modes = {"warm": state.zero_,
                     "flushed": lambda: (flush.fill_(0), state.zero_())}
            if fixed:
                jump(True, L, buf)
                if not torch.equal(buf, L):
                    raise AssertionError(f"{gname}: the fixed point moves "
                                         "under a jump round")
                modes["after_jump_stcs"] = lambda: (jump(True, L, buf),
                                                    state.zero_())
                modes["after_jump_plain"] = lambda: (jump(False, L, buf),
                                                     state.zero_())
            timed = [x for x in names if fixed or x not in FLOORS]
            for mode, setup in modes.items():
                labels = buf if mode.startswith("after_jump") else L
                for order in (timed, timed[::-1]):
                    for name in order:
                        row["ms"][name].setdefault(mode, []).append(
                            time_each_ms(lambda: call(name, labels), setup))
            for name in timed:
                row["ms"][name] = {k: sum(v) / len(v)
                                   for k, v in row["ms"][name].items()}
            if fixed:
                row["jump_ms"] = {
                    f"{store}_{mode}": time_each_ms(
                        lambda: jump(store == "stcs", L, buf),
                        (lambda: flush.fill_(0)) if mode == "flushed"
                        else (lambda: None))
                    for store in ("stcs", "plain")
                    for mode in ("flushed", "warm")}
            rows.append(row)
            print(json.dumps({"graph": gname, "state": sname,
                              "bound_ms": bound_ms, "ms": row["ms"],
                              **({"jump_ms": row["jump_ms"], "hub": hub_info}
                                 if fixed else {})}), flush=True)
            del buf
        del src, dst, states, hub
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": card, "variants": VARIANTS,
                                    "rows": rows}))
    print(json.dumps({"seconds": time.time() - t0, "out": str(args.out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
