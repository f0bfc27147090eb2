#!/usr/bin/env python3
"""Time design variants of the fleet's no-change test
(``converged.labels_unchanged_batched``, ``unchanged_lanes_kernel``) side
by side on one CUDA GPU.

The variants are instances of the template in
``tools/unchanged_variants.cu``, which includes the shipped
``converged.cu``: other block and tile shapes, a last-block step that
reads and writes each lane's four words as one 16-byte access, the
tickets with no pass over the lanes (a floor that leaves the words
unstepped), and the next tile's words read during a tile
(``prefetch``).  Beside them it times the shipped wrapper, and the shipped
library's launcher called through ctypes alone (``shipped_ctypes``, the
wrapper's checks left out).  On
``chip_smoke.py``'s rmat, delaunay and ragged fleets (made anew, by the
port's seeded generators), in two states: live (one C-Syn sweep from
identity against identity) and at the fixed point (against a copy).
Every variant but the floor must leave the plain version's lane and
fleet words.  Times are CUDA-event means of ``chip_smoke.REPS`` calls,
each between its own events with fresh words before it, taken in two
passes in opposite orders and averaged.  Run from the root of a
checkout::

    python3 tools/unchanged_variants.py [--fleets rmat,delaunay,ragged]

It prints the card's name and power limit and one line per fleet and
state, and writes them to ``chiprun_out/unchanged_variants.jsonl``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
OUT = ROOT / "chiprun_out" / "unchanged_variants.jsonl"
P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# name: id in unchanged_variants.cu (threads x vectors a thread _ blocks
# an SM, and the step: 16-byte words, or none, which leaves the words
# unstepped: a floor)
VARIANTS = {"256x2_8": 0, "256x2_8_step16": 1, "256x2_8_no_pass": 2,
            "256x4_8": 3, "512x2_4": 4, "256x2_4": 5, "1024x1_2": 6,
            "128x2_16": 7, "256x1_8": 8, "256x1_4": 9, "128x1_16": 10,
            "256x1_8_step16": 11, "512x1_4": 12, "256x1_8_no_pass": 13,
            "256x1_8_prefetch": 14, "256x2_8_prefetch": 15}
FLOORS = ("256x2_8_no_pass", "256x1_8_no_pass")


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "unchanged_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cs._build._nvcc(), *cs._build.NVCC_FLAGS, "-o",
                           str(out), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.variant_unchanged.argtypes = [I32, P, P, I64, I64, P, P, P]
    lib.variant_unchanged.restype = I32
    return lib


def states(kind: str) -> dict:
    """The fleet's (a, b) pairs of each state, and its B and n."""
    host, sizes = cs.stack_graphs(cs.fleet_graphs(kind), with_sizes=True)
    batched = cs.on_card(host)
    lanes_b, n = int(batched.src.shape[0]), batched.n_vertices
    off = cs.blocked.lane_offsets(lanes_b, n, cs.DEVICE)
    L0 = (torch.arange(n, dtype=torch.int32, device=cs.DEVICE)
          .expand(lanes_b, n) + off).reshape(-1).contiguous()
    L1 = cs.blocked.fused_relax_batched_plain(L0, batched.src, batched.dst,
                                              n)
    Lf = (cs.solve_batch(batched, batch_sizes=sizes).labels + off
          ).reshape(-1).contiguous()
    return {"B": lanes_b, "n": n,
            "pairs": {"live": (L1, L0), "fixed": (Lf, Lf.clone())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fleets", default="rmat,delaunay,ragged")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("unchanged_variants: no CUDA device", file=sys.stderr)
        return 1
    cv = cs.cv
    cv.load_library()
    lib = build()
    rows = [{"device": cs.device_line(), "torch": torch.__version__,
             "cuda": torch.version.cuda}]
    for kind in args.fleets.split(","):
        fl = states(kind)
        lanes_b, n = fl["B"], fl["n"]
        state = cv.fleet_state(lanes_b, cs.DEVICE)

        def fresh():
            state.lanes.zero_()
            state.fleet.zero_()

        def call(name, a, b):
            if name == "shipped":
                return cv.labels_unchanged_batched(a, b, n, state)
            stream = torch.cuda.current_stream().cuda_stream
            if name == "shipped_ctypes":
                rc = cv.load_library().contour_labels_unchanged_batched(
                    a.data_ptr(), b.data_ptr(), lanes_b, n,
                    state.lanes.data_ptr(), state.fleet.data_ptr(), stream)
            else:
                rc = lib.variant_unchanged(
                    VARIANTS[name], a.data_ptr(), b.data_ptr(), lanes_b, n,
                    state.lanes.data_ptr(), state.fleet.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")
            return None

        names = ["shipped", "shipped_ctypes",
                 *(args.only.split(",") if args.only else VARIANTS)]
        for key, (a, b) in fl["pairs"].items():
            want = cv.fleet_state(lanes_b, cs.DEVICE)
            cv.labels_unchanged_batched_plain(a, b, n, want)
            for name in names:
                fresh()
                call(name, a, b)
                same = (torch.equal(state.lanes, want.lanes)
                        and torch.equal(state.fleet[:2], want.fleet[:2]))
                if not same and name not in FLOORS:
                    raise AssertionError(f"{kind} {key}: {name} differs "
                                         "from the plain version")
            times = {name: 0.0 for name in names}
            for order in (names, names[::-1]):
                for name in order:
                    times[name] += cs.time_each_ms(
                        lambda: call(name, a, b), setup=fresh) / 2
            row = {"fleet": cs.fleet_name(kind), "B": lanes_b, "n": n,
                   "state": key, "ms": times,
                   **cs.bound(8 * lanes_b * n, lanes_b * n)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del fl
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with OUT.open("w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    print(rows[0]["device"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
