#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s fleet phase alone on one CUDA GPU: the fleets'
walls and the fleet's K1, K6, K2 and K7 on each route.

By default it runs ``chip_smoke.phase_batch``: the three fleets through
``solve_batch`` (1024 x rmat(12,16), 256 x delaunay_like(14), the ragged
512; cold and warm walls, the solo loops, the ``torch`` backend, host
syncs, idle share, launches by route), C-11mm on the rmat and ragged
fleets, the check scale, and ``chip_smoke.fleet_kernels`` on the rmat
fleet.  With ``--kernels-only`` it builds the rmat fleet, solves it once
for its fixed point and runs ``chip_smoke.fleet_kernels`` alone: every
fleet entry point held against its plain version (K1, K6, K2 and K7
fleet on the lane route at its c, at c = 1 and at c = 4, and on the
global route), then timed at the first sweep (K1, K2's order-1 stream),
the fixed point and the live fleet after one iteration (K6) and after an
L2 flush (K7).  The global route is the fleet's kernels
as they were before the lane route, so the two routes' times, taken in
one call, compare the designs.  Run from the root of a checkout::

    python3 tools/fleet_lanes.py [--kernels-only] [--count 1024]

It prints the card's name and power limit, the libraries' ``ptxas``
report and one JSON line per result, and writes them to
``chiprun_out/fleet_lanes.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

OUT = ROOT / "chiprun_out" / "fleet_lanes.jsonl"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--count", type=int, default=cs.BATCH_RMAT["count"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fleet_lanes: no CUDA device", file=sys.stderr)
        return 1
    OUT.parent.mkdir(parents=True, exist_ok=True)
    rows = [{"device": cs.device_line(), "torch": torch.__version__,
             "cuda": torch.version.cuda}]
    rows.append({"build": cs.build_all()})
    cs.BATCH_RMAT["count"] = args.count
    if args.kernels_only:
        batched = cs.on_card(cs.stack_graphs(cs.fleet_graphs("rmat")))
        fixed = cs.solve_batch(batched).labels
        kernels = cs.fleet_kernels(batched, fixed)
    else:
        walls, kernels = cs.phase_batch()
        rows += walls
    rows.append({"kernels": kernels})
    with OUT.open("w") as f:
        for row in rows:
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
