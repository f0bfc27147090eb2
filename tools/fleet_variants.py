#!/usr/bin/env python3
"""Time design variants of the fleet's lane-resident kernels (K1 fleet,
K6 fleet, K2 fleet, K7 fleet;
``src/repro_torch/kernels/contour_mm/csrc/fleet.cu``) side by side on one
CUDA GPU.

Each variant is ``fleet.cu`` built with other values of its knobs
(``-DFLEET_RELAX_STAGES=...`` and the rest: each kernel's threads a
block, items a thread a tile, stages of the ring and the blocks an SM its
registers must allow).  On
``chip_smoke.py``'s rmat fleet (1024 x rmat(12,16)) and delaunay fleet
(256 x delaunay_like(14)) every variant is first held to the plain
versions (K1's labels, K6's lane and fleet words, K2's labels on the
order-1 stream, K7's labels, at identity, after one iteration and at the
fixed point, half the lanes frozen or none), then timed: K1 at the first
sweep and at the fixed point and K2 on the order-1 stream at identity
(CUDA-event mean of 20 calls, the card held busy), K6 at the fixed point
and on the live fleet after one iteration (each call between its own
events, fresh words before it) and K7 at identity after an L2 flush.  The
variants run in two passes, the second in the opposite order, and their
times are averaged; the global route (the fleet's kernels before the
lane route) is timed beside them, and K7's floors: a copy of the labels
after the same flush, and the first variant's K7 and the global route's
with no flush.  Run from
the root of a checkout::

    python3 tools/fleet_variants.py [--only NAME,NAME] [--rmat-count N] \
        [--fleets rmat,delaunay,ragged]

It prints the card's name and power limit and one JSON line a variant,
and writes them to ``chiprun_out/fleet_variants.jsonl``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.contour_mm import fleet  # noqa: E402

OUT = ROOT / "chiprun_out" / "fleet_variants.jsonl"
BUILD = ROOT / "build" / "fleet_variants"

def shape(kernel: str, threads: int, edges: int, stages: int,
          min_blocks: int) -> dict:
    """The knobs of one kernel's shape (``kernel``: RELAX, TEST, SCATTER
    or JUMP; JUMP has no stages)."""
    knobs = {f"FLEET_{kernel}_THREADS": threads,
             f"FLEET_{kernel}_EDGES": edges,
             f"FLEET_{kernel}_MIN_BLOCKS": min_blocks}
    if kernel != "JUMP":
        knobs[f"FLEET_{kernel}_STAGES"] = stages
    return knobs


# name -> knobs (fleet.cu's defaults where not named): a shape of one
# kernel a build, as threads a block, items a thread a tile, stages and
# blocks an SM ("s": K2, "j": K7); "j256e16b4" was K7's first shape
# (PERF.md)
VARIANTS = {
    "shipped": {},
    "s256e8s2": shape("SCATTER", 256, 8, 2, 4),
    "s512e4s3": shape("SCATTER", 512, 4, 3, 2),
    "s256e16s2": shape("SCATTER", 256, 16, 2, 2),
    "s1024e4s2": shape("SCATTER", 1024, 4, 2, 1),
    "j256e16b4": shape("JUMP", 256, 16, 0, 4),
    "j256e16b8": shape("JUMP", 256, 16, 0, 8),
    "j128e16b8": shape("JUMP", 128, 16, 0, 8),
    "j512e16b4": shape("JUMP", 512, 16, 0, 4),
    "j1024e8b2": shape("JUMP", 1024, 8, 0, 2),
}


def build(name: str, knobs: dict) -> ctypes.CDLL:
    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / f"libfleet_{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
           *(f"-D{k}={v}" for k, v in knobs.items()), "-o", str(out),
           str(fleet.SOURCES[0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    P, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.contour_fleet_relax_lane.argtypes = [P, P, P, P, i64, i64, i64, P,
                                             i32, P]
    lib.contour_fleet_converged_lane.argtypes = [P, P, P, i64, i64, i64, P,
                                                 P, i32, P]
    lib.contour_fleet_scatter_lane.argtypes = [P, P, P, P, i64, i64, i64,
                                               i64, P, i32, P]
    lib.contour_fleet_jump_lane.argtypes = [P, P, i64, i64, P, i32, P]
    lib.ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr)
                 .splitlines() if "registers" in ln or "spill" in ln]
    return lib


def launch(fn, *args) -> None:
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")


class Fleet:
    """A fleet on the card and its label states."""

    def __init__(self, kind: str):
        self.name = cs.fleet_name(kind)
        batched = cs.on_card(cs.stack_graphs(cs.fleet_graphs(kind)))
        self.src, self.dst = batched.src, batched.dst
        self.B, self.m = (int(x) for x in self.src.shape)
        n = self.n = batched.n_vertices
        off = cs.blocked.lane_offsets(self.B, n, cs.DEVICE)
        self.L0 = (torch.arange(n, dtype=torch.int32, device=cs.DEVICE)
                   .expand(self.B, n) + off).reshape(-1).contiguous()
        self.L1 = cs.cv.pointer_jump_batched_plain(
            cs.blocked.fused_relax_batched_plain(self.L0, self.src,
                                                 self.dst, n), n)
        self.Lf = (cs.solve_batch(batched).labels + off).reshape(-1) \
            .contiguous()
        self.half = torch.zeros((self.B, 4), dtype=torch.int32,
                                device=cs.DEVICE)
        self.half[1::2, cs.cv.DONE] = 1
        self.state = cs.cv.fleet_state(self.B, cs.DEVICE)
        # K2's order-1 stream at identity: two segments of [B, m]
        self.t1, self.v1 = cs.contour.mm_update_stream_batched(
            self.L0, self.src, self.dst, n, 1)

    def relax(self, lib, L, lanes=None):
        out = L.clone()
        launch(lib.contour_fleet_relax_lane, L.data_ptr(), out.data_ptr(),
               self.src.data_ptr(), self.dst.data_ptr(), self.m, self.B,
               self.n, None if lanes is None else lanes.data_ptr(), 1)
        return out

    def early(self, lib, L, state):
        launch(lib.contour_fleet_converged_lane, L.data_ptr(),
               self.src.data_ptr(), self.dst.data_ptr(), self.m, self.B,
               self.n, state.lanes.data_ptr(), state.fleet.data_ptr(), 1)

    def scatter(self, lib, L, t, v, lanes=None):
        out = L.clone()
        launch(lib.contour_fleet_scatter_lane, L.data_ptr(), out.data_ptr(),
               t.data_ptr(), v.data_ptr(), self.m,
               int(t.shape[0]) // (self.B * self.m), self.B, self.n,
               None if lanes is None else lanes.data_ptr(), 1)
        return out

    def jump(self, lib, L, lanes=None):
        out = torch.empty_like(L)
        launch(lib.contour_fleet_jump_lane, L.data_ptr(), out.data_ptr(),
               self.B, self.n, None if lanes is None else lanes.data_ptr(),
               1)
        return out

    def fresh(self):
        self.state.lanes.zero_()
        self.state.fleet.zero_()

    def check(self, lib) -> None:
        for L in (self.L0, self.L1, self.Lf):
            for lanes in (None, self.half):
                want = cs.blocked.fused_relax_batched_plain(
                    L, self.src, self.dst, self.n, lanes)
                plain = cs.cv.fleet_state(self.B, cs.DEVICE)
                if lanes is not None:
                    plain.lanes.copy_(lanes)
                cs.cv.converged_early_batched_plain(L, self.src, self.dst,
                                                    self.n, plain)
                if not torch.equal(self.relax(lib, L, lanes), want):
                    raise AssertionError("K1 differs")
                got = cs.cv.fleet_state(self.B, cs.DEVICE)
                if lanes is not None:
                    got.lanes.copy_(lanes)
                self.early(lib, L, got)
                if not (torch.equal(got.lanes, plain.lanes)
                        and torch.equal(got.fleet, plain.fleet)):
                    raise AssertionError("K6 differs")
                t, v = cs.contour.mm_update_stream_batched(
                    L, self.src, self.dst, self.n, 1)
                if not torch.equal(
                        self.scatter(lib, L, t, v, lanes),
                        cs.blocked.scatter_min_batched_plain(
                            L, t, v, self.n, lanes)):
                    raise AssertionError("K2 differs")
                if not torch.equal(self.jump(lib, L, lanes),
                                   cs.cv.pointer_jump_batched_plain(
                                       L, self.n, lanes)):
                    raise AssertionError("K7 differs")

    def times(self, lib) -> dict:
        out = {"k1": cs.time_ms(lambda: self.relax(lib, self.L0)),
               "k1_fixed": cs.time_ms(lambda: self.relax(lib, self.Lf))}
        for state, L in (("fixed", self.Lf), ("live", self.L1)):
            out[f"k6_{state}"] = cs.time_each_ms(
                lambda L=L: self.early(lib, L, self.state),
                setup=self.fresh)
        out["k2"] = cs.time_ms(lambda: self.scatter(lib, self.L0, self.t1,
                                                    self.v1))
        out["k7"] = cs.time_each_ms(lambda: self.jump(lib, self.L0),
                                    setup=cs.flush_l2)
        return out

    def global_times(self) -> dict:
        return {
            "k1": cs.time_ms(lambda: cs.blocked.fused_relax_batched_on(
                fleet.GLOBAL, self.L0, self.src, self.dst, self.n)),
            **{f"k6_{state}": cs.time_each_ms(
                lambda L=L: cs.cv.converged_early_batched_on(
                    fleet.GLOBAL, L, self.src, self.dst, self.n,
                    self.state), setup=self.fresh)
               for state, L in (("fixed", self.Lf), ("live", self.L1))},
            "k2": cs.time_ms(lambda: cs.blocked.scatter_min_batched_on(
                fleet.GLOBAL, self.L0, self.t1, self.v1, self.n)),
            "k7": cs.time_each_ms(lambda: cs.cv.pointer_jump_batched_on(
                fleet.GLOBAL, self.L0, self.n), setup=cs.flush_l2)}

    def floors(self, lib) -> dict:
        """What K7's time is held to: a copy of the labels (read once,
        written once) after the same flush, and K7 with the labels left
        in L2 (no flush), as in a solve, on the lane and global routes."""
        return {"copy_after_flush": cs.time_each_ms(
                    lambda: self.L0.clone(), setup=cs.flush_l2),
                "k7_no_flush": cs.time_each_ms(lambda: self.jump(
                    lib, self.L0)),
                "k7_global_no_flush": cs.time_each_ms(
                    lambda: cs.cv.pointer_jump_batched_on(
                        fleet.GLOBAL, self.L0, self.n))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None)
    ap.add_argument("--rmat-count", type=int, default=cs.BATCH_RMAT["count"])
    ap.add_argument("--fleets", default="rmat,delaunay",
                    help="of rmat, delaunay, ragged")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fleet_variants: no CUDA device", file=sys.stderr)
        return 1
    names = args.only.split(",") if args.only else list(VARIANTS)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    rows = [{"device": cs.device_line(), "torch": torch.__version__,
             "cuda": torch.version.cuda}]
    with ThreadPoolExecutor(len(names) + 1) as pool:
        builds = {name: pool.submit(build, name, VARIANTS[name])
                  for name in names}
        pool.submit(cs.build_all).result()
        libs = {name: f.result() for name, f in builds.items()}
    cs.BATCH_RMAT["count"] = args.rmat_count
    fleets = [Fleet(kind) for kind in args.fleets.split(",")]
    for fl in fleets:
        for name in names:
            fl.check(libs[name])
        cs.sync()
        passes = [dict((name, fl.times(libs[name])) for name in order)
                  for order in (names, names[::-1])]
        glob = fl.global_times()
        for name in names:
            mean = {k: (passes[0][name][k] + passes[1][name][k]) / 2
                    for k in passes[0][name]}
            rows.append({"fleet": fl.name, "variant": name,
                         "knobs": VARIANTS[name], "ms": mean,
                         "passes": [p[name] for p in passes],
                         "ptxas": libs[name].ptxas})
        rows.append({"fleet": fl.name, "variant": "global_route",
                     "ms": glob})
        rows.append({"fleet": fl.name, "variant": "floors",
                     "ms": fl.floors(libs[names[0]])})
    with OUT.open("w") as f:
        for row in rows:
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
