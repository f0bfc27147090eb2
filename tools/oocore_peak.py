#!/usr/bin/env python3
"""Which tensors make the out-of-core solver's device peak, on one CUDA
GPU.

Runs ``OutOfCoreContraction(...).run()`` on ``delaunay_like(scale)``'s
host arrays in chunks of ``--chunk`` edges (``chip_smoke.py``'s mesh row:
scale 21, 2**17) with the CUDA caching allocator recording its history
(``torch.cuda.memory._record_memory_history``), replays the recorded
allocations to find the moment of the peak, and prints the tensors alive
then, biggest first, each with the innermost frames of ``repro_torch``
that allocated it.  Beside them: ``max_memory_allocated()`` less the
bytes allocated before the run, the engine's ``peak_bytes_estimate()``,
the edge list's 8m, and the peak of each fold and of the finish alone.
Run from the root of a checkout::

    python3 tools/oocore_peak.py [--scale 21] [--chunk 131072] [--out FILE]

It prints one JSON object and writes it to ``--out`` too when given.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.connectivity import oocore  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402


def frames(event, depth: int = 5) -> list:
    """The innermost ``depth`` frames of the port behind an allocation."""
    out = []
    for f in event.get("frames", []):
        name = f.get("filename", "")
        if "repro_torch" in name:
            short = name[name.index("repro_torch"):]
            out.append(f"{short}:{f.get('line')} {f.get('name')}")
        if len(out) == depth:
            break
    return out


def live_at_peak(trace: list) -> tuple:
    """(peak bytes, the allocations alive at it) over the recorded trace;
    tensors allocated before the recording are left out."""
    live, cur, peak, at_peak = {}, 0, 0, {}
    for ev in trace:
        action, addr = ev["action"], ev["addr"]
        if action == "alloc":
            live[addr] = ev
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif action in ("free_requested", "free_completed") and addr in live:
            cur -= live.pop(addr)["size"]
    return peak, sorted(at_peak.values(), key=lambda e: -e["size"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--chunk", type=int, default=1 << 17)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("oocore_peak: no CUDA device", file=sys.stderr)
        return 1
    src, dst, n = gen.delaunay_like(args.scale, device="cpu").to_numpy()
    chunks = gen.ArrayChunks(src, dst, n, args.chunk)
    # a first run builds the kernels and warms the allocator's cache
    oocore.OutOfCoreContraction(chunks).run()
    torch.cuda.synchronize()

    fold_peaks = []
    fold = oocore._fold_chunk

    def measured_fold(*a, **k):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fold(*a, **k)
        torch.cuda.synchronize()
        fold_peaks.append(torch.cuda.max_memory_allocated() - before)
        return out

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="all", stacks="python", max_entries=500_000)
    eng = oocore.OutOfCoreContraction(chunks)
    while not eng.finished_streaming:
        eng.run_round()
    torch.cuda.synchronize()
    streamed = torch.cuda.max_memory_allocated() - base
    eng.finish()
    torch.cuda.synchronize()
    run_peak = torch.cuda.max_memory_allocated() - base
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    peak, alive = live_at_peak(trace)

    oocore._fold_chunk = measured_fold
    try:
        again = oocore.OutOfCoreContraction(chunks)
        while not again.finished_streaming:
            again.run_round()
    finally:
        oocore._fold_chunk = fold

    label_bytes = 4 * n
    row = {"graph": f"delaunay_like({args.scale})", "n": n,
           "m": int(src.shape[0]), "chunk_edges": args.chunk,
           "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__,
           "peak_bytes_of_the_run": run_peak,
           "peak_bytes_of_the_rounds": streamed,
           "peak_bytes_estimate": eng.peak_bytes_estimate(),
           "edge_list_bytes": 8 * int(src.shape[0]),
           "traced_peak_bytes": peak, "label_bytes": label_bytes,
           "alive_at_peak": [
               {"bytes": e["size"], "labels": e["size"] / label_bytes,
                "frames": frames(e)} for e in alive],
           "fold_peak_bytes_max": max(fold_peaks) if fold_peaks else None,
           "fold_peak_labels_max": (max(fold_peaks) / label_bytes
                                    if fold_peaks else None),
           "folds": len(fold_peaks), "rounds": eng.round_counts}
    text = json.dumps(row)
    print(text, flush=True)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
