#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
with ``nvcc`` (sm_90a, one ``nvcc`` per library, started together),
holds each kernel against its plain PyTorch version at the shapes its
path gives it, then drives the port's paths at the paper's sizes and
checks their labels against the ``torch`` backend (plain torch on the
card, sweeps and loop alike: it launches no kernel), against the same
solve on CPU tensors where the kernel's order of updates matters, and
against scipy's connected components:

* the main path, ``repro_torch.solve(g)`` (Contour C-2 on the ``cuda``
  kernels, its fixpoint loop on the card: ``converged_early`` does the
  loop's step, ``pointer_jump`` the jump rounds, and the host reads the
  loop's state once per ``converged.CHUNK`` iterations), and C-11mm,
  whose order-1 sweeps run ``scatter_min``; before it, ``fused_relax``
  and ``scatter_min`` are held against their plain versions on hub
  graphs, slices and edge limits, their counts (updates before the test
  of the output label, hot slots) against the plain replays, their SASS
  for the warp combine (``contour_hopper``), and timed in four label
  states of each main-path graph; after it, ``converged_early``,
  ``labels_unchanged`` and ``pointer_jump`` are held against their plain
  versions in the same states and at the solve's fixed point (the
  predicate there also timed right after a jump round, as the loop
  meets it, after an L2 flush, and on a pass whose one witness is at
  its end), and the
  warm solve is timed at several chunk sizes and traced with
  ``torch.profiler`` for the card's idle share;
* the asynchronous path, ``solve(g, backend="cuda_async")`` on the
  in-order sweep kernel ``mm2``;
* the baseline families, ``solve(g, algorithm=a)`` for FastSV and label
  propagation (their hookings on ``scatter_min``, their no-change test on
  ``labels_unchanged``) and Rem's union-find (on the host), against scipy
  and against the same solves on CPU tensors at the check scale, and a
  FastSV iteration timed with and without the freeze of its state;
* the frontier path, ``solve(g, sampling=2, compact_every=2,
  sampling_strategy=s)`` for every sampling strategy, staged;
* the streaming path, ``StreamingConnectivity(n).ingest(src, dst,
  validate=False)`` over the main path's graphs' own edges in batches of
  2**20 (device tensors), against scipy, the ``torch`` backend's stream
  bit for bit, ``resolve()`` and a checkpoint round trip, with the
  kernels of each delta solve (``fused_relax``, ``converged_early``,
  ``pointer_jump``) counted; at the check scale, against the same stream
  on CPU tensors after every batch;
* the serving path, ``run_simulation`` (the serving engine under four
  query threads and an ingest thread) at 4,194,304 vertices, 250,000
  queries and 250 ingests, against scipy and a ``torch``-backend stream,
  a sample of its answers against the final labels; then two injected
  crashes recovered from checkpoints and the write-ahead log, with no
  acknowledged ingest lost and the clean run's labels;
* the out-of-core path, ``OutOfCoreContraction(chunks).run()`` (the
  edges on the host, the labels and one chunk on the card, each chunk
  copied through pinned buffers on a copy stream while the chunk before
  it folds on ``fused_relax``, ``converged_early`` and ``pointer_jump``):
  rmat(22,16)'s host arrays in chunks of 2**20 with no edge list of it on
  the card, R-MAT generated chunk by chunk, the async path's mesh, the
  star forest that needs two rounds, and ``solve(g,
  algorithm="out_of_core")``; against scipy, the in-core solve, the
  ``torch`` backend's run after every round (on rmat(22,16)) and the CPU
  run after every round (at the check scale); the peak device bytes
  against the edge list's 8m; each round split into pads, copies (their
  GB/s beside one pinned copy timed alone), folds and contraction, with
  host syncs and the card's idle share over round 0;
* the recovery path, ``oocore_with_recovery`` with a fault in the middle
  of round 0 and one at a round boundary, and ``stream_with_recovery``
  over rmat(20,16)'s edges with two faults, each against its clean run
  bit for bit;
* the float kernels' entry points, ``fused_rmsnorm(x, w)`` and
  ``flash_attention(q, k, v)``, at mistral-nemo-12b's widths (d_model
  5120; 32 heads, 8 KV heads, head dim 128) over 8 x 4096 and 2 x 4096
  tokens, after ``rmsnorm_rows`` and ``flash_mha`` were held against
  their plain versions there and at other widths of the repo's models;
  both in bfloat16 and float16; ``flash_attention``'s 16-bit kernel is
  also shown to run on ``wgmma`` and TMA in both types (its SASS), with
  its rate and SDPA's error beside it.

Every phase prints one JSON line with its seconds; any failed check
raises and the script exits non-zero.  The lines before the last are the
card's name and power limit (as ``nvidia-smi`` prints them) and one
``{"kernels": [...]}`` object, with each kernel's launches summed over
the paths; the last line is ``{"ok": true, "device": {...}}``.

Run from the root of a checkout, on a machine with one CUDA GPU::

    python3 chip_smoke.py

It needs numpy, scipy, torch built for CUDA and ``nvcc``; it imports
nothing of JAX.  float32 matrix products stay float32 (TF32 off), so the
plain versions are exact references.  Without a CUDA device it exits
with code 1 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import (Graph, StreamingConnectivity, solve,  # noqa: E402
                         solve_batch, stack_graphs)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.connectivity import SAMPLING_STRATEGIES, minmap  # noqa: E402
from repro_torch.connectivity import fastsv  # noqa: E402
from repro_torch.connectivity import oocore  # noqa: E402
from repro_torch.connectivity import (  # noqa: E402
    OutOfCoreContraction, oocore_with_recovery, stream_with_recovery)
from repro_torch.connectivity import contour  # noqa: E402
from repro_torch.connectivity import frontier as fr  # noqa: E402
from repro_torch.connectivity import planner  # noqa: E402
from repro_torch.connectivity.solvers import device_degree_skew  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.contour_mm import blocked, kernel, ops  # noqa: E402
from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, mha_ref)
from repro_torch.kernels.flash_attention import \
    kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import (  # noqa: E402
    fused_rmsnorm, rmsnorm_ref)
from repro_torch.kernels.fused_rmsnorm import \
    kernel as rms_kernel  # noqa: E402
from repro_torch.runtime import FaultInjector, SimulatedFault  # noqa: E402
from repro_torch.serving import ConnectivityEngine  # noqa: E402
from repro_torch.serving.simulate import (  # noqa: E402
    WorkloadSpec, make_ingest_plan, run_simulation)

DEVICE = "cuda"
# rmat(22, 16) is the size of the paper's soc-LiveJournal1
RMAT_EDGE_FACTOR = 16
# calls per CUDA-event or host-clock timing
REPS = 20
# cycles the card spins before a timed call (about 0.1 ms at 1.98 GHz):
# more than the host takes to enqueue one call
HOLD_CYCLES = 200_000
# launches per timing of the in-order sweep kernel mm2: one launch walks
# every edge on one thread and takes seconds at the async path's sizes
ASYNC_REPS = 3
# mm2's (window, depth, cache slots) at which every branch of its protocol
# fires, checked on the small graphs named in MM2_TINY_ON
MM2_TINY = [(1, 1, 1), (3, 2, 1), (4, 4, 2), (7, 5, 8)]
MM2_TINY_ON = ("path_unshuffled(65536)", "star(65536)")
# the chunk sizes (iterations between two reads of the loop's state) at
# which the warm C-2 solve is timed
CHUNKS = (1, 2, 3, 4, 6, 8, 16)
# the frontier schedule the repo's drivers run (benchmarks/connectivity.py,
# examples/quickstart.py)
FRONTIER = {"sampling": 2, "compact_every": 2}
# H100 SXM published peaks (NVIDIA data sheet) behind each bound_ms: HBM
# bandwidth, and the float32 rate outside the tensor cores, the table's
# closest entry for the kernels' int32 min/compare work
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# dense bf16 and fp16 tensor-core rate: the least time of attention's
# products
BF16_TENSOR_OPS_PER_S = 989e12
# mistral-nemo-12b (src/repro/configs/mistral_nemo_12b.py): d_model, query
# heads, KV heads, head dim
NEMO = {"d": 5120, "H": 32, "Hkv": 8, "hd": 128}
# the streaming path: each main-path graph's own edges, in order, in
# batches of this many edges (device tensors, validate=False: the
# pre-validated device stream), and the batch at the check scale
STREAM_BATCH = 1 << 20
CHECK_STREAM_BATCH = 1 << 16
# the serving path: 250,000 queries and 250 ingests of 65,536 edges into
# 4,194,304 vertices (16.4M edges, rmat(22)'s vertex count)
SERVE_SPEC = WorkloadSpec(n_vertices=4_194_304, n_queries=250_000,
                          zipf_a=1.3, burst_mean=64, write_ratio=0.001,
                          edges_per_batch=65_536, n_query_threads=4,
                          window=4096, seed=0)
# its recovery run (benchmarks/serving.py's fault schedule and cadence):
# 40 ingests and 20,000 queries, two injected crashes
RECOVERY_SPEC = dataclasses.replace(SERVE_SPEC, n_queries=20_000,
                                    write_ratio=0.002)
RECOVERY_FAIL_AT = ((3, "pre"), (17, "pre"))
RECOVERY_CHECKPOINT_EVERY = 8
# answers of the serving run held against its final labels
ANSWER_SAMPLE = 10_000
# the time the two phases are meant to take together at most (printed
# beside their seconds; the serving run's wall is the host's, which
# varies with the machine's load, so it is reported, not a check)
STREAM_SERVE_BUDGET_S = 120.0
# the out-of-core path: rmat(22,16)'s host arrays in chunks of 2**20 (62
# chunks), R-MAT generated chunk by chunk (scale 20, 64 chunks of 2**18),
# the async path's delaunay_like(21) in chunks of 2**17 (48), the star
# forest that needs two rounds, and the check scale (64 chunks of 2**14)
OOCORE_CHUNK = 1 << 20
OOCORE_GENERATED = {"scale": 20, "edge_factor": 16, "chunk_edges": 1 << 18}
OOCORE_MESH_CHUNK = 1 << 17
OOCORE_STAR = {"k": 16, "b": 1024}
OOCORE_CHECK = {"scale": 16, "edge_factor": 16, "chunk_edges": 1 << 14}
# the recovery path: the out-of-core mesh with a fault in the middle of
# round 0 and one at the boundary of round 1; rmat(20,16)'s edges streamed
# in batches of 2**20 with two faults and a checkpoint every 4 batches
STREAM_RECOVERY_FAIL_AT = ((3, "pre"), (11, "post_write"))
STREAM_RECOVERY_CHECKPOINT_EVERY = 4
# one pinned copy timed alone: the host-to-device ceiling the out-of-core
# copies are read against
PINNED_PROBE_BYTES = 8 << 20
# the time the out-of-core and recovery phases are meant to take together
# at most (reported, as STREAM_SERVE_BUDGET_S)
OOCORE_BUDGET_S = 120.0
# the fleet path (solve_batch): 1024 x rmat(12,16) and 256 x
# delaunay_like(14) (4,194,304 labels each fleet), and a ragged fleet of
# 512 graphs of 2**8..2**14 vertices (drawn with BATCH_SEED) over rmat,
# path, grid and star; each graph seeded by its place in its fleet
BATCH_RMAT = {"count": 1024, "scale": 12}
BATCH_DELAUNAY = {"count": 256, "scale": 14}
BATCH_RAGGED = {"count": 512, "scales": (8, 14)}
BATCH_SEED = 21
# the time the fleet and auto phases are meant to take together at most
# (reported, as the other budgets)
BATCH_AUTO_BUDGET_S = 90.0
# kernel against plain version in float32, (atol, rtol, rms_rel) by working
# type: every element within |a - b| <= atol + rtol * |b|, and the whole
# output within rms(a - b) <= rms_rel * rms(b).  Both versions compute in
# float32 and round once to the working type, so a sound kernel differs
# from its plain version where the two float32 results straddle a
# rounding boundary, by one unit in the last place (at most 2**-7 * |b|
# in bfloat16, inside rtol).  rms_rel holds the output as a whole: a fault
# of a few thousandths on every element (a key tile skipped, products
# rounded to bfloat16) stays inside each element's bound where attention's
# outputs are small (|o| ~ 0.03 at S = 4096) but not inside rms_rel.
# Readings and a faulty kernel held to these limits: PERF.md
# float16's limits are tighter than bfloat16's: it keeps three more bits
# (one unit in its last place is at most 2**-10 |b|, inside rtol = 2e-3),
# and its split P leaves ~1e-5 of rms(b) in attention (the CPU replay,
# tests/test_torch_flash_replay.py), where one float16 P leaves ~2.6e-4,
# past rms_rel = 1e-4.
RMS_TOL = {torch.bfloat16: (1e-2, 1e-2, 5e-4),
           torch.float16: (1e-3, 2e-3, 1e-4),
           torch.float32: (1e-5, 1e-5, 1e-5)}
FLASH_TOL = {torch.bfloat16: (4e-3, 1e-2, 5e-4),
             torch.float16: (1e-3, 2e-3, 1e-4),
             torch.float32: (1e-5, 1e-4, 1e-5)}

REPLACES = {
    "fused_relax": "src/repro/kernels/contour_mm/blocked.py:236 "
                   "(fused_relax_pallas)",
    "scatter_min": "src/repro/kernels/contour_mm/blocked.py:92 "
                   "(binned_scatter_min_pallas)",
    "mm2": "src/repro/kernels/contour_mm/kernel.py:53 (mm2_pallas)",
    # no Pallas counterpart: XLA inside the reference's lax.while_loop
    # (src/repro/connectivity/contour.py:244)
    "converged_early": "src/repro/connectivity/minmap.py:88 "
                       "(converged_early; no Pallas counterpart, XLA-fused "
                       "in the reference's loop)",
    "labels_unchanged": "src/repro/connectivity/contour.py:238 "
                        "(jnp.all(L_new == L), also fastsv.py:61 and "
                        "lp.py:42; no Pallas counterpart, XLA-fused)",
    "pointer_jump": "src/repro/connectivity/minmap.py:75 (pointer_jump; no "
                    "Pallas counterpart, XLA-fused in the reference's loop)",
    "rmsnorm_rows": "src/repro/kernels/fused_rmsnorm/kernel.py:31 "
                    "(rmsnorm_rows)",
    "flash_mha": "src/repro/kernels/flash_attention/kernel.py:77 "
                 "(flash_mha)",
    # the fleet's entry points: the same TPU kernels and XLA steps, which
    # the reference's solve_batch runs under jax.vmap
    # (src/repro/connectivity/batch.py:109)
    "fused_relax_batched": "src/repro/kernels/contour_mm/blocked.py:236 "
                           "(fused_relax_pallas, vmapped by solve_batch)",
    "scatter_min_batched": "src/repro/kernels/contour_mm/blocked.py:92 "
                           "(binned_scatter_min_pallas, vmapped by "
                           "solve_batch)",
    "converged_early_batched": "src/repro/connectivity/minmap.py:88 "
                               "(converged_early, vmapped by solve_batch; "
                               "no Pallas counterpart, XLA-fused)",
    "labels_unchanged_batched": "src/repro/connectivity/contour.py:238 "
                                "(jnp.all(L_new == L), vmapped by "
                                "solve_batch; no Pallas counterpart)",
    "pointer_jump_batched": "src/repro/connectivity/minmap.py:75 "
                            "(pointer_jump, vmapped by solve_batch; no "
                            "Pallas counterpart)",
}
SOURCE = "src/repro_torch/kernels/contour_mm/csrc/contour_mm.cu"
MM2_SOURCE = "src/repro_torch/kernels/contour_mm/csrc/mm2.cu"
CONVERGED_SOURCE = "src/repro_torch/kernels/contour_mm/csrc/converged.cu"
RMSNORM_SOURCE = "src/repro_torch/kernels/fused_rmsnorm/csrc/rmsnorm.cu"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
# (library, its module) for every kernel library of the port
LIBRARIES = ((blocked.LIBRARY, blocked), (kernel.LIBRARY, kernel),
             (cv.LIBRARY, cv), (rms_kernel.LIBRARY, rms_kernel),
             (flash_kernel.LIBRARY, flash_kernel))
# every kernel wrapper of the port, by name; each counts its launches
WRAPPERS = {"fused_relax": blocked.fused_relax,
            "scatter_min": blocked.scatter_min, "mm2": kernel.mm2,
            "converged_early": cv.converged_early,
            "labels_unchanged": cv.labels_unchanged,
            "pointer_jump": cv.pointer_jump,
            "rmsnorm_rows": rms_kernel.rmsnorm_rows,
            "flash_mha": flash_kernel.flash_mha,
            "fused_relax_batched": blocked.fused_relax_batched,
            "scatter_min_batched": blocked.scatter_min_batched,
            "converged_early_batched": cv.converged_early_batched,
            "labels_unchanged_batched": cv.labels_unchanged_batched,
            "pointer_jump_batched": cv.pointer_jump_batched}
KERNEL_NAMES = tuple(WRAPPERS)


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
    """Mean device time of ``fn()`` over ``REPS`` calls (CUDA events).

    The card first spins for ``HOLD_CYCLES`` so that the host enqueues the
    calls ahead of it: a kernel shorter than its call's host time is then
    timed on the card alone, not at the host's pace."""
    for _ in range(2):
        fn()
    sync()
    torch.cuda._sleep(HOLD_CYCLES * REPS)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / REPS


def time_each_ms(fn, setup=None) -> float:
    """Mean device time of ``fn()`` alone over ``REPS`` calls, each between
    its own pair of CUDA events, with ``setup()`` (untimed) before each;
    the card spins before each setup, as in :func:`time_ms`, so that the
    host has enqueued the call when its first event is reached."""
    for _ in range(2):
        if setup is not None:
            setup()
        fn()
    sync()
    pairs = []
    for _ in range(REPS):
        torch.cuda._sleep(HOLD_CYCLES)
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    sync()
    return sum(s.elapsed_time(e) for s, e in pairs) / REPS


_flush = []


def flush_l2() -> None:
    """Write a buffer of four times the card's L2, so that the next call
    reads its inputs from HBM, as it does inside a solve, where the sweep
    between two calls streams the edges through L2."""
    if not _flush:
        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        _flush.append(torch.empty(l2, dtype=torch.int32, device=DEVICE))
    _flush[0].fill_(0)


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


def raises(fn, error) -> bool:
    try:
        fn()
    except error:
        return True
    return False


def bound(bytes_moved: int, ops: int, rate: float = ALU_OPS_PER_S) -> dict:
    """The least time of the work: bytes over the HBM rate against
    operations over ``rate``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "ops": ops}


def launch_counts() -> dict:
    return {name: WRAPPERS[name].launches for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def host_syncs(fn) -> dict:
    """Synchronizing operations in one call of ``fn``, as torch's sync
    debug mode flags them (the device-to-host reads of a solve): the
    total, and the count at each source line that made one, named by the
    innermost frame of the port's package (or of this script) on the
    stack at the time."""
    sites = Counter()
    ours = (str(ROOT / "src" / "repro_torch"), str(ROOT / "chip_smoke.py"))

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        for frame in reversed(traceback.extract_stack()[:-1]):
            if frame.filename.startswith(ours):
                filename, lineno = frame.filename, frame.lineno
                break
        sites[f"{Path(filename).name}:{lineno}"] += 1

    sync()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    return {"total": sum(sites.values()), "sites": dict(sites)}


def plain_solve(g, **options):
    """``solve(g, backend="torch", **options)``, the plain reference: it
    must launch no kernel (the counts are read around it and set to 0
    again after)."""
    reset_launch_counts()
    res = solve(g, backend="torch", **options)
    launched = {k: v for k, v in launch_counts().items() if v}
    reset_launch_counts()
    if launched:
        raise AssertionError(f"the torch backend launched kernels: "
                             f"{launched}")
    return res


def cpu_copy(g) -> Graph:
    return Graph(src=g.src.cpu(), dst=g.dst.cpu(), n_vertices=g.n_vertices)


def same_result(a, b, what: str) -> None:
    """Labels, iterations, converged and edges_visited, bit for bit."""
    for field in ("labels", "iterations", "converged", "edges_visited"):
        if not torch.equal(getattr(a, field).cpu(), getattr(b, field).cpu()):
            raise AssertionError(f"{what}: {field} differs")


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
    return scipy_labels_of(*g.to_numpy())


def scipy_labels_of(s: np.ndarray, d: np.ndarray, n: int) -> np.ndarray:
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    adj = coo_matrix((np.ones(len(s), np.int8), (s, d)), shape=(n, n))
    _, lab = connected_components(adj.tocsr(), directed=False)
    _, first = np.unique(lab, return_index=True)  # min id per component
    return first[lab].astype(np.int32)


def live_pairs(L, src, dst) -> int:
    """(edge, target) pairs of a fused sweep that can lower their label:
    the atomics a kernel with one atomic per such pair issues."""
    ls, ld = L[src], L[dst]
    l2s, l2d = L[ls], L[ld]
    z = torch.minimum(l2s, l2d)
    return int((z < ls).sum() + (z < ld).sum() + (z < l2s).sum()
               + (z < l2d).sum())


def sweep_checks(graphs: dict) -> dict:
    """K1 and K2 against their plain versions, and the card's red counts
    against the replays', on small graphs.

    On every graph and state: ``fused_relax`` at edge limits None, 0, 1,
    31, 33 and m // 2, on the edge list and on ``src[1:]``, ``dst[1:]``
    (a base 4 bytes past a 16-byte boundary); ``scatter_min`` on the
    order-1 stream, whole and from its second update, with and without a
    ``valid`` mask.  The counts that depend only on the input (updates
    before the test of the output label, hot slots) must equal the
    replays' exactly; the updates are printed per item beside the
    one-atomic-per-live-update count of the kernels that came before."""
    err = {"fused_relax": 0, "scatter_min": 0}
    checks, counts = 0, {}
    for name, g in graphs.items():
        rows = []
        for i, L in enumerate(c2_states(g, 3)):
            row = {"state": i}
            m = g.n_edges
            for off in (0, 1):
                src, dst = g.src[off:], g.dst[off:]
                for limit in (None, 0, 1, 31, 33, (m - off) // 2):
                    a, c = blocked.fused_relax_sweep(L, src, dst, limit,
                                                     counts=True)
                    b = blocked.fused_relax_plain(L, src, dst, limit)
                    _, want = blocked.fused_relax_combined_replay(
                        L, src, dst, limit)
                    err["fused_relax"] = max(err["fused_relax"],
                                             max_abs_err(a, b))
                    if {key: c[key] for key in want} != want:
                        raise AssertionError(
                            f"fused_relax on {name}, state {i}, offset "
                            f"{off}, limit {limit}: {c} on the card, "
                            f"{want} in the replay")
                    checks += 1
                    if off == 0 and limit is None:
                        row["fused_reds_per_edge"] = \
                            want["reds_before_test"] / m
                        row["fused_hot_slots"] = want["hot_slots"]
                        row["fused_old_per_edge"] = live_pairs(
                            L, g.src, g.dst) / m
            t, v = minmap.mm_update_stream(L, g.src, g.dst, 1)
            valid = torch.arange(t.shape[0], device=t.device) % 3 > 0
            for off in (0, 1):
                for vd in (None, valid[off:]):
                    a, c = blocked.scatter_min_sweep(L, t[off:], v[off:], vd,
                                                     counts=True)
                    b = blocked.scatter_min_plain(L, t[off:], v[off:], vd)
                    _, want = blocked.scatter_min_combined_replay(
                        L, t[off:], v[off:], vd)
                    err["scatter_min"] = max(err["scatter_min"],
                                             max_abs_err(a, b))
                    if {key: c[key] for key in want} != want:
                        raise AssertionError(
                            f"scatter_min on {name}, state {i}: {c} on the "
                            f"card, {want} in the replay")
                    checks += 1
                    if off == 0 and vd is None:
                        k = t.shape[0]
                        row["scatter_reds_per_update"] = \
                            want["reds_before_test"] / k
                        row["scatter_hot_slots"] = want["hot_slots"]
                        row["scatter_old_per_update"] = int(
                            (v < L[t]).sum()) / k
            rows.append(row)
        counts[name] = rows
    sync()
    return {"err": err, "checks": checks, "red_counts": counts}


def per_item(counts: dict, items: int) -> dict:
    """A kernel's counts (``blocked.COUNTERS``) per item; hot slots as
    they are."""
    return {key: (value if key == "hot_slots" else value / items)
            for key, value in counts.items()}


def sweep_times(name, g) -> list:
    """K1 and K2 in each of the four ``c2_states`` at the main path's
    size, as the main path calls them (no wait for the range flag): device
    ms, and per item the counts of ``blocked.COUNTERS`` beside the live
    (target, condition) pairs, each an atomic in the kernels that came
    before the dedupe, the test and the combine."""
    rows = []
    for i, L in enumerate(c2_states(g, 3)):
        t, v = minmap.mm_update_stream(L, g.src, g.dst, 1)
        _, fc = blocked.fused_relax_sweep(L, g.src, g.dst, counts=True)
        _, sc = blocked.scatter_min_sweep(L, t, v, counts=True)
        rows.append({
            "state": i,
            "fused_relax_ms": time_ms(lambda: blocked.fused_relax(
                L, g.src, g.dst, check=False)),
            "scatter_min_ms": time_ms(lambda: blocked.scatter_min(
                L, t, v, check=False)),
            "fused_per_edge": per_item(fc, g.n_edges),
            "fused_old_per_edge": live_pairs(L, g.src, g.dst) / g.n_edges,
            "scatter_per_update": per_item(sc, t.shape[0]),
            "scatter_old_per_update": int((v < L[t]).sum()) / t.shape[0],
        })
        del t, v
    emit({"phase": "sweep_states", "graph": name, "states": rows})
    return rows


def phase_kernels(full: dict, star, small: dict) -> dict:
    """Phase 3: each sweep kernel against its plain version, then its
    times at the main path's sizes.

    ``full`` maps names to the main path's graphs, rmat first: the checks
    and the kernels line's times are on it, the times in every state on
    each.  ``small`` maps names to the graphs of :func:`sweep_checks`."""
    g = next(iter(full.values()))
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
    # the small graphs, slices and edge limits, with the red counts
    small_checks = sweep_checks(small)
    checks += small_checks["checks"]
    for name in err:
        err[name] = max(err[name], small_checks["err"][name])
    if any(err.values()):
        raise AssertionError(f"kernel differs from its plain version: {err}")
    # one endpoint outside [0, n): each kernel raises IndexError
    bad = g.src.clone()
    bad[m // 2] = g.n_vertices
    for call in (lambda: blocked.fused_relax(states[0], bad, g.dst),
                 lambda: blocked.scatter_min(states[0], bad, g.dst)):
        if not raises(call, IndexError):
            raise AssertionError("a kernel took an id outside [0, n)")
        checks += 1
    del bad

    # times at the main path's shapes: the first sweep (identity labels);
    # order 2 for fused_relax (every C-2 sweep), order 1 for scatter_min
    # (C-11mm's warm-up sweeps); called as the main path calls them,
    # without waiting for the range flag; then every state of both graphs
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
    del t1, v1, t1_long
    per_state = {name: sweep_times(name, graph)
                 for name, graph in full.items()}
    for entry, key in ((fused, "fused_relax_ms"), (scatter, "scatter_min_ms")):
        entry["ms_by_state"] = {name: [r[key] for r in rows]
                                for name, rows in per_state.items()}
    sk = int(st.shape[0])
    _, fc = blocked.fused_relax_sweep(sL, star.src, star.dst, counts=True)
    _, sc = blocked.scatter_min_sweep(sL, st, sv, counts=True)
    hub = {
        "graph": f"star({star.n_vertices})", "updates": sk,
        "scatter_min_ms": time_ms(
            lambda: blocked.scatter_min(sL, st, sv, check=False)),
        "scatter_reduce_ms": time_ms(
            lambda: sL.scatter_reduce(0, st.long(), sv, "amin")),
        "fused_relax_ms": time_ms(
            lambda: blocked.fused_relax(sL, star.src, star.dst, check=False)),
        "scatter_per_update": per_item(sc, sk),
        "scatter_old_per_update": int((sv < sL[st]).sum()) / sk,
        "fused_per_edge": per_item(fc, star.n_edges),
        "fused_old_per_edge": live_pairs(sL, star.src, star.dst)
        / star.n_edges,
        **bound(8 * star.n_vertices + 8 * sk, sk),
    }
    hub["scatter_min_x_bound"] = hub["scatter_min_ms"] / hub["bound_ms"]
    emit({"phase": "kernels_vs_plain", "checks": checks,
          "states": len(states), "fused_relax": fused,
          "scatter_min": scatter, "red_counts": small_checks["red_counts"],
          "hub_contention": hub})
    emit({"phase": "contour_hopper", **contour_hopper()})
    return {"fused_relax": fused, "scatter_min": scatter}


def contour_hopper() -> dict:
    """What shows the sweep kernels' design in their SASS on sm_90: the
    warp combine (``MATCH``, and ``REDUX`` for the group's minimum), and
    reds whose result is unused (``REDG``, no ``ATOMG``); raises unless
    both kernels have all three and neither has ``ATOMG``."""
    library = _build.library_path(blocked.LIBRARY, blocked.SOURCES)
    ops = ("MATCH", "REDUX", "REDG", "ATOMG")
    sass = {}
    for name in ("fused_relax_kernel", "scatter_min_kernel"):
        found = sass_counts(library, name, ops)
        if len(found) != 1:
            raise AssertionError(f"{name}: {len(found)} functions in the "
                                 "SASS")
        sass[name] = counts = next(iter(found.values()))
        if not all(counts[op] for op in ops[:3]) or counts["ATOMG"]:
            raise AssertionError(f"{name}'s SASS lacks MATCH, REDUX or "
                                 f"REDG, or issues ATOMG: {counts}")
    return {"sass": sass}


def phase_mm2(small, full) -> dict:
    """Phase 3b: ``mm2`` against ``mm2_plain``, then its times.

    ``small`` and ``full`` map names to graphs.  On the small ones:
    identity labels and one mid-run state, with and without
    ``edge_limit``, in the edge order and reversed; on the unshuffled path
    and the star also at tiny window, depth and cache sizes
    (``MM2_TINY``), where the cache's evictions, the window check's
    refusals and the slow path all fire; an endpoint outside ``[0, n)``
    must raise.
    On the full-size ones (the async path's): the first sweep, where the
    plain Python loop takes seconds, then ``ASYNC_REPS`` timed launches,
    and one launch that counts where the consumer's label reads came
    from, per edge.
    """
    err, checks = 0, 0
    for name, g in small.items():
        sizes = [None] + (MM2_TINY if name in MM2_TINY_ON else [])
        for L in c2_states(g, 1):
            for src, dst in ((g.src, g.dst), (g.src.flip(0), g.dst.flip(0))):
                for limit in (None, g.n_edges // 2 + 1):
                    b = kernel.mm2_plain(L, src, dst, limit)
                    for size in sizes:
                        if size is None:
                            a = kernel.mm2(L, src, dst, edge_limit=limit)
                        else:
                            a = kernel.sweep(L, src, dst, limit,
                                             window=size[0], depth=size[1],
                                             cache_slots=size[2])
                        sync()
                        err = max(err, max_abs_err(a, b))
                        checks += 1
    g = next(iter(small.values()))
    bad = g.src.clone()
    bad[g.n_edges // 2] = g.n_vertices
    L0 = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
    if not raises(lambda: kernel.mm2(L0, bad, g.dst), IndexError):
        raise AssertionError("mm2 took an id outside [0, n)")
    checks += 1
    shapes = {}
    for name, g in full.items():
        L0 = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
        a = kernel.mm2(L0, g.src, g.dst, check=False)
        sync()
        t0 = time.perf_counter()
        b = kernel.mm2_plain(L0, g.src, g.dst)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, max_abs_err(a, b))
        checks += 1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ASYNC_REPS):
            kernel.mm2(L0, g.src, g.dst, check=False)
        end.record()
        sync()
        c, counts = kernel.sweep(L0, g.src, g.dst, counts=True)
        err = max(err, max_abs_err(c, b))
        checks += 1
        n, m = g.n_vertices, g.n_edges
        ms = start.elapsed_time(end) / ASYNC_REPS
        shapes[name] = {
            "shape": {"n": n, "m": m}, "plain_ms": plain_ms, "ms": ms,
            "us_per_edge": ms * 1e3 / m,
            "per_edge": {k: v / m for k, v in counts.items()},
            # read src, dst and L once, write L once; per edge one min for
            # z and four compares
            **bound(8 * m + 8 * n, 5 * m),
        }
        del a, b, c
    if err:
        raise AssertionError(f"mm2 differs from mm2_plain: {err}")
    emit({"phase": "mm2_vs_plain", "checks": checks, "max_abs_err": err,
          "sizes": {"window": kernel.WINDOW, "depth": kernel.DEPTH,
                    "cache_slots": kernel.CACHE_SLOTS, "tiny": MM2_TINY},
          "full_size": shapes})
    first = next(iter(shapes.values()))
    return {"name": "mm2", "route": "cuda", "source": MM2_SOURCE,
            "replaces": REPLACES["mm2"], "max_abs_err": err,
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            # no PyTorch call computes an in-order sequential sweep
            "library_ms": None, "shape": first["shape"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "bytes": first["bytes"], "ops": first["ops"],
            "us_per_edge": first["us_per_edge"],
            "per_edge": first["per_edge"]}


def iteration_parts(g, L) -> dict:
    """Device ms of each step of one C-2 iteration at labels ``L``, as the
    loop enqueues them: the sweep, the jump round and the test that does
    the loop's step (a fresh state before each, untimed); the plain test
    beside it; and a whole iteration enqueued past the fixed point (the
    done word set: the sweep returns, the jump copies, the test skips).
    The jump round is timed with L2 flushed before each call, as the
    sweep before it leaves L2 in the loop."""
    state = cv.loop_state(g.device)
    done = cv.done_word(state)

    def iteration():
        L1 = blocked.fused_relax(L, g.src, g.dst, check=False, done=done)
        L1 = cv.pointer_jump(L1, done)
        cv.converged_early(L1, g.src, g.dst, state=state)

    out = {
        "fused_relax_ms": time_ms(
            lambda: blocked.fused_relax(L, g.src, g.dst, check=False)),
        "pointer_jump_ms": time_each_ms(lambda: cv.pointer_jump(L),
                                        setup=flush_l2),
        "converged_early_ms": time_each_ms(
            lambda: cv.converged_early(L, g.src, g.dst, state=state),
            setup=state.zero_),
        "converged_early_plain_ms": time_ms(
            lambda: cv.converged_early_plain(L, g.src, g.dst)),
    }
    state.fill_(0)
    done.fill_(1)
    out["frozen_iteration_ms"] = time_ms(iteration)
    return out


def replay(g, iters: int, labels=None):
    """The dense C-2 loop's device work for ``iters`` iterations with no
    host read: per iteration the sweep, the jump round and the test with
    the loop's step, then the final jump."""
    L = (torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
         if labels is None else labels)
    state = cv.loop_state(g.device)
    done = cv.done_word(state)
    for _ in range(iters):
        L = ops.mm_relax_backend(L, g.src, g.dst, order=2, backend="cuda",
                                 done=done)
        L = cv.pointer_jump(L, done)
        cv.converged_early(L, g.src, g.dst, state=state)
    return cv.pointer_jump(L)


def loop_cost(g, res) -> dict:
    """A warm C-2 solve against the same device work with no host read.

    :func:`replay` enqueues the solve's iterations back to back.  The
    difference in host-clock time is what the loop's reads of its state
    (one a chunk) and the facade's host work add, beside the iterations
    enqueued past the fixed point.  The replay's device time bounds the
    solve's busy time from above, so ``1 - replay_device_ms / solve_ms``
    bounds the device's idle share inside the solve from below.
    """
    iters = int(res.iterations)
    if not torch.equal(replay(g, iters), res.labels):
        raise AssertionError("the replay does not repeat the solve")
    solve_ms = host_ms(lambda: solve(g))
    replay_ms = host_ms(lambda: replay(g, iters))
    replay_device_ms = time_ms(lambda: replay(g, iters))
    return {"iterations": iters, "chunk": cv.CHUNK, "solve_ms": solve_ms,
            "replay_ms": replay_ms, "replay_device_ms": replay_device_ms,
            "host_reads_ms": solve_ms - replay_ms,
            "host_reads_ms_per_iteration": (solve_ms - replay_ms) / iters,
            "idle_share_at_least": 1 - replay_device_ms / solve_ms}


def chunk_sweep(g, iterations: int) -> dict:
    """The warm C-2 solve at each chunk size k (``converged.CHUNK``):
    host-clock ms (mean of ``REPS``), host syncs, and the reads of the
    loop's state, which must be ceil(iterations / k)."""
    shipped = cv.CHUNK
    out = {}
    try:
        for k in CHUNKS:
            cv.CHUNK = k
            syncs = host_syncs(lambda: solve(g))
            reads = sum(count for site, count in syncs["sites"].items()
                        if site.startswith("converged.py"))
            if reads != -(-iterations // k):
                raise AssertionError(f"chunk {k}: {reads} reads of the "
                                     f"loop's state for {iterations} "
                                     "iterations")
            out[str(k)] = {"warm_ms": host_ms(lambda: solve(g)),
                           "host_syncs": syncs["total"], "loop_reads": reads}
    finally:
        cv.CHUNK = shipped
    return out


def device_idle(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the card's busy time
    (the union of its kernels, copies and sets), the span from the first
    to the last of them, the host wall of the call, and the idle share of
    each."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"device_events": 0, "wall_ms": wall_ms,
                "idle_share": "not measured (no device events traced)"}
    busy, end = 0, spans[0][0]
    for a, b in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    span_ms = (end - spans[0][0]) / 1e6
    return {"device_events": len(spans), "busy_ms": busy / 1e6,
            "span_ms": span_ms, "wall_ms": wall_ms,
            "idle_share_of_span": 1 - busy / 1e6 / span_ms,
            "idle_share_of_wall": 1 - busy / 1e6 / wall_ms}


def drive(g, name: str, variant: str, reference: np.ndarray) -> dict:
    """One main-path solve with the launch counts read around it."""
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, variant=variant)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plain = plain_solve(g, variant=variant)
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
           "host_syncs": host_syncs(lambda: solve(g, variant=variant)),
           "iterations": int(res.iterations),
           "edges_visited": float(res.edges_visited),
           "edges_per_s": float(res.edges_visited) / wall,
           "peak_bytes": peak, "launches": launches,
           "provenance": list(res.provenance or ()),
           "n_components": res.n_components}
    reads = sum(count for site, count in out["host_syncs"]["sites"].items()
                if site.startswith("converged.py"))
    out["loop_reads"] = reads
    if reads > -(-out["iterations"] // cv.CHUNK):
        raise AssertionError(f"{name} {variant}: {reads} reads of the loop's "
                             f"state for {out['iterations']} iterations")
    if variant == "C-2":
        L0 = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
        out["parts_first_iteration"] = iteration_parts(g, L0)
        out["parts_at_fixed_point"] = iteration_parts(g, res.labels)
        out["loop_cost"] = loop_cost(g, res)
        out["chunk_sweep"] = chunk_sweep(g, out["iterations"])
        out["profiled_solve"] = device_idle(lambda: solve(g))
    emit(out)
    out["labels"] = res.labels
    return out


def drive_async(g, name: str, reference: np.ndarray, options: dict,
                on_cpu: bool) -> dict:
    """One ``cuda_async`` solve with the launch counts read around it.

    Its labels must equal scipy's; with ``on_cpu`` the same solve on CPU
    tensors (through ``mm2_plain``) must give the same labels,
    iterations, converged and edges_visited, bit for bit: the in-order
    sweep's result depends on the order of its updates.
    """
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, backend="cuda_async", **options)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not bool(res.converged):
        raise AssertionError(f"{name} cuda_async {options}: not converged")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"{name} cuda_async {options}: labels differ "
                             "from scipy")
    t0 = time.perf_counter()
    solve(g, backend="cuda_async", **options)
    sync()
    wall_warm = time.perf_counter() - t0
    out = {"phase": "async_path", "graph": name, "options": options,
           "n": g.n_vertices, "m": g.n_edges, "wall_s": wall,
           "wall_warm_s": wall_warm, "iterations": int(res.iterations),
           "edges_visited": float(res.edges_visited),
           "edges_per_s": float(res.edges_visited) / wall,
           "peak_bytes": peak, "launches": launches,
           "provenance": list(res.provenance or ()),
           "n_components": res.n_components}
    if on_cpu:
        t0 = time.perf_counter()
        cpu = solve(cpu_copy(g), backend="cuda_async", **options)
        out["cpu_solve_s"] = time.perf_counter() - t0
        same_result(res, cpu, f"{name} cuda_async {options} against CPU "
                    "tensors")
    emit(out)
    return out


def frontier_parts(g) -> dict:
    """Device ms of the frontier's steps at the full edge list, with the
    labels of one C-2 iteration: each strategy's preparation (and the
    two halves of kout's occurrence rank), one general contraction, the
    largest-component filter, the convergence check, and the final
    compression (CUDA events, mean of ``REPS``)."""
    n, m = g.n_vertices, g.n_edges
    L1 = c2_states(g, 1)[1]
    out = {f"prepare_{s}_ms": time_ms(
        lambda s=s: fr.prepare_sampling(s, g.src, g.dst, n))
        for s in SAMPLING_STRATEGIES}
    # kout's preparation is two occurrence ranks: a stable argsort and a
    # cummax over m each
    idx = torch.arange(m, dtype=torch.int64, device=g.device)
    out["occurrence_rank_ms"] = time_ms(lambda: fr._occurrence_rank(g.src))
    out["argsort_stable_ms"] = time_ms(
        lambda: torch.argsort(g.src, stable=True))
    out["cummax_ms"] = time_ms(lambda: torch.cummax(idx, 0))
    out["contract_ms"] = time_ms(
        lambda: fr.contract_edges(L1, g.src, g.dst, m))
    out["largest_component_filter_ms"] = time_ms(
        lambda: fr.contract_edges(L1, g.src, g.dst, m, only_label=(
            fr.largest_component_label(L1, n))))
    out["converged_check_ms"] = time_ms(
        lambda: fr.masked_converged_early(L1, g.src, g.dst, m))
    out["compress_full_ms"] = time_ms(lambda: fr.compress_full(L1))
    return out


def drive_frontier(g, name: str, strategy: str,
                   reference: np.ndarray) -> dict:
    """One frontier solve on the default backend, with the launch counts
    read around it; bit for bit against the ``torch`` backend."""
    options = dict(FRONTIER, sampling_strategy=strategy)
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, **options)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    same_result(res, plain_solve(g, **options),
                f"{name} {options} against the torch backend")
    if not bool(res.converged):
        raise AssertionError(f"{name} {options}: not converged")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"{name} {options}: labels differ from scipy")
    out = {"phase": "frontier_path", "graph": name, "options": options,
           "n": g.n_vertices, "m": g.n_edges, "wall_s": wall,
           "wall_warm_ms": host_ms(lambda: solve(g, **options)),
           "host_syncs": host_syncs(lambda: solve(g, **options)),
           "iterations": int(res.iterations),
           "edges_visited": float(res.edges_visited),
           "edges_per_s": float(res.edges_visited) / wall,
           "peak_bytes": peak, "launches": launches,
           "provenance": list(res.provenance or ())}
    emit(out)
    return out


def witness_at_the_end(g, fixed):
    """Labels that fail the predicate on one vertex only, a label one hop
    from its root (as ``tests/test_torch_cuda.py``'s ``witness_last``):
    the vertex that first appears latest in the edge list, among those of
    components of three or more vertices.  Returns the labels and the
    index of the first edge that is a witness."""
    m, n = g.n_edges, g.n_vertices
    edge = torch.arange(m, device=g.device)
    first = torch.full((n,), m, dtype=torch.long, device=g.device)
    first.scatter_reduce_(0, g.src.long(), edge, "amin")
    first.scatter_reduce_(0, g.dst.long(), edge, "amin")
    size = torch.bincount(fixed.long(), minlength=n)[fixed.long()]
    v = int(torch.where(size >= 3, first, -1).argmax())
    root = int(fixed[v])
    ids = torch.arange(n, device=g.device)
    u = int(torch.nonzero((fixed == root) & (ids != root) & (ids != v))[0])
    L = fixed.clone()
    L[v] = u
    return L, int(first[v])


def phase_converged(full: dict) -> dict:
    """K6 (``converged_early``, ``labels_unchanged``) against its plain
    versions on the card, at the main path's shapes.

    ``full`` maps names to (graph, its C-2 solve's labels), rmat first.
    On each graph, the four C-2 label states and the solve's fixed point:
    the predicate's flag over every edge, over the frontier's prefix
    limits (the sampling prefix m // 4, and m // 2) and m - 1 (a tail of
    m % 4 edges), and on ``src[1:]``, ``dst[1:]`` (not 16-byte aligned:
    the scalar kernel) must equal the plain version's; the no-change
    test's flag on each state against the next (changed) and against a
    copy of itself (unchanged, a full pass) too.  Times: the kernel with
    the loop's step (a fresh state before each call, untimed) against the
    plain version, per state; at the fixed point also right after a
    ``pointer_jump`` of the same labels (the labels as the loop's test
    meets them, which the kernels line quotes) and after an L2 flush; and
    on the first graph a full pass whose only witness is at its end
    (:func:`witness_at_the_end`)."""
    mismatches, checks, rows = [], 0, {}
    first = None
    for name, (g, fixed) in full.items():
        m, n = g.n_edges, g.n_vertices
        states = c2_states(g, 3) + [fixed]
        state = cv.loop_state(g.device)
        per = []
        for i, L in enumerate(states):
            label = i if i < 4 else "fixed"
            for limit in (None, fr.sample_prefix_m(m), m // 2, m - 1):
                got = bool(cv.converged_early(L, g.src, g.dst, limit))
                want = bool(cv.converged_early_plain(L, g.src, g.dst, limit))
                if got != want:
                    mismatches.append(("converged_early", name, label, limit))
                checks += 1
            if (bool(cv.converged_early(L, g.src[1:], g.dst[1:]))
                    != bool(cv.converged_early_plain(L, g.src[1:],
                                                     g.dst[1:]))):
                mismatches.append(("converged_early", name, label, "[1:]"))
            checks += 1
            same = L.clone()
            nxt = states[i + 1] if i + 1 < len(states) else L.flip(0)
            for b in (same, nxt):
                if (bool(cv.labels_unchanged(L, b))
                        != bool(cv.labels_unchanged_plain(L, b))):
                    mismatches.append(("labels_unchanged", name, label))
                checks += 1
            per.append({
                "state": label,
                "converged": bool(cv.converged_early_plain(L, g.src, g.dst)),
                "converged_early_ms": time_each_ms(
                    lambda: cv.converged_early(L, g.src, g.dst, state=state),
                    setup=state.zero_),
                "plain_ms": time_ms(
                    lambda: cv.converged_early_plain(L, g.src, g.dst)),
                "labels_unchanged_ms": time_each_ms(
                    lambda: cv.labels_unchanged(L, same, state=state),
                    setup=state.zero_),
                "labels_unchanged_changed_ms": time_each_ms(
                    lambda: cv.labels_unchanged(L, nxt, state=state),
                    setup=state.zero_),
                "labels_unchanged_plain_ms": time_ms(
                    lambda: cv.labels_unchanged_plain(L, same)),
            })
            del same, nxt
        if per[-1]["converged"] is not True:
            raise AssertionError(f"{name}: the solve's labels fail the "
                                 "predicate")
        # the fixed point as the loop's test meets it: just written by a
        # jump round (a no-op there), and after an L2 flush
        jumped = [fixed]

        def after_jump():
            jumped[0] = cv.pointer_jump(fixed)
            state.zero_()

        per[-1]["converged_early_after_jump_ms"] = time_each_ms(
            lambda: cv.converged_early(jumped[0], g.src, g.dst, state=state),
            setup=after_jump)
        if not torch.equal(jumped[0], fixed):
            raise AssertionError(f"{name}: a jump round moves the fixed "
                                 "point")
        per[-1]["converged_early_flushed_ms"] = time_each_ms(
            lambda: cv.converged_early(fixed, g.src, g.dst, state=state),
            setup=lambda: (flush_l2(), state.zero_()))
        del jumped
        if first is None:
            late, edge = witness_at_the_end(g, fixed)
            if (bool(cv.converged_early(late, g.src, g.dst))
                    or bool(cv.converged_early_plain(late, g.src, g.dst))):
                raise AssertionError(f"{name}: a label one hop from its "
                                     "root passes the predicate")
            checks += 1
            rows[f"{name} witness at edge {edge} of {m}"] = {
                "first_witness_at": edge / m,
                "converged_early_ms": time_each_ms(
                    lambda: cv.converged_early(late, g.src, g.dst,
                                               state=state),
                    setup=state.zero_),
                "flushed_ms": time_each_ms(
                    lambda: cv.converged_early(late, g.src, g.dst,
                                               state=state),
                    setup=lambda: (flush_l2(), state.zero_()))}
            del late
        rows[name] = per
        if first is None:
            fixed_copy = fixed.clone()
            first = {
                "shape": {"n": n, "m": m, "state": "fixed point"},
                "converged_early": {
                    "ms": per[-1]["converged_early_after_jump_ms"],
                    "ms_setting": "fixed point, right after a pointer_jump "
                                  "of the same labels, as in the loop",
                    "warm_ms": per[-1]["converged_early_ms"],
                    "flushed_ms": per[-1]["converged_early_flushed_ms"],
                    "plain_ms": per[-1]["plain_ms"],
                    # read src, dst (8m) and the labels once (4n); per edge
                    # three compares
                    **bound(8 * m + 4 * n, 3 * m)},
                "labels_unchanged": {
                    "ms": per[-1]["labels_unchanged_ms"],
                    "plain_ms": per[-1]["labels_unchanged_plain_ms"],
                    "library_ms": time_ms(
                        lambda: torch.equal(fixed, fixed_copy)),
                    # read both arrays once; one compare an element
                    **bound(8 * n, n)},
            }
            del fixed_copy
    if mismatches:
        raise AssertionError(f"K6 differs from its plain version: "
                             f"{mismatches}")
    emit({"phase": "converged_vs_plain", "checks": checks,
          "states": rows,
          "bounds": {name: first[name]["bound_ms"]
                     for name in ("converged_early", "labels_unchanged")}})
    out = {}
    for name in ("converged_early", "labels_unchanged"):
        out[name] = {"name": name, "route": "cuda",
                     "source": CONVERGED_SOURCE,
                     "replaces": REPLACES[name], "max_abs_err": 0,
                     "library_ms": None, "shape": first["shape"],
                     "ms_by_state": {g: [r[f"{name}_ms"] for r in rows[g]]
                                     for g in rows if g in full},
                     **first[name]}
    return out


def phase_jump(full: dict) -> dict:
    """K7 (``pointer_jump``) against its plain version on the card: in the
    four C-2 label states and at the fixed point of each graph in
    ``full`` (as for :func:`phase_converged`), with the done word absent,
    clear and set; times per state (each call after a flush of L2, as in
    the loop, where the sweep before a jump evicts the labels), the
    kernels line's on the first graph's identity labels."""
    err, checks, rows, first = 0, 0, {}, None
    for name, (g, fixed) in full.items():
        n = g.n_vertices
        word = {d: torch.tensor([d], dtype=torch.int32, device=g.device)
                for d in (0, 1)}
        per = []
        for i, L in enumerate(c2_states(g, 3) + [fixed]):
            for done in (None, word[0], word[1]):
                a = cv.pointer_jump(L, done)
                b = cv.pointer_jump_plain(L, done)
                sync()
                err = max(err, max_abs_err(a, b))
                checks += 1
                del a, b
            per.append({"state": i if i < 4 else "fixed",
                        "ms": time_each_ms(lambda: cv.pointer_jump(L),
                                           setup=flush_l2),
                        "frozen_ms": time_each_ms(
                            lambda: cv.pointer_jump(L, word[1]),
                            setup=flush_l2),
                        "plain_ms": time_each_ms(
                            lambda: cv.pointer_jump_plain(L),
                            setup=flush_l2)})
        rows[name] = per
        if first is None:
            first = {"shape": {"n": n, "state": 0}, "ms": per[0]["ms"],
                     "plain_ms": per[0]["plain_ms"],
                     # read L once and write the output once (the gather
                     # L[L] reads the same input again); one min an element
                     **bound(8 * n, n)}
    if err:
        raise AssertionError(f"pointer_jump differs from its plain "
                             f"version: {err}")
    emit({"phase": "jump_vs_plain", "checks": checks, "states": rows})
    return {"name": "pointer_jump", "route": "cuda", "source":
            CONVERGED_SOURCE, "replaces": REPLACES["pointer_jump"],
            "max_abs_err": err, "library_ms": None,
            "ms_by_state": {g: [r["ms"] for r in rows[g]] for g in rows},
            **first}


def fastsv_freeze_cost(g) -> dict:
    """Device ms of one FastSV iteration from the identity labels as the
    loop enqueues it (the iteration, then the no-change test with the
    loop's step; a fresh state before each call, untimed), with and
    without the freeze that keeps ``(f, gf)`` once the done word is set
    (two ``torch.where`` over n), and of the freeze alone."""
    u = torch.cat([g.src, g.dst])
    v = torch.cat([g.dst, g.src])
    f = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
    state = cv.loop_state(g.device)
    done = cv.done_word(state)

    def bare():
        f1, gf1 = fastsv.iteration(f, f, u, v, done)
        cv.labels_unchanged(gf1, f, state=state)

    def frozen():
        f1, gf1 = fastsv.freeze(done, (f, f),
                                fastsv.iteration(f, f, u, v, done))
        cv.labels_unchanged(gf1, f, state=state)

    new = fastsv.iteration(f, f, u, v, done)
    out = {"iteration_ms": time_each_ms(bare, setup=state.zero_),
           "iteration_with_freeze_ms": time_each_ms(frozen,
                                                    setup=state.zero_),
           "freeze_ms": time_ms(lambda: fastsv.freeze(done, (f, f), new))}
    out["freeze_share"] = 1 - out["iteration_ms"] / out[
        "iteration_with_freeze_ms"]
    return out


def drive_baseline(g, name: str, algorithm: str, reference: np.ndarray,
                   on_cpu: bool, dense_warm_ms=None) -> dict:
    """One solve of a baseline family with the launch counts read around
    it: labels equal to scipy's; with ``on_cpu`` the same solve on CPU
    tensors must give the same labels, iterations and converged."""
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, algorithm=algorithm)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if not bool(res.converged):
        raise AssertionError(f"{name} {algorithm}: not converged")
    if res.labels.device.type != "cuda":
        raise AssertionError(f"{name} {algorithm}: labels on "
                             f"{res.labels.device}")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"{name} {algorithm}: labels differ from scipy")
    if algorithm != "union_find":
        for kernel_name in ("scatter_min", "labels_unchanged"):
            if launches[kernel_name] <= 0:
                raise AssertionError(f"{name} {algorithm} did not launch "
                                     f"{kernel_name}")
    # Rem is a Python loop over the edges: one warm solve
    reps = 1 if algorithm == "union_find" else 3
    t0 = time.perf_counter()
    for _ in range(reps):
        solve(g, algorithm=algorithm)
        sync()
    iters = int(res.iterations)
    out = {"phase": "baseline_path", "graph": name, "algorithm": algorithm,
           "n": g.n_vertices, "m": g.n_edges, "wall_s": wall,
           "wall_warm_ms": (time.perf_counter() - t0) / reps * 1e3,
           "iterations": iters, "converged": bool(res.converged),
           "launches": launches, "n_components": res.n_components}
    # edges swept: every edge once an iteration (a union-find pass is one)
    out["edges_per_s"] = iters * g.n_edges / (out["wall_warm_ms"] / 1e3)
    if dense_warm_ms is None:
        solve(g)
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            solve(g)
            sync()
        dense_warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    out["dense_c2_warm_ms"] = dense_warm_ms
    out["x_dense_c2"] = out["wall_warm_ms"] / dense_warm_ms
    if algorithm != "union_find":
        out["host_syncs"] = host_syncs(
            lambda: solve(g, algorithm=algorithm))["total"]
    if on_cpu:
        t0 = time.perf_counter()
        cpu = solve(cpu_copy(g), algorithm=algorithm)
        out["cpu_solve_s"] = time.perf_counter() - t0
        for field in ("labels", "iterations", "converged"):
            if not torch.equal(getattr(res, field).cpu(), getattr(cpu, field)):
                raise AssertionError(f"{name} {algorithm}: {field} differs "
                                     "from the solve on CPU tensors")
    emit(out)
    return out


def edge_batches(g, batch: int) -> list:
    """The graph's edges in order, as views of its tensors, ``batch`` at
    a time."""
    return [(g.src[i:i + batch], g.dst[i:i + batch])
            for i in range(0, g.n_edges, batch)]


def stream_graph(g, batch: int, count=None, **options):
    """A stream fed the graph's edge batches (the first ``count``)."""
    eng = StreamingConnectivity(g.n_vertices, **options)
    for src, dst in edge_batches(g, batch)[:count]:
        eng.ingest(src, dst, validate=False)
    return eng


def same_state(a: dict, b: dict, what: str) -> None:
    """Two streams' state dicts, key by key, bit for bit."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: keys differ")
    for key, x in a.items():
        y = b[key]
        if isinstance(x, torch.Tensor):
            same = (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x, y.to(x.device)))
        else:
            same = type(x) is type(y) and x == y
        if not same:
            raise AssertionError(f"{what}: {key} differs")


def round_trip(g, batch: int, uninterrupted: dict, what: str,
               **options) -> dict:
    """Half the batches, a checkpoint, a restore onto the card, the rest:
    the state dict must equal the uninterrupted stream's."""
    batches = edge_batches(g, batch)
    half = len(batches) // 2
    with tempfile.TemporaryDirectory(prefix="stream_ckpt_") as directory:
        mgr = CheckpointManager(directory)
        first = stream_graph(g, batch, half, **options)
        sync()
        t0 = time.perf_counter()
        first.save(mgr)
        mgr.wait()
        save_s = time.perf_counter() - t0
        del first
        t0 = time.perf_counter()
        resumed, step = StreamingConnectivity.restore(mgr, **{
            k: v for k, v in options.items() if k != "store_edges"})
        sync()
        restore_s = time.perf_counter() - t0
    if step != half or resumed.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"{what}: restored step {step} on "
                             f"{resumed.device}")
    for src, dst in batches[half:]:
        resumed.ingest(src, dst, validate=False)
    same_state(resumed.state_dict(), uninterrupted,
               f"{what}: restored stream")
    return {"batches": len(batches), "saved_at": half, "save_s": save_s,
            "restore_s": restore_s}


def drive_stream(g, name: str, reference: np.ndarray) -> dict:
    """The streaming path on a main-path graph: its own edges in order,
    ``STREAM_BATCH`` at a time, as device tensors.

    The labels after the last batch must equal scipy's, with every batch
    converged, and ``resolve()`` must leave them as they are; the same
    stream on the ``torch`` backend (plain torch on the card, no kernel)
    must give the same labels and counters bit for bit; the stream must
    have launched the sweep, the test and the jump kernels.  The host's
    reads an ingest are counted on a second run (with ``store_edges=
    False``), which a checkpoint round trip must then reproduce."""
    batches = edge_batches(g, STREAM_BATCH)
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launch_counts()
    eng = StreamingConnectivity(g.n_vertices)
    ms, iterations = [], []
    t_all = time.perf_counter()
    for src, dst in batches:
        before = int(eng.snapshot().iterations)
        t0 = time.perf_counter()
        eng.ingest(src, dst, validate=False)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        iterations.append(int(eng.snapshot().iterations) - before)
    wall = time.perf_counter() - t_all
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in ("fused_relax", "converged_early", "pointer_jump")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"stream {name}: did not launch {missing}")
    snap = eng.snapshot()
    if not bool(snap.converged):
        raise AssertionError(f"stream {name}: not converged")
    if not np.array_equal(snap.labels.cpu().numpy(), reference):
        raise AssertionError(f"stream {name}: labels differ from scipy")
    reset_launch_counts()
    plain = stream_graph(g, STREAM_BATCH, backend="torch")
    launched = {k: v for k, v in launch_counts().items() if v}
    if launched:
        raise AssertionError(f"the torch backend's stream launched "
                             f"kernels: {launched}")
    same_result(snap, plain.snapshot(), f"stream {name} (torch backend)")
    del plain
    reset_launch_counts()
    labels = eng.labels.clone()
    t0 = time.perf_counter()
    eng.resolve()
    sync()
    resolve_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(eng.labels, labels):
        raise AssertionError(f"stream {name}: resolve() changed the labels")
    for k, v in launch_counts().items():
        launches[k] += v
    out = {"phase": "stream_path", "graph": name, "n": g.n_vertices,
           "m": g.n_edges, "batch": STREAM_BATCH, "batches": len(batches),
           "wall_s": wall,
           "ingest_ms": {"p50": float(np.percentile(ms, 50)),
                         "p90": float(np.percentile(ms, 90)),
                         "first": ms[0], "max": max(ms)},
           "edges_per_s": g.n_edges / wall,
           "iterations_per_batch": iterations,
           "iterations": int(snap.iterations),
           "edges_visited": float(snap.edges_visited),
           "resolve_ms": resolve_ms, "peak_bytes": peak,
           "launches": launches, "n_components": eng.n_components,
           "provenance": list(snap.provenance or ())}
    del eng, snap
    held = []
    syncs = host_syncs(lambda: held.append(
        stream_graph(g, STREAM_BATCH, store_edges=False)))
    out["host_syncs_per_ingest"] = syncs["total"] / len(batches)
    out["host_syncs"] = syncs
    out["checkpoint"] = round_trip(g, STREAM_BATCH, held[0].state_dict(),
                                   f"stream {name}", store_edges=False)
    del held
    out["profiled_first_8_batches"] = device_idle(
        lambda: stream_graph(g, STREAM_BATCH, 8))
    emit(out)
    return out


def stream_vs_cpu(g, name: str) -> dict:
    """At the check scale: the stream on the card equals the same stream
    on CPU tensors after every batch, state dict and all, and a
    checkpoint round trip with the edge store reproduces it."""
    sync()
    reset_launch_counts()
    card = StreamingConnectivity(g.n_vertices)
    cpu = StreamingConnectivity(g.n_vertices, device="cpu")
    batches = edge_batches(g, CHECK_STREAM_BATCH)
    t0 = time.perf_counter()
    for i, (src, dst) in enumerate(batches):
        card.ingest(src, dst, validate=False)
        cpu.ingest(src.cpu(), dst.cpu())
        same_state(cpu.state_dict(), card.state_dict(),
                   f"stream {name}, batch {i}: card vs cpu")
    launches = launch_counts()
    out = {"phase": "stream_path", "graph": name, "check": "card_vs_cpu",
           "batch": CHECK_STREAM_BATCH, "batches": len(batches),
           "wall_s": time.perf_counter() - t0, "launches": launches,
           "checkpoint": round_trip(g, CHECK_STREAM_BATCH,
                                    card.state_dict(), f"stream {name}")}
    emit(out)
    return out


class RecordingEngine(ConnectivityEngine):
    """The engine, with every point query's answer kept beside it (the
    future's callback runs where the answer is set)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.answers = []

    def submit_query(self, kind, u=None, v=None, *, timeout=None):
        fut = super().submit_query(kind, u, v, timeout=timeout)
        if kind != "n_components":
            fut.add_done_callback(
                lambda f, q=(kind, u, v): self.answers.append((q, f)))
        return fut


def serve(spec, **engine_kwargs) -> tuple:
    """``run_simulation`` on the card; returns the report, the final
    labels, the launches and the engine."""
    sync()
    reset_launch_counts()
    eng = RecordingEngine(spec.n_vertices, **engine_kwargs)
    try:
        report, labels = run_simulation(spec, engine=eng)
    finally:
        eng.close()
    if eng.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"the engine ran on {eng.device}")
    return report, labels, launch_counts(), eng


def phase_serve() -> list:
    """The serving path: ``run_simulation`` at ``SERVE_SPEC``, its labels
    against scipy and against a ``torch``-backend stream fed the same
    plan, a sample of its answers against the final labels; then the
    recovery run against a clean run of the same spec."""
    t0 = time.perf_counter()
    report, labels, launches, eng = serve(SERVE_SPEC)
    wall = time.perf_counter() - t0
    n_batches = SERVE_SPEC.n_ingest_batches
    if report["failures"] or report["acked_batches"] != n_batches:
        raise AssertionError(f"serve: {report['failures']} failures, "
                             f"{report['acked_batches']} of {n_batches} "
                             f"acked: {report['failure_sample']}")
    plan = make_ingest_plan(SERVE_SPEC)
    src = np.concatenate([s for s, _ in plan])
    dst = np.concatenate([d for _, d in plan])
    if not np.array_equal(labels, scipy_labels_of(src, dst,
                                                  SERVE_SPEC.n_vertices)):
        raise AssertionError("serve: final labels differ from scipy")
    reset_launch_counts()
    plain = StreamingConnectivity(SERVE_SPEC.n_vertices, backend="torch")
    for s, d in plan:
        plain.ingest(s, d)
    if any(launch_counts().values()):
        raise AssertionError("the torch backend's stream launched kernels")
    if not np.array_equal(labels, plain.labels.cpu().numpy()):
        raise AssertionError("serve: final labels differ from the torch "
                             "backend's stream")
    del plain
    rng = np.random.default_rng(0)
    answers = eng.answers
    checked = min(ANSWER_SAMPLE, len(answers))
    wrong = 0
    for i in rng.choice(len(answers), checked, replace=False):
        (kind, u, v), fut = answers[i]
        got = fut.result()
        if kind == "same_component":
            # components only merge: a True stays true
            wrong += bool(got) and labels[u] != labels[v]
        else:
            # labels only decrease
            wrong += got < labels[u]
    if wrong:
        raise AssertionError(f"serve: {wrong} sampled answers contradict "
                             "the final labels")
    out = {"phase": "serve_path", "spec": dataclasses.asdict(SERVE_SPEC),
           "wall_s": wall, "latency_ms": report["latency_ms"],
           "throughput_qps": report["throughput_qps"],
           "ingest_visibility_ms": report["ingest_visibility_ms"],
           "ingest_batches_per_s": report["ingest_batches_per_s"],
           "batch_size_hist": report["batch_size_hist"],
           "queue_depth_hist": report["queue_depth_hist"],
           "counters": report["counters"], "final": report["final"],
           "acked_batches": report["acked_batches"],
           "failures": report["failures"], "answers_checked": checked,
           "launches": launches}
    emit(out)
    del eng, answers

    t0 = time.perf_counter()
    clean, clean_labels, clean_launches, _ = serve(RECOVERY_SPEC)
    with tempfile.TemporaryDirectory(prefix="serve_ckpt_") as directory:
        faulty, faulty_labels, faulty_launches, _ = serve(
            RECOVERY_SPEC, manager=CheckpointManager(directory),
            fault_injector=FaultInjector(fail_at=RECOVERY_FAIL_AT),
            checkpoint_every=RECOVERY_CHECKPOINT_EVERY,
            recoverable=(SimulatedFault,))
    n_batches = RECOVERY_SPEC.n_ingest_batches
    for what, rep in (("clean", clean), ("faulty", faulty)):
        if rep["failures"] or rep["acked_batches"] != n_batches:
            raise AssertionError(f"recovery ({what}): {rep['failures']} "
                                 f"failures, {rep['acked_batches']} of "
                                 f"{n_batches} acked")
    lost = n_batches - faulty["final"]["n_batches"]
    same = np.array_equal(faulty_labels, clean_labels)
    if (faulty["counters"]["restarts"] != len(RECOVERY_FAIL_AT) or lost
            or not same):
        raise AssertionError(
            f"recovery: {faulty['counters']['restarts']} restarts, {lost} "
            f"acknowledged ingests lost, labels equal: {same}")
    recovery = {"phase": "serve_recovery",
                "spec": dataclasses.asdict(RECOVERY_SPEC),
                "fail_at": RECOVERY_FAIL_AT,
                "checkpoint_every": RECOVERY_CHECKPOINT_EVERY,
                "wall_s": time.perf_counter() - t0,
                "restarts": faulty["counters"]["restarts"],
                "replayed_batches": faulty["counters"]["replayed_batches"],
                "checkpoints": faulty["counters"]["checkpoints"],
                "acked_ingest_loss": lost,
                "labels_crc32": faulty["final"]["labels_crc32"],
                "clean_labels_crc32": clean["final"]["labels_crc32"],
                "launches": {k: clean_launches[k] + faulty_launches[k]
                             for k in KERNEL_NAMES}}
    emit(recovery)
    return [out, recovery]


class RoundClock:
    """The parts of each out-of-core round while it is open: host seconds
    of the pads, the folds and the contraction, and the card's time of
    the host-to-device copies (CUDA events on the copy stream around
    each; the copy stream's wait for the fold two chunks back is inside,
    and is over by then, the host having read that fold's results), by
    wrapping the engine's functions."""

    def __init__(self):
        self.rounds = []
        self._saved = []

    def _patch(self, owner, name, wrap):
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))
        setattr(owner, name, wrap(fn))

    def _timed(self, key):
        def wrap(fn):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.rounds[-1][key] += time.perf_counter() - t0
            return timed
        return wrap

    def __enter__(self):
        clock = self

        def wrap_copy(copy):
            def timed_copy(pipe, slot):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(pipe.stream)
                copy(pipe, slot)
                end.record(pipe.stream)
                part = clock.rounds[-1]
                part["copies"].append((start, end))
                part["copy_bytes"] += pipe.host[slot].numel() * 4
            return timed_copy

        def wrap_round(run_round):
            def timed_round(eng):
                clock.rounds.append({"pad_s": 0.0, "fold_s": 0.0,
                                     "contract_s": 0.0, "copies": [],
                                     "copy_bytes": 0})
                t0 = time.perf_counter()
                record = run_round(eng)
                clock.rounds[-1]["round_s"] = time.perf_counter() - t0
                return record
            return timed_round

        self._patch(oocore, "_pad_chunk", self._timed("pad_s"))
        self._patch(oocore, "_fold_chunk", self._timed("fold_s"))
        self._patch(OutOfCoreContraction, "_contract",
                    self._timed("contract_s"))
        self._patch(oocore._ChunkPipeline, "_copy", wrap_copy)
        self._patch(OutOfCoreContraction, "run_round", wrap_round)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []

    def report(self) -> list:
        """Each round's seconds by part; the copies' device seconds and
        GB/s; ``other_s`` is the rest of the round (the chunks' reads or
        generation, the waits on the pinned buffers)."""
        sync()
        out = []
        for part in self.rounds:
            copy_s = sum(a.elapsed_time(b) for a, b in part["copies"]) / 1e3
            out.append({
                "round_s": part["round_s"], "pad_s": part["pad_s"],
                "fold_s": part["fold_s"], "contract_s": part["contract_s"],
                "other_s": part["round_s"] - part["pad_s"] - part["fold_s"]
                - part["contract_s"],
                "copy_s": copy_s, "copy_bytes": part["copy_bytes"],
                "copy_gbps": (part["copy_bytes"] / copy_s / 1e9
                              if copy_s else None)})
        return out


def pinned_copy_gbps() -> float:
    """GB/s of one pinned ``PINNED_PROBE_BYTES`` host-to-device copy,
    timed alone (CUDA events, mean of ``REPS``)."""
    host = torch.zeros(PINNED_PROBE_BYTES // 4, dtype=torch.int32,
                       pin_memory=True)
    dev = torch.empty_like(host, device=DEVICE)
    ms = time_ms(lambda: dev.copy_(host, non_blocking=True))
    return PINNED_PROBE_BYTES / ms / 1e6


def same_round(a: dict, b: dict, what: str) -> None:
    """Two out-of-core state dicts (numpy leaves), key by key, bit for
    bit."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: keys differ")
    for key, x in a.items():
        y = b[key]
        if (x.dtype != y.dtype or x.shape != y.shape
                or not np.array_equal(x, y)):
            raise AssertionError(f"{what}: {key} differs")


def same_finish(a, b, what: str) -> None:
    """Two ``finish()`` 4-tuples (labels, iterations, converged,
    edges_visited), bit for bit."""
    for field, x, y in zip(("labels", "iterations", "converged",
                            "edges_visited"), a, b):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: {field} differs")


def materialized(chunks) -> tuple:
    """A chunk source's graph on the card and scipy's labels of it."""
    g = chunks.materialize(device=DEVICE)
    return g, scipy_labels(g)


def oocore_rounds(eng) -> tuple:
    """Every round of ``eng`` with its state dict after each, then the
    finish."""
    states = []
    while not eng.finished_streaming:
        eng.run_round()
        states.append(eng.state_dict())
    out = eng.finish()
    sync()
    return states, out


def oocore_twin(source, states, out, what: str, **options) -> None:
    """The same run on other terms (``options``) equals ``states`` after
    every round and ``out`` at the end."""
    eng = OutOfCoreContraction(source, **options)
    for i, want in enumerate(states):
        eng.run_round()
        same_round(eng.state_dict(), want, f"{what}, round {i}")
    if not eng.finished_streaming:
        raise AssertionError(f"{what}: more rounds than the card's run")
    same_finish(eng.finish(), out, f"{what}, finish")


def oocore_row(name: str, source, reference, ceiling: float, *,
               twin: bool = False, **options) -> tuple:
    """One out-of-core run on the card, its parts and checks.

    The labels must equal scipy's and the in-core solve's on the card
    (``reference()`` gives the graph on the card and scipy's labels; it
    runs after the peak is read), the survivors must shrink every round,
    and the run must launch the sweep, test and jump kernels.  With
    ``twin`` the same run on the ``torch`` backend (no kernel) must equal
    it after every round and at the end.  Round 0 runs twice more: under
    torch's sync debug mode (host syncs) and under the profiler (the
    card's idle share).  Returns the printed line and the result."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    clock = RoundClock()
    t0 = time.perf_counter()
    with clock:
        eng = OutOfCoreContraction(source, **options)
        states, out = oocore_rounds(eng)
    wall = time.perf_counter() - t0
    peak = oocore.device_peak_bytes()
    launches = launch_counts()
    missing = [k for k in ("fused_relax", "converged_early", "pointer_jump")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"oocore {name}: did not launch {missing}")
    chain = [source.n_edges] + eng.round_counts
    if not all(b < a for a, b in zip(chain, chain[1:])):
        raise AssertionError(f"oocore {name}: survivors {chain} do not "
                             "shrink every round")
    labels, iterations, converged, visited = out
    if not bool(converged):
        raise AssertionError(f"oocore {name}: not converged")
    g, ref = reference()
    if not np.array_equal(labels.cpu().numpy(), ref):
        raise AssertionError(f"oocore {name}: labels differ from scipy")
    if not torch.equal(solve(g).labels, labels):
        raise AssertionError(f"oocore {name}: labels differ from the "
                             "in-core solve")
    del g
    if twin:
        reset_launch_counts()
        oocore_twin(source, states, out, f"oocore {name} (torch backend)",
                    backend="torch", **options)
        if any(launch_counts().values()):
            raise AssertionError("the torch backend's out-of-core run "
                                 "launched kernels")
    del states
    syncs = host_syncs(
        lambda: OutOfCoreContraction(source, **options).run_round())
    idle = device_idle(
        lambda: OutOfCoreContraction(source, **options).run_round())
    parts = clock.report()
    copied = sum(p["copy_bytes"] for p in parts)
    copy_s = sum(p["copy_s"] for p in parts)
    row = {"phase": "oocore_path", "graph": name,
           "n": source.n_vertices, "m": source.n_edges,
           "chunk_edges": source.chunk_edges, "chunks": source.n_chunks,
           "options": options, "wall_s": wall,
           "rounds": len(eng.round_counts), "decay": eng.round_counts,
           "round_cap_exhausted": eng.round_cap_exhausted,
           "provenance": list(eng.provenance()),
           "iterations": int(iterations), "edges_visited": float(visited),
           "round_parts": parts,
           "h2d_bytes": copied,
           "h2d_gbps": copied / copy_s / 1e9 if copy_s else None,
           "pinned_copy_gbps": ceiling,
           "host_syncs_round0": syncs["total"],
           "host_syncs_round0_per_chunk": syncs["total"] / source.n_chunks,
           "host_syncs_sites": syncs["sites"], "idle_round0": idle,
           "peak_bytes": peak, "base_bytes": base,
           "peak_bytes_of_the_run": peak - base,
           "peak_bytes_estimate": eng.peak_bytes_estimate(),
           "edge_list_bytes": oocore.EDGE_BYTES * source.n_edges,
           "peak_above_estimate": peak - base > eng.peak_bytes_estimate(),
           "torch_backend_twin": twin, "launches": launches}
    return row, out


def phase_oocore(rmat_host: tuple, mesh_host: tuple, ref_rmat: np.ndarray,
                 rmat_name: str, mesh_name: str) -> tuple:
    """The out-of-core path (module docstring); returns the printed lines
    and the mesh's result and round count, which the recovery path holds
    its recovered runs against."""
    ceiling = pinned_copy_gbps()
    rows = []

    # stress: rmat(22,16)'s host arrays; no edge list of it on the card
    src, dst, n = rmat_host
    m = int(src.shape[0])
    row, _ = oocore_row(
        rmat_name, gen.ArrayChunks(src, dst, n, OOCORE_CHUNK),
        lambda: (Graph.from_numpy(src, dst, n, device=DEVICE), ref_rmat),
        ceiling, twin=True)
    if row["peak_bytes"] >= oocore.EDGE_BYTES * m:
        raise AssertionError(f"oocore {rmat_name}: peak {row['peak_bytes']}"
                             f" bytes >= the edge list's {8 * m}")
    rows.append(row)
    emit(row)

    # the facade on the graph in core
    g = Graph.from_numpy(src, dst, n, device=DEVICE)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, algorithm="out_of_core", oocore_chunk_edges=OOCORE_CHUNK)
    sync()
    facade_s = time.perf_counter() - t0
    if not np.array_equal(res.labels.cpu().numpy(), ref_rmat):
        raise AssertionError("oocore facade: labels differ from scipy")
    prov = list(res.provenance or ())
    if not (any(e.startswith("oocore:rounds=") for e in prov)
            and any(f"chunk={OOCORE_CHUNK}" in e for e in prov)):
        raise AssertionError(f"oocore facade: provenance {prov}")
    rows.append({"phase": "oocore_path", "graph": rmat_name,
                 "check": "facade", "wall_s": facade_s, "provenance": prov,
                 "launches": launch_counts()})
    emit(rows[-1])
    del g, res

    # generator-fed: the chunks never exist together on the host
    chunks = gen.rmat_chunks(**OOCORE_GENERATED)

    row, _ = oocore_row(
        f"rmat_chunks({OOCORE_GENERATED['scale']},"
        f"{OOCORE_GENERATED['edge_factor']})", chunks,
        lambda: materialized(chunks), ceiling)
    if row["peak_bytes_of_the_run"] >= row["edge_list_bytes"]:
        raise AssertionError(f"oocore generated: peak "
                             f"{row['peak_bytes_of_the_run']} >= "
                             f"{row['edge_list_bytes']}")
    rows.append(row)
    emit(row)

    # the mesh, where more than one round is likeliest
    src, dst, n = mesh_host
    mesh_ref = scipy_labels_of(src, dst, n)
    row, mesh_out = oocore_row(
        mesh_name, gen.ArrayChunks(src, dst, n, OOCORE_MESH_CHUNK),
        lambda: (Graph.from_numpy(src, dst, n, device=DEVICE), mesh_ref),
        ceiling)
    # the fold keeps at most three label arrays (n is 16 buckets here, so
    # the labels dominate): the run's peak within the estimate
    if row["peak_above_estimate"]:
        raise AssertionError(f"oocore {mesh_name}: peak "
                             f"{row['peak_bytes_of_the_run']} above the "
                             f"estimate {row['peak_bytes_estimate']}")
    rows.append(row)
    emit(row)

    # the star forest: at least two rounds, as the reference's gate row
    star = gen.star_forest_chunks(**OOCORE_STAR)
    row, _ = oocore_row(
        f"star_forest({OOCORE_STAR['k']},{OOCORE_STAR['b']})", star,
        lambda: materialized(star), ceiling, oocore_local_iters=1)
    if row["rounds"] < 2:
        raise AssertionError(f"oocore star forest: {row['rounds']} round")
    rows.append(row)
    emit(row)

    # the check scale: the card against CPU tensors after every round
    chunks = gen.rmat_chunks(**OOCORE_CHECK)
    reset_launch_counts()
    t0 = time.perf_counter()
    states, out = oocore_rounds(OutOfCoreContraction(chunks))
    launches = launch_counts()
    oocore_twin(chunks, states, out, "oocore check scale: cpu vs card",
                device="cpu")
    rows.append({"phase": "oocore_path",
                 "graph": f"rmat_chunks({OOCORE_CHECK['scale']},"
                          f"{OOCORE_CHECK['edge_factor']})",
                 "check": "card_vs_cpu", "rounds": len(states),
                 "chunks": chunks.n_chunks,
                 "wall_s": time.perf_counter() - t0, "launches": launches})
    emit(rows[-1])
    return rows, mesh_out, rows[3]["rounds"]


def phase_recovery(mesh_host: tuple, mesh_out: tuple, mesh_rounds: int,
                   stream_host: tuple, mesh_name: str,
                   stream_name: str) -> list:
    """The recovery path: ``oocore_with_recovery`` on the mesh with a
    fault in the middle of round 0 and one at the boundary of round 1
    (on the star forest when the mesh takes one round), against the clean
    runs, and a fresh engine resumed from the last checkpoint; then
    ``stream_with_recovery`` with two faults against the clean stream."""
    rows = []
    src, dst, n = mesh_host
    mesh = gen.ArrayChunks(src, dst, n, OOCORE_MESH_CHUNK)
    star = gen.star_forest_chunks(**OOCORE_STAR)
    runs = [(mesh_name, mesh, {}, mesh_out,
             [(mesh.n_chunks // 2, "oocore_chunk")]
             + ([(1, "oocore_round")] if mesh_rounds > 1 else []))]
    if mesh_rounds == 1:
        star_opts = {"oocore_local_iters": 1}
        star_out = oocore_rounds(OutOfCoreContraction(star, **star_opts))[1]
        runs.append((f"star_forest({OOCORE_STAR['k']},{OOCORE_STAR['b']})",
                     star, star_opts, star_out, [(1, "oocore_round")]))
    for name, source, options, clean, fail_at in runs:
        reset_launch_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="oocore_ckpt_") as directory:
            mgr = CheckpointManager(directory)
            res, stats = oocore_with_recovery(
                source, mgr, fault_injector=FaultInjector(
                    fail_at=tuple(fail_at)), **options)
            sync()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            got = (res.labels, res.iterations, res.converged,
                   res.edges_visited)
            same_finish(got, clean, f"oocore recovery {name}")
            if stats.restarts != len(fail_at) or \
                    stats.replayed_rounds != len(fail_at):
                raise AssertionError(f"oocore recovery {name}: {stats} for "
                                     f"{len(fail_at)} faults")
            resumed = OutOfCoreContraction(source, **options)
            resumed.restore(mgr)
            same_finish(oocore_rounds(resumed)[1], clean,
                        f"oocore recovery {name}: resumed engine")
        rows.append({"phase": "recovery_path", "entry": "oocore_with_recovery",
                     "graph": name, "fail_at": fail_at, "wall_s": wall,
                     "stats": dict(stats), "launches": launches})
        emit(rows[-1])

    src, dst, n = stream_host
    batches = [(src[i:i + STREAM_BATCH], dst[i:i + STREAM_BATCH])
               for i in range(0, src.shape[0], STREAM_BATCH)]
    clean = StreamingConnectivity(n)
    for s, d in batches:
        clean.ingest(s, d)
    reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stream_ckpt_") as directory:
        eng, stats = stream_with_recovery(
            batches, n, CheckpointManager(directory),
            checkpoint_every=STREAM_RECOVERY_CHECKPOINT_EVERY,
            fault_injector=FaultInjector(fail_at=STREAM_RECOVERY_FAIL_AT))
    sync()
    wall = time.perf_counter() - t0
    if stats["restarts"] != len(STREAM_RECOVERY_FAIL_AT):
        raise AssertionError(f"stream recovery: {stats}")
    same_state(eng.state_dict(), clean.state_dict(), "stream recovery")
    rows.append({"phase": "recovery_path", "entry": "stream_with_recovery",
                 "graph": stream_name, "batch": STREAM_BATCH,
                 "batches": len(batches),
                 "fail_at": STREAM_RECOVERY_FAIL_AT,
                 "checkpoint_every": STREAM_RECOVERY_CHECKPOINT_EVERY,
                 "wall_s": wall, "stats": stats,
                 "launches": launch_counts()})
    emit(rows[-1])
    return rows


def fleet_graphs(kind: str) -> list:
    """A fleet's graphs on the host (``device="cpu"``): ``rmat``,
    ``delaunay`` or ``ragged`` (``BATCH_*``)."""
    if kind == "rmat":
        return [gen.rmat(BATCH_RMAT["scale"], edge_factor=RMAT_EDGE_FACTOR,
                         seed=i, device="cpu")
                for i in range(BATCH_RMAT["count"])]
    if kind == "delaunay":
        # delaunay_like is a grid: every seed gives the same graph
        one = gen.delaunay_like(BATCH_DELAUNAY["scale"], device="cpu")
        return [one] * BATCH_DELAUNAY["count"]
    lo, hi = BATCH_RAGGED["scales"]
    scales = np.random.default_rng(BATCH_SEED).integers(
        lo, hi + 1, BATCH_RAGGED["count"])
    make = (lambda s, i: gen.rmat(s, edge_factor=RMAT_EDGE_FACTOR, seed=i,
                                  device="cpu"),
            lambda s, i: gen.path(1 << s, seed=i, device="cpu"),
            lambda s, i: gen.delaunay_like(s, device="cpu"),
            lambda s, i: gen.star(1 << s, seed=i, device="cpu"))
    return [make[i % 4](int(s), i) for i, s in enumerate(scales)]


def fleet_name(kind: str) -> str:
    if kind == "rmat":
        return (f"{BATCH_RMAT['count']} x rmat({BATCH_RMAT['scale']},"
                f"{RMAT_EDGE_FACTOR})")
    if kind == "delaunay":
        return (f"{BATCH_DELAUNAY['count']} x "
                f"delaunay_like({BATCH_DELAUNAY['scale']})")
    lo, hi = BATCH_RAGGED["scales"]
    return (f"ragged {BATCH_RAGGED['count']} x 2^{lo}..2^{hi} "
            "(rmat, path, grid, star)")


def on_card(g) -> Graph:
    return Graph(src=g.src.to(DEVICE), dst=g.dst.to(DEVICE),
                 n_vertices=g.n_vertices)


def drive_fleet(kind: str) -> tuple:
    """One fleet through ``solve_batch`` on the card: labels of every lane
    equal scipy's, the ``torch`` backend's fleet bit for bit (launching no
    kernel), the loop of solo solves lane for lane; cold and warm walls,
    the solo loop's wall, iterations, host syncs, launches and the card's
    idle share.  Returns the printed line and the batched graph."""
    t0 = time.perf_counter()
    graphs = fleet_graphs(kind)
    host, sizes = stack_graphs(graphs, with_sizes=True)
    refs, seen = [], {}
    for g in graphs:
        if id(g) not in seen:
            seen[id(g)] = scipy_labels_of(*g.to_numpy())
        refs.append(seen[id(g)])
    batched = on_card(host)
    solo = [on_card(g) for g in graphs]
    setup_s = time.perf_counter() - t0
    lanes_b, m_pad = (int(x) for x in batched.src.shape)
    name = fleet_name(kind)

    def run(**options):
        return solve_batch(batched, batch_sizes=sizes, **options)

    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run()
    sync()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    for k in ("fused_relax_batched", "converged_early_batched",
              "pointer_jump_batched"):
        if launches[k] <= 0:
            raise AssertionError(f"{name}: did not launch {k}")
    single = {k: v for k, v in launches.items()
              if v and not k.endswith("_batched")}
    if single:
        raise AssertionError(f"{name}: the fleet launched {single}")
    if not bool(res.converged.all()):
        raise AssertionError(f"{name}: a lane did not converge")
    for i, lane in enumerate(res.unstack()):
        if not np.array_equal(lane.labels.cpu().numpy(), refs[i]):
            raise AssertionError(f"{name}: lane {i} differs from scipy")
    warm_ms = host_ms(run) if lanes_b * m_pad < (1 << 26) else None
    if warm_ms is None:
        t0 = time.perf_counter()
        for _ in range(3):
            run()
            sync()
        warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    reset_launch_counts()
    t0 = time.perf_counter()
    plain = run(backend="torch")
    sync()
    plain_cold_ms = (time.perf_counter() - t0) * 1e3
    if any(launch_counts().values()):
        raise AssertionError(f"{name}: the torch backend's fleet launched "
                             f"{launch_counts()}")
    same_result(res, plain, f"{name}: the torch backend's fleet")
    t0 = time.perf_counter()
    run(backend="torch")
    sync()
    plain_warm_ms = (time.perf_counter() - t0) * 1e3
    # the loop of solo solves, each graph as it is (its own n and m)
    for g in solo[:2]:
        solve(g)
    sync()
    t0 = time.perf_counter()
    outs = [solve(g) for g in solo]
    sync()
    solo_ms = (time.perf_counter() - t0) * 1e3
    its = res.iterations.cpu()
    for i, (one, lane) in enumerate(zip(outs, res.unstack())):
        if int(one.iterations) != int(its[i]) or not torch.equal(
                one.labels, lane.labels):
            raise AssertionError(f"{name}: lane {i} differs from its solo "
                                 "solve")
    del outs
    syncs = host_syncs(run)
    idle = device_idle(run)
    real_m = sum(g.n_edges for g in graphs)
    row = {"phase": "batch_path", "fleet": name, "B": lanes_b,
           "n_pad": batched.n_vertices, "m_pad": m_pad,
           "labels": lanes_b * batched.n_vertices,
           "sum_n": sum(sizes), "padded_edges": lanes_b * m_pad,
           "real_edges": real_m,
           "padding_x": lanes_b * m_pad / max(real_m, 1),
           "batched_cold_ms": cold_ms, "batched_warm_ms": warm_ms,
           "solo_loop_ms": solo_ms,
           "solo_over_batched": solo_ms / warm_ms,
           "torch_backend_cold_ms": plain_cold_ms,
           "torch_backend_warm_ms": plain_warm_ms,
           "iterations_max": int(its.max()),
           "iterations_mean": float(its.float().mean()),
           "host_syncs": syncs["total"], "host_syncs_sites": syncs["sites"],
           "profiled": idle, "launches": launches,
           "provenance": list(res.provenance or ()),
           "setup_s": setup_s}
    emit(row)
    return row, batched, sizes


def fleet_check_scale() -> dict:
    """Eight small graphs and a lane warm-started with an edge-free chain
    (it changes if the lane is not frozen once its test passes): the
    card's fleet against the CPU's, bit for bit, in every variant."""
    def fleet(device):
        gs = [gen.rmat(8, edge_factor=RMAT_EDGE_FACTOR, seed=1,
                       device=device),
              gen.path(200, seed=2, device=device),
              gen.grid2d(12, 20, device=device),
              gen.star(100, seed=3, device=device),
              gen.rmat(7, edge_factor=4, seed=4, device=device),
              gen.path(50, seed=5, device=device),
              gen.grid2d(5, 5, device=device),
              gen.star(64, seed=6, device=device)]
        n = max(g.n_vertices for g in gs)
        warm = [torch.arange(g.n_vertices, dtype=torch.int32, device=device)
                for g in gs]
        chain = torch.arange(n, dtype=torch.int32, device=device)
        chain[100:] -= 1
        warm[6] = chain
        return gs, warm

    card, card_warm = fleet(DEVICE)
    cpu, cpu_warm = fleet("cpu")
    checks = 0
    reset_launch_counts()
    for variant in contour.VARIANTS + ("C-3",):
        for warm in (False, True):
            a = solve_batch(card, variant=variant,
                            warm_start=card_warm if warm else None)
            b = solve_batch(cpu, variant=variant,
                            warm_start=cpu_warm if warm else None)
            same_result(a, b, f"fleet check scale {variant} warm={warm}: "
                              "card vs cpu")
            checks += 1
    out = {"phase": "batch_path", "check": "card_vs_cpu", "B": len(card),
           "cases": checks, "launches": launch_counts()}
    emit(out)
    return out


def fleet_kernels(batched: Graph, fixed: torch.Tensor) -> dict:
    """The fleet's entry points against their plain versions on the rmat
    fleet (identity labels, one C-2 iteration, the fixed point; no lane
    frozen, and every other lane frozen), and their entries of the
    kernels line: times at the first sweep (K1, K2's order-1 stream), the
    fixed point (K6's full passes) and K7 after an L2 flush."""
    lanes_b, m = (int(x) for x in batched.src.shape)
    n = batched.n_vertices
    src, dst = batched.src, batched.dst
    off = blocked.lane_offsets(lanes_b, n, DEVICE)
    L0 = (torch.arange(n, dtype=torch.int32, device=DEVICE)
          .expand(lanes_b, n) + off).reshape(-1).contiguous()
    L1 = cv.pointer_jump_batched_plain(
        blocked.fused_relax_batched_plain(L0, src, dst, n), n)
    Lf = (fixed + off).reshape(-1).contiguous()
    half = torch.zeros((lanes_b, 4), dtype=torch.int32, device=DEVICE)
    half[1::2, cv.DONE] = 1
    err = Counter()
    checks = 0
    for L in (L0, L1, Lf):
        for lanes in (None, half):
            err["fused_relax_batched"] = max(
                err["fused_relax_batched"], max_abs_err(
                    blocked.fused_relax_batched(L, src, dst, n, lanes),
                    blocked.fused_relax_batched_plain(L, src, dst, n,
                                                      lanes)))
            t, v = contour.mm_update_stream_batched(L, src, dst, n, 1)
            err["scatter_min_batched"] = max(
                err["scatter_min_batched"], max_abs_err(
                    blocked.scatter_min_batched(L, t, v, n, lanes),
                    blocked.scatter_min_batched_plain(L, t, v, n, lanes)))
            del t, v
            err["pointer_jump_batched"] = max(
                err["pointer_jump_batched"], max_abs_err(
                    cv.pointer_jump_batched(L, n, lanes),
                    cv.pointer_jump_batched_plain(L, n, lanes)))
            jumped = cv.pointer_jump_batched_plain(L, n)
            for key, fn, plain, args in (
                    ("converged_early_batched", cv.converged_early_batched,
                     cv.converged_early_batched_plain, (L, src, dst, n)),
                    ("labels_unchanged_batched", cv.labels_unchanged_batched,
                     cv.labels_unchanged_batched_plain, (jumped, L, n))):
                a = cv.fleet_state(lanes_b, DEVICE)
                b = cv.fleet_state(lanes_b, DEVICE)
                if lanes is not None:
                    a.lanes.copy_(lanes)
                    b.lanes.copy_(lanes)
                fn(*args, a)
                plain(*args, b)
                err[key] = max(err[key], max_abs_err(a.lanes, b.lanes),
                               max_abs_err(a.fleet[:2], b.fleet[:2]))
            del jumped
            checks += 1
    sync()
    if any(err.values()):
        raise AssertionError(f"the fleet's kernels differ from their plain "
                             f"versions: {dict(err)}")
    t1, v1 = contour.mm_update_stream_batched(L0, src, dst, n, 1)
    t1_long = t1.long()
    k = int(t1.shape[0])
    state = cv.fleet_state(lanes_b, DEVICE)

    def fresh():
        state.lanes.zero_()
        state.fleet.zero_()

    Lf_copy = Lf.clone()
    shape = {"B": lanes_b, "n": n, "m": m, "labels": lanes_b * n}
    entries = {
        "fused_relax_batched": {
            "source": SOURCE, "state": "identity (the first sweep)",
            "ms": time_ms(lambda: blocked.fused_relax_batched(L0, src, dst,
                                                              n)),
            "plain_ms": time_ms(lambda: blocked.fused_relax_batched_plain(
                L0, src, dst, n)),
            "library_ms": None,
            **bound(8 * lanes_b * n + 8 * lanes_b * m, 5 * lanes_b * m)},
        "scatter_min_batched": {
            "source": SOURCE, "state": "identity, order-1 stream",
            "updates": k,
            "ms": time_ms(lambda: blocked.scatter_min_batched(L0, t1, v1,
                                                              n)),
            "plain_ms": time_ms(lambda: blocked.scatter_min_batched_plain(
                L0, t1, v1, n)),
            "library_ms": time_ms(
                lambda: L0.scatter_reduce(0, t1_long, v1, "amin")),
            **bound(8 * lanes_b * n + 8 * k, k)},
        "converged_early_batched": {
            "source": CONVERGED_SOURCE, "state": "fixed point, every lane",
            "ms": time_each_ms(lambda: cv.converged_early_batched(
                Lf, src, dst, n, state), setup=fresh),
            "plain_ms": time_each_ms(lambda: cv.converged_early_batched_plain(
                Lf, src, dst, n, state), setup=fresh),
            "library_ms": None,
            **bound(8 * lanes_b * m + 4 * lanes_b * n, 3 * lanes_b * m)},
        "labels_unchanged_batched": {
            "source": CONVERGED_SOURCE, "state": "fixed point, every lane",
            "ms": time_each_ms(lambda: cv.labels_unchanged_batched(
                Lf, Lf_copy, n, state), setup=fresh),
            "plain_ms": time_each_ms(
                lambda: cv.labels_unchanged_batched_plain(
                    Lf, Lf_copy, n, state), setup=fresh),
            "library_ms": None,
            **bound(8 * lanes_b * n, lanes_b * n)},
        "pointer_jump_batched": {
            "source": CONVERGED_SOURCE, "state": "identity, L2 flushed",
            "ms": time_each_ms(lambda: cv.pointer_jump_batched(L0, n),
                               setup=flush_l2),
            "plain_ms": time_each_ms(
                lambda: cv.pointer_jump_batched_plain(L0, n),
                setup=flush_l2),
            "library_ms": None,
            **bound(8 * lanes_b * n, lanes_b * n)},
    }
    emit({"phase": "batch_kernels_vs_plain", "checks": checks,
          "shape": shape,
          "times": {k: {f: e[f] for f in ("ms", "plain_ms", "library_ms",
                                          "bound_ms")}
                    for k, e in entries.items()}})
    return {name: {"name": name, "route": "cuda",
                   "replaces": REPLACES[name], "max_abs_err": err[name],
                   "shape": shape, **entry}
            for name, entry in entries.items()}


def phase_batch() -> tuple:
    """The fleet path (module docstring); returns the printed lines and
    the kernels line's entries of the fleet's entry points."""
    rows = []
    row, batched, sizes = drive_fleet("rmat")
    rows.append(row)
    # the order-1 sweeps: C-11mm's warm-up runs K2's fleet entry point
    reset_launch_counts()
    res = solve_batch(batched, batch_sizes=sizes, variant="C-11mm")
    sync()
    launches = launch_counts()
    if launches["scatter_min_batched"] <= 0:
        raise AssertionError("the fleet's C-11mm did not launch "
                             "scatter_min_batched")
    same_result(res, solve_batch(batched, batch_sizes=sizes,
                                 variant="C-11mm", backend="torch"),
                "the fleet's C-11mm against the torch backend's")
    rows.append({"phase": "batch_path", "fleet": row["fleet"],
                 "variant": "C-11mm", "launches": launches,
                 "iterations_max": int(res.iterations.max())})
    emit(rows[-1])
    fixed = solve_batch(batched).labels
    kernels = fleet_kernels(batched, fixed)
    del batched, fixed, res
    for kind in ("delaunay", "ragged"):
        row, batched, _ = drive_fleet(kind)
        rows.append(row)
        del batched
    rows.append(fleet_check_scale())
    return rows, kernels


def drive_auto(g, name: str, reference: np.ndarray, dense_ms: float) -> dict:
    """``solve(g, algorithm="auto")`` on the card: the cost model's choice
    and the skew computed where the edges lie, labels equal to scipy's,
    the wall beside dense C-2's."""
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, algorithm="auto")
    sync()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"auto {name}: labels differ from scipy")
    skew = device_degree_skew(g.src, g.dst, g.n_vertices)
    t0 = time.perf_counter()
    for _ in range(3):
        solve(g, algorithm="auto")
        sync()
    warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    out = {"phase": "auto_path", "graph": name, "n": g.n_vertices,
           "m": g.n_edges, "choice": res.provenance[0],
           "provenance": list(res.provenance), "degree_skew": skew,
           "avg_degree": 2 * g.n_edges / g.n_vertices,
           "skew_ms": host_ms(lambda: device_degree_skew(
               g.src, g.dst, g.n_vertices)),
           "auto_cold_ms": cold_ms, "auto_warm_ms": warm_ms,
           "dense_c2_warm_ms": dense_ms, "x_dense_c2": warm_ms / dense_ms,
           "iterations": int(res.iterations),
           "host_syncs": host_syncs(
               lambda: solve(g, algorithm="auto"))["total"],
           "launches": launches}
    emit(out)
    return out


def drive_autotune(g, name: str, reference: np.ndarray) -> dict:
    """``planner.autotune`` on ``g`` into a cache under a temporary
    ``REPRO_TORCH_TUNING_CACHE``: its timings table, then one solve that
    records ``origin=tuned``."""
    env = planner.cache.ENV_CACHE_PATH
    saved = os.environ.get(env)
    with tempfile.TemporaryDirectory() as d:
        os.environ[env] = str(Path(d) / "tuning.json")
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            plan, timings = planner.autotune(g)
            tune_s = time.perf_counter() - t0
            res = solve(g, sampling=2, compact_every=2)
            sync()
            launches = launch_counts()
            entry = planner.cache.entries()
        finally:
            if saved is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = saved
    if not res.provenance[0].startswith(f"plan:{plan.backend} origin=tuned"):
        raise AssertionError(f"autotune {name}: the solve after tuning "
                             f"recorded {res.provenance[0]}")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"autotune {name}: labels differ from scipy")
    out = {"phase": "auto_path", "graph": name, "check": "autotune",
           "timings_s": timings, "winner": planner.plan_label(plan),
           "tune_s": tune_s, "provenance": list(res.provenance),
           "cache_keys": sorted(entry), "launches": launches}
    emit(out)
    return out


def float_err(a: torch.Tensor, b: torch.Tensor, tol: tuple) -> dict:
    """Kernel output ``a`` against plain output ``b`` in float32, ``tol`` =
    (atol, rtol, rms_rel): max |a - b|, how far the worst element lies past
    ``atol + rtol * |b|`` (<= 0 when every element is inside), and
    rms(a - b) / rms(b) beside its limit ``rms_rel``."""
    atol, rtol, rms_rel = tol
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return {"max_abs_err": float(diff.max()),
            "excess": float((diff - atol - rtol * b.abs()).max()),
            "rel_rms_err": float(diff.square().mean().sqrt()
                                 / b.square().mean().sqrt()),
            "rel_rms_limit": rms_rel,
            "finite": bool(torch.isfinite(a).all())}


def check_close(what: str, err: dict) -> None:
    if (not err["finite"] or err["excess"] > 0
            or not err["rel_rms_err"] <= err["rel_rms_limit"]):
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version: {err}")


def randn(shape, dtype, gen_) -> torch.Tensor:
    return torch.randn(shape, device=DEVICE, generator=gen_).to(dtype)


def rmsnorm_bound(rows: int, d: int, dtype) -> dict:
    # read x, write y, read w (float32); per element a square-add, a
    # scale and a weight product
    size = torch.finfo(dtype).bits // 8
    return bound(2 * rows * d * size + 4 * d, 4 * rows * d)


def flash_bound(b, h, hkv, t, s, hd, causal, dtype) -> dict:
    # q, k, v read once, o written once; two products of 2 * T * S * hd
    # operations a head, half of them past the diagonal when causal
    size = torch.finfo(dtype).bits // 8
    ops = 4 * b * h * t * s * hd // (2 if causal else 1)
    rate = (BF16_TENSOR_OPS_PER_S if dtype in (torch.bfloat16, torch.float16)
            else ALU_OPS_PER_S)
    return bound(size * hd * (2 * b * h * t + 2 * b * hkv * s), ops, rate)


def phase_rmsnorm_vs_plain() -> dict:
    """``rmsnorm_rows`` against ``rmsnorm_rows_plain`` on the card."""
    gen_ = torch.Generator(device=DEVICE).manual_seed(0)
    cases = [
        # mistral-nemo-12b's d_model over 8 x 4096 tokens
        ("nemo", 32768, NEMO["d"], torch.bfloat16, torch.bfloat16),
        # yi-6b's d_model, a ragged row count
        ("yi", 4095, 4096, torch.float32, torch.float32),
        ("small", 7, 128, torch.float32, torch.float32),
        ("bf16_x_f32_w", 4096, NEMO["d"], torch.bfloat16,
         torch.float32),
        ("nemo_f16", 32768, NEMO["d"], torch.float16, torch.float16),
        ("f16_x_f32_w", 4095, 4096, torch.float16, torch.float32),
    ]
    out, worst = {}, 0.0
    for name, rows, d, x_dtype, w_dtype in cases:
        x = randn((rows, d), x_dtype, gen_)
        w = randn((d,), w_dtype, gen_)
        a = rms_kernel.rmsnorm_rows(x, w)
        b = rms_kernel.rmsnorm_rows_plain(x, w)
        sync()
        err = float_err(a, b, RMS_TOL[x_dtype])
        check_close(f"rmsnorm_rows {name}", err)
        worst = max(worst, err["max_abs_err"])
        out[name] = {"shape": [rows, d], "x": str(x_dtype),
                     "w": str(w_dtype), **err}
        del x, w, a, b
    emit({"phase": "rmsnorm_vs_plain", "checks": len(cases), "cases": out,
          "max_abs_err": worst})
    return {"max_abs_err": worst}


def phase_flash_vs_plain() -> dict:
    """``flash_mha`` against ``flash_mha_plain`` on the card, and the
    inputs it must refuse."""
    gen_ = torch.Generator(device=DEVICE).manual_seed(1)
    H, Hkv, hd = NEMO["H"], NEMO["Hkv"], NEMO["hd"]
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # (name, b, h, hkv, t, s, hd, causal, dtype)
        ("nemo_causal", 2, H, Hkv, 4096, 4096, hd, True, bf16),
        ("nemo", 2, H, Hkv, 4096, 4096, hd, False, bf16),
        ("nemo_ragged", 2, H, Hkv, 4000, 4000, hd, True, bf16),
        ("nemo_t1024_s4096", 2, H, Hkv, 1024, 4096, hd, True, bf16),
        # zamba2-2.7b and xlstm-125m's heads
        ("zamba2_hd80", 2, 32, 32, 1024, 1024, 80, True, bf16),
        ("xlstm_hd192", 2, 4, 4, 1024, 1024, 192, True, bf16),
        ("mqa", 2, H, 1, 1024, 1024, hd, True, bf16),
        ("nemo_f32", 2, H, Hkv, 512, 512, hd, True, f32),
        ("nemo_causal_f16", 2, H, Hkv, 4096, 4096, hd, True, f16),
        ("nemo_ragged_f16", 2, H, Hkv, 4000, 4000, hd, True, f16),
        ("xlstm_hd192_f16", 2, 4, 4, 1024, 1024, 192, True, f16),
        ("zamba2_hd80_f16", 2, 32, 32, 1024, 1024, 80, False, f16),
    ]
    out, worst = {}, 0.0
    for name, b, h, hkv, t, s, d, causal, dtype in cases:
        q = randn((b, h, t, d), dtype, gen_)
        k = randn((b, hkv, s, d), dtype, gen_)
        v = randn((b, hkv, s, d), dtype, gen_)
        a = flash_kernel.flash_mha(q, k, v, causal=causal)
        sync()
        ref = flash_kernel.flash_mha_plain(q, k, v, causal=causal)
        sync()
        err = float_err(a, ref, FLASH_TOL[dtype])
        check_close(f"flash_mha {name}", err)
        worst = max(worst, err["max_abs_err"])
        out[name] = {"shape": [b, h, hkv, t, s, d], "causal": causal,
                     "dtype": str(dtype), **err}
        del q, k, v, a, ref
    torch.cuda.empty_cache()
    # inputs the kernel does not take raise before any launch; a launch
    # held to the 48 KB of shared memory it gets without asking is refused
    # and raises
    q = randn((1, 4, 64, 128), bf16, gen_)
    kv = randn((1, 2, 64, 128), bf16, gen_)
    bad = randn((1, 2, 8, 260), bf16, gen_)
    # a contiguous view one element into a buffer: not 16-byte aligned
    q_offset = randn((q.numel() + 1,), bf16, gen_)[1:].view(q.shape)
    refused = [
        ("hd260", lambda: flash_kernel.flash_mha(bad, bad, bad), ValueError),
        ("h_not_multiple", lambda: flash_kernel.flash_mha(
            q[:, :3].contiguous(), kv, kv), ValueError),
        ("cpu_mixed", lambda: flash_kernel.flash_mha(q, kv.cpu(), kv),
         ValueError),
        ("misaligned", lambda: flash_kernel.flash_mha(q_offset, kv, kv),
         ValueError),
        ("smem_48k", lambda: flash_kernel.launch(
            q, kv, kv, torch.empty_like(q), True, 48 * 1024), RuntimeError),
    ]
    for name, call, error in refused:
        if not raises(call, error):
            raise AssertionError(f"flash_mha took {name}")
    emit({"phase": "flash_vs_plain", "checks": len(cases) + len(refused),
          "cases": out, "refused": [r[0] for r in refused],
          "max_abs_err": worst})
    return {"max_abs_err": worst}


def path_run(name: str, fn) -> tuple:
    """``fn()`` once with every launch count set to 0 just before and read
    just after; returns its output and the counts."""
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    y = fn()
    sync()
    wall = time.perf_counter() - t0
    return y, {"phase": name, "wall_s": wall, "launches": launch_counts()}


def phase_rmsnorm_path() -> dict:
    """``fused_rmsnorm(x, w)`` at mistral-nemo-12b's width over 8 x 4096
    tokens, bfloat16, with its times beside its
    bound, its plain version and ``torch.nn.functional.rms_norm`` (timed
    only)."""
    gen_ = torch.Generator(device=DEVICE).manual_seed(2)
    d = NEMO["d"]
    x = randn((8, 4096, d), torch.bfloat16, gen_)
    w = randn((d,), torch.bfloat16, gen_)
    y, run = path_run("rmsnorm_path", lambda: fused_rmsnorm(x, w))
    if run["launches"]["rmsnorm_rows"] <= 0:
        raise AssertionError("fused_rmsnorm did not launch rmsnorm_rows")
    if y.shape != x.shape or y.dtype != x.dtype:
        raise AssertionError(f"fused_rmsnorm gave {y.dtype} {y.shape}")
    err = float_err(y, rmsnorm_ref(x, w), RMS_TOL[x.dtype])
    check_close("fused_rmsnorm", err)
    rows = x.numel() // d
    run.update({
        "shape": {"rows": rows, "d": d, "dtype": "bfloat16"}, **err,
        "ms": time_ms(lambda: fused_rmsnorm(x, w)),
        "plain_ms": time_ms(lambda: fused_rmsnorm(x, w, backend="torch")),
        "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
            x, (d,), w, eps=1e-5)),
        **rmsnorm_bound(rows, d, x.dtype)})
    # the same call in float16
    x, w = x.half(), w.half()
    y = fused_rmsnorm(x, w)
    if y.dtype != torch.float16:
        raise AssertionError(f"fused_rmsnorm gave {y.dtype} for float16")
    err = float_err(y, rmsnorm_ref(x, w), RMS_TOL[x.dtype])
    check_close("fused_rmsnorm float16", err)
    run["float16"] = {
        **err, "ms": time_ms(lambda: fused_rmsnorm(x, w)),
        "plain_ms": time_ms(lambda: fused_rmsnorm(x, w, backend="torch")),
        "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
            x, (d,), w, eps=1e-5)),
        **rmsnorm_bound(rows, d, x.dtype)}
    emit(run)
    return run


def phase_flash_path() -> dict:
    """``flash_attention(q, k, v)`` (causal) at mistral-nemo-12b's heads
    over 2 x 4096 tokens, bfloat16, with its times
    beside its bound, its plain version and
    ``scaled_dot_product_attention`` (timed only)."""
    gen_ = torch.Generator(device=DEVICE).manual_seed(3)
    b, t, H, Hkv, hd = 2, 4096, NEMO["H"], NEMO["Hkv"], NEMO["hd"]
    q = randn((b, H, t, hd), torch.bfloat16, gen_)
    k = randn((b, Hkv, t, hd), torch.bfloat16, gen_)
    v = randn((b, Hkv, t, hd), torch.bfloat16, gen_)
    o, run = path_run("flash_path", lambda: flash_attention(q, k, v))
    if run["launches"]["flash_mha"] <= 0:
        raise AssertionError("flash_attention did not launch flash_mha")
    if o.shape != q.shape or o.dtype != q.dtype:
        raise AssertionError(f"flash_attention gave {o.dtype} {o.shape}")
    err = float_err(o, mha_ref(q, k, v), FLASH_TOL[q.dtype])
    check_close("flash_attention", err)
    del o
    torch.cuda.empty_cache()
    run.update({
        "shape": {"B": b, "H": H, "Hkv": Hkv, "T": t, "S": t, "hd": hd,
                  "causal": True, "dtype": "bfloat16"}, **err,
        "ms": time_ms(lambda: flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: flash_attention(q, k, v,
                                                    backend="torch")),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)),
        "smem_bytes": flash_kernel.smem_bytes(hd, q.dtype),
        **flash_bound(b, H, Hkv, t, t, hd, True, q.dtype)})
    # the same call in float16
    qh, kh, vh = q.half(), k.half(), v.half()
    o = flash_attention(qh, kh, vh)
    if o.dtype != torch.float16:
        raise AssertionError(f"flash_attention gave {o.dtype} for float16")
    err = float_err(o, mha_ref(qh, kh, vh), FLASH_TOL[qh.dtype])
    check_close("flash_attention float16", err)
    del o
    torch.cuda.empty_cache()
    run["float16"] = {
        **err, "ms": time_ms(lambda: flash_attention(qh, kh, vh)),
        "plain_ms": time_ms(lambda: flash_attention(qh, kh, vh,
                                                    backend="torch")),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True)),
        **flash_bound(b, H, Hkv, t, t, hd, True, qh.dtype)}
    del qh, kh, vh
    emit(run)
    emit({"phase": "flash_hopper", **flash_hopper(q, k, v, run)})
    torch.cuda.empty_cache()
    return run


def flash_hopper(q, k, v, run: dict) -> dict:
    """What shows the 16-bit kernel's design on the card: its rate on the
    counted FLOP and on the FLOP its tensor cores issue (1.5x: the split P
    multiplies V twice; the causal diagonal tiles, computed whole, add ~3%
    more at T = 4096 that neither count includes), in bfloat16 and
    (``run["float16"]``) float16; SDPA's own error against ``mha_ref`` on
    the bfloat16 ``q``, ``k``, ``v`` and on their float16 copies (it
    rounds P to the input's type, so in bfloat16 it is expected past the
    rms limit); and the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load)
    instructions in each bfloat16 and float16 instance's SASS; raises if
    an instance is missing or has none of either."""
    sdpa_err = {}
    for dtype in (torch.bfloat16, torch.float16):
        qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True, enable_gqa=True)
        err = float_err(sdpa, mha_ref(qd, kd, vd), FLASH_TOL[dtype])
        err["within_flash_tol"] = (err["excess"] <= 0 and
                                   err["rel_rms_err"] <= err["rel_rms_limit"])
        sdpa_err[str(dtype)] = err
        del qd, kd, vd, sdpa
    sass = sass_counts(_build.library_path(flash_kernel.LIBRARY,
                                           flash_kernel.SOURCES),
                       "flash_wgmma_kernel", ("HGMMA", "UTMALDG"))
    instances = {dtype: [name for name in sass if mangled in name]
                 for dtype, mangled in (("bfloat16", "nv_bfloat16"),
                                        ("float16", "__half"))}
    if any(len(names) != len(flash_kernel.HEAD_DIM_BUCKETS)
           for names in instances.values()) or not all(
            all(counts.values()) for counts in sass.values()):
        raise AssertionError(f"16-bit flash instances missing or without "
                             f"wgmma or TMA loads in their SASS: {sass}")
    f16 = run["float16"]
    return {"tflops_counted": run["ops"] / run["ms"] / 1e9,
            "tflops_issued": 1.5 * run["ops"] / run["ms"] / 1e9,
            "float16_tflops_counted": f16["ops"] / f16["ms"] / 1e9,
            "float16_tflops_issued": 1.5 * f16["ops"] / f16["ms"] / 1e9,
            "sdpa_vs_mha_ref": sdpa_err, "sass": sass}


def sass_counts(library: Path, kernel_name: str, opcodes) -> dict:
    """Occurrences of each opcode in the SASS of every function of the
    library whose (mangled) name holds ``kernel_name``, from
    ``cuobjdump -sass``, by function."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        name, _, body = section.partition("\n")
        if kernel_name in name:
            counts[name.strip()] = {op: body.count(op) for op in opcodes}
    return counts


def float_kernel_entry(name: str, source: str, checked: dict,
                       path: dict) -> dict:
    """A float kernel's entry of the kernels line, from its check phase
    and its path phase."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name],
            "max_abs_err": checked["max_abs_err"], "ms": path["ms"],
            "plain_ms": path["plain_ms"], "library_ms": path["library_ms"],
            "shape": path["shape"], "bound_ms": path["bound_ms"],
            "bound_by": path["bound_by"], "bytes": path["bytes"],
            "ops": path["ops"]}


def build_all() -> dict:
    """Build every kernel library, one ``nvcc`` each, all at once."""
    loaders = [module.load_library for _, module in LIBRARIES]
    with ThreadPoolExecutor(len(loaders)) as pool:
        list(pool.map(lambda load: load(), loaders))
    return {name: {"sources": [str(p.relative_to(ROOT))
                               for p in module.SOURCES],
                   "ptxas": [ln.strip() for ln in
                             _build.BUILD_LOGS.get(name, "").splitlines()
                             if "registers" in ln or "spill" in ln]}
            for name, module in LIBRARIES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rmat-scale", type=int, default=22)
    ap.add_argument("--delaunay-scale", type=int, default=24)
    ap.add_argument("--star-scale", type=int, default=20)
    ap.add_argument("--async-rmat-scale", type=int, default=20)
    ap.add_argument("--async-delaunay-scale", type=int, default=21)
    ap.add_argument("--check-scale", type=int, default=16)
    ap.add_argument("--lp-delaunay-scale", type=int, default=18)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # 1. device
    t0 = time.perf_counter()
    card = device_line()
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "seconds": time.perf_counter() - t0})

    # 2. build every kernel of the paths from the checkout's sources
    t0 = time.perf_counter()
    libraries = build_all()
    emit({"phase": "build", "libraries": libraries,
          "seconds": time.perf_counter() - t0})

    # 2b. the float kernels against their plain versions, then their entry
    # points at mistral-nemo-12b's widths
    t0 = time.perf_counter()
    kernels = {}
    rms_checked = phase_rmsnorm_vs_plain()
    flash_checked = phase_flash_vs_plain()
    rms_run = phase_rmsnorm_path()
    flash_run = phase_flash_path()
    kernels["rmsnorm_rows"] = float_kernel_entry(
        "rmsnorm_rows", RMSNORM_SOURCE, rms_checked, rms_run)
    kernels["flash_mha"] = float_kernel_entry(
        "flash_mha", FLASH_SOURCE, flash_checked, flash_run)
    float_runs = [rms_run, flash_run]
    emit({"phase": "float_kernels_done",
          "seconds": time.perf_counter() - t0})

    # graphs: the sizes of the paper's soc-LiveJournal1 and delaunay_n24
    # for the main and frontier paths, smaller ones for the async path
    # (within the reference scalar kernel's own n <= 3,145,728) and for
    # the mm2 checks against its plain Python loop
    t0 = time.perf_counter()
    seconds = {}

    def make(name, fn):
        t = time.perf_counter()
        g = fn()
        seconds[name] = time.perf_counter() - t
        return g

    rmat_name = f"rmat({args.rmat_scale},{RMAT_EDGE_FACTOR})"
    delaunay_name = f"delaunay_like({args.delaunay_scale})"
    rmat = make(rmat_name, lambda: gen.rmat(
        args.rmat_scale, edge_factor=RMAT_EDGE_FACTOR, device=DEVICE))
    delaunay = make(delaunay_name, lambda: gen.delaunay_like(
        args.delaunay_scale, device=DEVICE))
    star = make("star", lambda: gen.star(1 << args.star_scale,
                                         device=DEVICE))
    async_graphs = {
        f"delaunay_like({args.async_delaunay_scale})": make(
            "async_delaunay", lambda: gen.delaunay_like(
                args.async_delaunay_scale, device=DEVICE)),
        f"rmat({args.async_rmat_scale},{RMAT_EDGE_FACTOR})": make(
            "async_rmat", lambda: gen.rmat(
                args.async_rmat_scale, edge_factor=RMAT_EDGE_FACTOR,
                device=DEVICE)),
    }
    check_graphs = {
        f"delaunay_like({args.check_scale})": gen.delaunay_like(
            args.check_scale, device=DEVICE),
        f"rmat({args.check_scale},{RMAT_EDGE_FACTOR})": gen.rmat(
            args.check_scale, edge_factor=RMAT_EDGE_FACTOR, device=DEVICE),
        # each edge (i, i + 1) reads the label the edge before wrote; every
        # edge meets the hub
        "path_unshuffled(65536)": gen.path(1 << 16, shuffle_ids=False,
                                           device=DEVICE),
        "star(65536)": gen.star(1 << 16, device=DEVICE),
        # every edge meets vertex 0 (the sweep kernels' checks only)
        "one_hub(65536)": Graph.from_numpy(
            np.zeros((1 << 16) - 1, np.int64), np.arange(1, 1 << 16),
            1 << 16, device=DEVICE),
    }
    emit({"phase": "graphs", "seconds": time.perf_counter() - t0,
          "seconds_each": seconds,
          **{name: [g.n_vertices, g.n_edges] for name, g in
             [(rmat_name, rmat), (delaunay_name, delaunay),
              *async_graphs.items(), *check_graphs.items()]}})

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    kernels.update(phase_kernels(
        {rmat_name: rmat, delaunay_name: delaunay}, star, {
            name: check_graphs[name] for name in (
                f"delaunay_like({args.check_scale})",
                f"rmat({args.check_scale},{RMAT_EDGE_FACTOR})",
                "path_unshuffled(65536)", "star(65536)", "one_hub(65536)")}))
    del star
    kernels["mm2"] = phase_mm2(
        {name: g for name, g in check_graphs.items()
         if not name.startswith("one_hub")}, async_graphs)
    del check_graphs
    emit({"phase": "kernels_vs_plain_done",
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    ref_rmat = scipy_labels(rmat)
    ref_delaunay = scipy_labels(delaunay)
    ref_async = {name: scipy_labels(g) for name, g in async_graphs.items()}
    emit({"phase": "scipy_reference", "seconds": time.perf_counter() - t0})

    # 4. the main path at real size; 5. the second kernel on the main
    # entry point (C-11mm's order-1 warm-up sweeps)
    t0 = time.perf_counter()
    runs = [drive(delaunay, delaunay_name, "C-2", ref_delaunay),
            drive(rmat, rmat_name, "C-2", ref_rmat)]
    if not all(r["launches"]["fused_relax"] > 0 for r in runs):
        raise AssertionError("the main path did not launch fused_relax")
    if not all(r["launches"]["converged_early"] > 0
               and r["launches"]["pointer_jump"] > 0 for r in runs):
        raise AssertionError("the main path did not launch converged_early "
                             "and pointer_jump")
    c11 = drive(rmat, rmat_name, "C-11mm", ref_rmat)
    if c11["launches"]["scatter_min"] <= 0:
        raise AssertionError("C-11mm did not launch scatter_min")
    runs.append(c11)
    # the loop's kernels against their plain versions, at the main path's
    # label states and the solves' fixed points
    fixed = {rmat_name: (rmat, runs[1].pop("labels")),
             delaunay_name: (delaunay, runs[0].pop("labels"))}
    del c11["labels"]
    kernels.update(phase_converged(fixed))
    kernels["pointer_jump"] = phase_jump(fixed)
    del fixed
    emit({"phase": "main_path_done", "seconds": time.perf_counter() - t0})

    # 6. the async path: cuda_async on the in-order kernel; the first
    # graph's solve also runs on CPU tensors, through mm2_plain
    t0 = time.perf_counter()
    async_runs = [drive_async(g, name, ref_async[name], {}, on_cpu=i == 0)
                  for i, (name, g) in enumerate(async_graphs.items())]
    if not all(r["launches"]["mm2"] > 0 for r in async_runs):
        raise AssertionError("the async path did not launch mm2")
    runs += async_runs
    emit({"phase": "async_path_done", "seconds": time.perf_counter() - t0})

    # 7. the frontier path, staged at the paper's sizes, every strategy;
    # and cuda_async under the frontier
    t0 = time.perf_counter()
    frontier_runs = [drive_frontier(g, name, strategy, ref)
                     for strategy in SAMPLING_STRATEGIES
                     for name, g, ref in
                     ((delaunay_name, delaunay, ref_delaunay),
                      (rmat_name, rmat, ref_rmat))]
    if not all(r["launches"]["fused_relax"] > 0 for r in frontier_runs):
        raise AssertionError("the frontier path did not launch fused_relax")
    for name, g in ((delaunay_name, delaunay), (rmat_name, rmat)):
        emit({"phase": "frontier_parts", "graph": name,
              **frontier_parts(g)})
    name, g = next(iter(async_graphs.items()))
    async_frontier = drive_async(g, name, ref_async[name], FRONTIER,
                                 on_cpu=True)
    if async_frontier["launches"]["mm2"] <= 0:
        raise AssertionError("cuda_async under the frontier did not launch "
                             "mm2")
    runs += frontier_runs + [async_frontier] + float_runs
    emit({"phase": "frontier_path_done",
          "seconds": time.perf_counter() - t0})

    # 7b. fleets of small graphs through solve_batch, then algorithm="auto"
    # on the main path's graphs and the autotuner on the async rmat
    stream_name = f"rmat({args.async_rmat_scale},{RMAT_EDGE_FACTOR})"
    t0 = time.perf_counter()
    batch_runs, batch_kernels = phase_batch()
    kernels.update(batch_kernels)
    batch_s = time.perf_counter() - t0
    emit({"phase": "batch_path_done", "seconds": batch_s})
    t0 = time.perf_counter()
    auto_runs = [
        drive_auto(delaunay, delaunay_name, ref_delaunay,
                   runs[0]["loop_cost"]["solve_ms"]),
        drive_auto(rmat, rmat_name, ref_rmat,
                   runs[1]["loop_cost"]["solve_ms"]),
        # the async path's rmat(20,16)
        drive_autotune(async_graphs[stream_name], stream_name,
                       ref_async[stream_name])]
    auto_s = time.perf_counter() - t0
    runs += batch_runs + auto_runs
    emit({"phase": "auto_path_done", "seconds": auto_s,
          "batch_and_auto_s": batch_s + auto_s,
          "budget_s": BATCH_AUTO_BUDGET_S,
          "within_budget": batch_s + auto_s <= BATCH_AUTO_BUDGET_S})
    # the out-of-core and recovery paths take the async graphs' edges from
    # the host
    async_host = {name: g.to_numpy() for name, g in async_graphs.items()}
    del async_graphs, g

    # 8. the baseline families: FastSV on the main path's graphs, label
    # propagation on rmat and on a smaller mesh (its iterations grow with
    # the diameter), Rem (a host loop) only at the check scale, where every
    # family is also held against its solve on CPU tensors
    t0 = time.perf_counter()
    dense_ms = {delaunay_name: runs[0]["loop_cost"]["solve_ms"],
                rmat_name: runs[1]["loop_cost"]["solve_ms"]}
    lp_name = f"delaunay_like({args.lp_delaunay_scale})"
    lp_graph = gen.delaunay_like(args.lp_delaunay_scale, device=DEVICE)
    baseline_runs = [
        drive_baseline(delaunay, delaunay_name, "fastsv", ref_delaunay,
                       False, dense_ms[delaunay_name]),
        drive_baseline(rmat, rmat_name, "fastsv", ref_rmat, False,
                       dense_ms[rmat_name]),
        drive_baseline(rmat, rmat_name, "label_propagation", ref_rmat, False,
                       dense_ms[rmat_name]),
        drive_baseline(lp_graph, lp_name, "label_propagation",
                       scipy_labels(lp_graph), False)]
    del lp_graph
    for name, g in ((delaunay_name, delaunay), (rmat_name, rmat)):
        emit({"phase": "fastsv_freeze", "graph": name,
              **fastsv_freeze_cost(g)})
    for name, g in (
            (f"delaunay_like({args.check_scale})",
             gen.delaunay_like(args.check_scale, device=DEVICE)),
            (f"rmat({args.check_scale},{RMAT_EDGE_FACTOR})",
             gen.rmat(args.check_scale, edge_factor=RMAT_EDGE_FACTOR,
                      device=DEVICE))):
        ref = scipy_labels(g)
        baseline_runs += [drive_baseline(g, name, a, ref, True)
                          for a in ("fastsv", "label_propagation",
                                    "union_find")]
    runs += baseline_runs
    emit({"phase": "baseline_path_done",
          "seconds": time.perf_counter() - t0})

    # 9. the streaming path: the main path's graphs streamed in batches of
    # their own edges, then the card against CPU tensors at the check scale
    t0 = time.perf_counter()
    stream_runs = [drive_stream(delaunay, delaunay_name, ref_delaunay),
                   drive_stream(rmat, rmat_name, ref_rmat)]
    # the out-of-core path reads rmat's edges from the host
    rmat_host = rmat.to_numpy()
    del rmat, delaunay
    stream_runs += [stream_vs_cpu(g, name) for name, g in (
        (f"delaunay_like({args.check_scale})",
         gen.delaunay_like(args.check_scale, device=DEVICE)),
        (f"rmat({args.check_scale},{RMAT_EDGE_FACTOR})",
         gen.rmat(args.check_scale, edge_factor=RMAT_EDGE_FACTOR,
                  device=DEVICE)))]
    runs += stream_runs
    stream_s = time.perf_counter() - t0
    emit({"phase": "stream_path_done", "seconds": stream_s})

    # 10. the serving path: the engine under traffic on the card, and its
    # recovery from injected crashes
    t0 = time.perf_counter()
    runs += phase_serve()
    serve_s = time.perf_counter() - t0
    emit({"phase": "serve_path_done", "seconds": serve_s,
          "stream_and_serve_s": stream_s + serve_s,
          "budget_s": STREAM_SERVE_BUDGET_S,
          "within_budget": stream_s + serve_s <= STREAM_SERVE_BUDGET_S})

    # 11. the out-of-core path: the edges stream from the host, the card
    # holds the labels and one chunk; then the recovery loops
    t0 = time.perf_counter()
    _flush.clear()
    mesh_name = f"delaunay_like({args.async_delaunay_scale})"
    stream_name = f"rmat({args.async_rmat_scale},{RMAT_EDGE_FACTOR})"
    oocore_runs, mesh_out, mesh_rounds = phase_oocore(
        rmat_host, async_host[mesh_name], ref_rmat, rmat_name, mesh_name)
    del rmat_host
    oocore_s = time.perf_counter() - t0
    emit({"phase": "oocore_path_done", "seconds": oocore_s})
    t0 = time.perf_counter()
    runs += oocore_runs + phase_recovery(
        async_host[mesh_name], mesh_out, mesh_rounds,
        async_host[stream_name], mesh_name, stream_name)
    recovery_s = time.perf_counter() - t0
    emit({"phase": "recovery_path_done", "seconds": recovery_s,
          "oocore_and_recovery_s": oocore_s + recovery_s,
          "budget_s": OOCORE_BUDGET_S,
          "within_budget": oocore_s + recovery_s <= OOCORE_BUDGET_S})

    # 12. the kernels line: launches summed over every path's runs
    line = []
    for name in KERNEL_NAMES:
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
