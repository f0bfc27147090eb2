"""The in-order asynchronous 2-order sweep kernel: wrapper, plain version,
and a replay of the kernel's protocol.

The port's counterpart of ``repro.kernels.contour_mm.kernel``.
:func:`mm2` is a hand-written CUDA kernel for Hopper in ``csrc/mm2.cu``
(replaces ``mm2_pallas``).  It sweeps the edges in order and updates the
labels in place, so each edge sees the labels that earlier edges lowered:
the result depends on the edge order and equals ``ref.mm_block_ref`` bit
for bit.

The sweep is one chain: each edge reads ``L[w]``, ``L[v]``, then
``L[L[w]]``, ``L[L[v]]``, and the next edge may read what this one wrote.
The kernel keeps that chain in shared memory.  One CTA: producer warps
load windows of ``WINDOW`` edges ahead, with the four labels of each edge
read from device memory, into a ring ``DEPTH`` windows deep; one consumer
thread walks the windows in order and takes each label read from

1. its cache, a direct-mapped table of ``CACHE_SLOTS`` slots in shared
   memory holding (vertex, label) for every vertex it has read or
   written, each vertex taking its slot from the one before.  The consumer is the only writer of
   ``L``, so a label in the cache is exact;
2. else the prefetched label, when the prefetch read the true address
   and no write to it can have been missed.  The producer loaded window
   ``j`` only after the consumer released window ``j - DEPTH``, so it saw
   every write of the windows before ``rel = j - DEPTH + 1``.  Each slot
   also keeps the latest window in which any vertex that has held it was
   written.  Every write enters the written vertex into its slot, so if
   that window is below ``rel``, no write to a vertex that maps there was
   missed;
3. else ``L`` in device memory, the only serial global load.

:func:`mm2_pipelined_replay` replays that protocol in plain Python, with
every prefetch taken at its window's release, the oldest the protocol
allows, and returns the labels and the three counts; it is held against
the reference bit for bit at window, depth and cache sizes from 1 up.
The kernel's edge is this replay's edge step: it loads the four slots of
an edge at once, on the guess that the labels the producer read are
still the labels, and stores each once, where the guess holds (or one
more load fixes it) and no two distinct vertices of the edge share a
slot; otherwise it takes the step as written.

On a CUDA tensor :func:`mm2` runs the kernel or raises; its plain version
:func:`mm2_plain` (a Python loop over the edges) runs only when the
tensors lie on the CPU.  The wrapper copies ``L``, launches on the
current stream with the copy updated in place, and adds one to
``mm2.launches`` for every launch.  Ids outside ``[0, n)`` raise
``IndexError`` on both devices, as for the kernels of ``blocked.py``.

The TPU kernel kept all of ``L`` in VMEM, which capped ``n`` at 3,145,728
at a 16 MiB budget (``ops.py:193-202`` of the reference).  The CUDA kernel
reads ``L`` from device memory and has no such ceiling.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import _build
from repro_torch.kernels.contour_mm.blocked import (check_done, check_int32,
                                                    edge_count, frozen,
                                                    launch, on_cuda)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "mm2.cu",)
LIBRARY = "contour_mm2"

# the protocol's sizes, for the kernel and its replay: edges per window,
# windows in the ring, entries of the consumer's cache (a power of two)
WINDOW = 64
DEPTH = 4
CACHE_SLOTS = 4096
# what the consumer's label reads were served from, in this order
COUNTERS = ("global_loads", "cache_hits", "prefetch_hits")

_IDS = "mm2: an edge endpoint or a label at one"


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load ``libcontour_mm2``; declare its API."""
    lib = _build.load_library(LIBRARY, SOURCES)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.contour_mm2.argtypes = [p, p, p, i64, i64, i64, i64, p, p, i64, p,
                                p]
    lib.contour_mm2.restype = ctypes.c_int
    return lib


def mm2_plain(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              edge_limit=None, done=None) -> torch.Tensor:
    """Plain version of :func:`mm2`: ``mm_block_ref`` over the first
    ``edge_limit`` edges, raising IndexError where the kernel would meet
    an id outside ``[0, n)``; a copy of ``L`` where ``done`` is set."""
    if frozen(done):
        return L.clone()
    n = int(L.shape[0])
    m = edge_count(int(src.shape[0]), edge_limit)
    lab = L.tolist()
    for w, v in zip(src[:m].tolist(), dst[:m].tolist()):
        if not (0 <= w < n and 0 <= v < n):
            raise IndexError(f"{_IDS} outside [0, {n})")
        lw = lab[w]
        lv = lab[v]
        if not (0 <= lw < n and 0 <= lv < n):
            raise IndexError(f"{_IDS} outside [0, {n})")
        z = min(lab[lw], lab[lv])
        for t in (w, v, lw, lv):
            if z < lab[t]:
                lab[t] = z
    return torch.tensor(lab, dtype=L.dtype, device=L.device)


def check_inputs(L: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor) -> None:
    check_int32("L", L, L.device)
    check_int32("src", src, L.device)
    check_int32("dst", dst, L.device)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {tuple(src.shape)} vs "
                         f"{tuple(dst.shape)}")


def check_sizes(window: int, depth: int, cache_slots: int) -> None:
    if window < 1 or depth < 1:
        raise ValueError(f"window and depth must be >= 1, got {window}, "
                         f"{depth}")
    if cache_slots < 1 or cache_slots & (cache_slots - 1):
        raise ValueError(f"cache_slots must be a power of two, got "
                         f"{cache_slots}")


def mm2_pipelined_replay(L: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, edge_limit=None, *,
                         window: int = WINDOW, depth: int = DEPTH,
                         cache_slots: int = CACHE_SLOTS,
                         trust_prefetch: bool = False,
                         skip_window_check: bool = False
                         ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The kernel's protocol in plain Python: labels and the counts of
    :data:`COUNTERS`.

    Window ``j`` is prefetched from ``L`` as it stands when window
    ``j - depth`` is released (at the start for ``j < depth``).  A cache
    slot is ``[vertex, label, window]``: the vertex it holds (-1: none)
    with its exact label, and the latest window in which the consumer
    wrote any vertex that has held the slot (-1: none).  Two controls
    break the protocol on purpose: ``trust_prefetch=True`` takes a
    prefetched label whenever its address is the true one, before the
    cache and without the window check; ``skip_window_check=True`` keeps
    the cache but takes a prefetch on any miss without the window check.
    """
    check_sizes(window, depth, cache_slots)
    n = int(L.shape[0])
    m = edge_count(int(src.shape[0]), edge_limit)
    lab = L.tolist()
    edges = list(zip(src[:m].tolist(), dst[:m].tolist()))
    mask = cache_slots - 1
    cache = [[-1, 0, -1] for _ in range(cache_slots)]
    counts = dict.fromkeys(COUNTERS, 0)
    windows = -(-m // window)

    def inside(x):
        return x is not None and 0 <= x < n

    def prefetch(j):
        rows = []
        for w, v in edges[j * window:(j + 1) * window]:
            pw = lab[w] if inside(w) else None
            pv = lab[v] if inside(v) else None
            rows.append((pw, pv, lab[pw] if inside(pw) else None,
                         lab[pv] if inside(pv) else None))
        return rows

    def read(x, addr, value, rel):
        slot = cache[x & mask]
        if slot[0] == x and not (trust_prefetch and addr == x):
            counts["cache_hits"] += 1
            return slot[1]
        if addr == x and (trust_prefetch or skip_window_check
                          or slot[2] < rel):
            counts["prefetch_hits"] += 1
        else:
            counts["global_loads"] += 1
            value = lab[x]
        cache[x & mask] = [x, value, slot[2]]
        return value

    def write(t, z, j):
        cache[t & mask] = [t, z, j]
        lab[t] = z

    bad = False
    ring = {j: prefetch(j) for j in range(min(depth, windows))}
    for j in range(windows):
        rel = max(0, j - depth + 1)
        rows = ring.pop(j)
        for (w, v), (pw, pv, ppw, ppv) in zip(
                edges[j * window:(j + 1) * window], rows):
            if not (inside(w) and inside(v)):
                bad = True
                continue
            lw = read(w, w, pw, rel)
            lv = read(v, v, pv, rel)
            if not (inside(lw) and inside(lv)):
                bad = True
                continue
            l2w = read(lw, pw, ppw, rel)
            l2v = read(lv, pv, ppv, rel)
            z = min(l2w, l2v)
            for t, seen in ((w, lw), (v, lv), (lw, l2w), (lv, l2v)):
                if z < seen:
                    write(t, z, j)
        if j + depth < windows:  # window j released: refill its slot
            ring[j + depth] = prefetch(j + depth)
    if bad:
        raise IndexError(f"{_IDS} outside [0, {n})")
    return torch.tensor(lab, dtype=L.dtype, device=L.device), counts


def sweep(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
          edge_limit=None, *, window: int = WINDOW, depth: int = DEPTH,
          cache_slots: int = CACHE_SLOTS, check: bool = True,
          counts: bool = False, done=None):
    """Launch the kernel once on CUDA tensors at the given sizes; returns
    the new labels, and with ``counts`` also the counts of
    :data:`COUNTERS` (which waits for the kernel).  :func:`mm2` is this
    at the defaults; other sizes are for the checks."""
    check_inputs(L, src, dst)
    if not on_cuda(L):
        raise ValueError("mm2's kernel takes CUDA tensors; mm2() runs the "
                         "plain version on CPU tensors")
    check_sizes(window, depth, cache_slots)
    done_ptr = check_done(done, L.device)
    src, dst = src.contiguous(), dst.contiguous()
    m = edge_count(int(src.shape[0]), edge_limit)
    out = L.clone(memory_format=torch.contiguous_format)
    tally = torch.zeros(len(COUNTERS), dtype=torch.int64, device=L.device)
    if m > 0:
        lib = load_library()
        launch(lib.contour_mm2, out.data_ptr(), src.data_ptr(),
               dst.data_ptr(), m, window, depth, cache_slots,
               tally.data_ptr() if counts else None, done_ptr, wrapper=mm2,
               check=check, what=_IDS, L=out)
    if counts:
        with trace.span("read.counts"):
            values = tally.tolist()
        return out, dict(zip(COUNTERS, values))
    return out


def mm2(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
        edge_limit=None, *, check: bool = True, done=None) -> torch.Tensor:
    """One asynchronous order-2 sweep in edge order; returns new labels.

    Edges at positions ``>= edge_limit`` (a Python int or 0-d tensor)
    are not visited.  The TPU kernel masked them to ``(0, 0)`` self-loops
    instead; under the ``L[v] <= v`` labelling invariant (so
    ``L[0] == 0``) such a self-loop is a no-op, and the two agree.  An
    endpoint, or a label at one, outside ``[0, len(L))`` raises
    IndexError; on the card, ``check=False`` skips such an edge instead
    and does not wait for the kernel.  ``L`` is not modified.  With
    ``done`` (the loop's flag word, as for ``blocked.fused_relax``) set it
    returns a copy of ``L``.
    """
    check_inputs(L, src, dst)
    if not on_cuda(L):
        return mm2_plain(L, src, dst, edge_limit, done)
    return sweep(L, src, dst, edge_limit, check=check, done=done)


mm2.launches = 0
