"""Out-of-core multi-round contraction: device memory bounds the *chunk*,
not the graph.

The port's counterpart of ``repro.connectivity.oocore`` (DESIGN.md §15).
Every other solver materialises the full edge list on the device; this
one holds only the O(n) labels and one power-of-two edge chunk there:

* **Edges live on the host**, as arrays (:class:`ArrayChunks`) or
  generated on the fly (:class:`~repro_torch.graphs.generators.
  RmatChunks`, which never holds the full list).

* **Round structure.**  Each round streams every surviving chunk through
  a double-buffered host→device pipeline (:class:`_ChunkPipeline`): the
  copy of chunk ``k+1`` is issued before the fold of chunk ``k``, so the
  transfer overlaps the fold.  A fold (:func:`_fold_chunk`) rewrites the
  chunk to current supervertex roots and runs a **bounded** number of
  local min-mapping sweeps (``SolveOptions.oocore_local_iters``) under the
  frontier schedule: bounded, not to convergence, since per-chunk
  convergence would reach the global fixpoint in round 1 and the
  multi-round structure would be vacuous.  Chunks are padded with
  ``(0, 0)`` self-loop no-ops and swept only up to their real edge count.

* **Host-side contraction between rounds.**  After a round the labels
  come to the host once; every edge of the round's input is relabeled to
  its endpoints' roots, intra-supervertex edges (``L[u] == L[v]``) are
  retired, and the survivors are deduped on the unordered root pair, so
  round ``k+1`` streams only surviving inter-supervertex edges.  Retiring
  is permanent (a min-mapping merge never splits), and the deduped
  survivor count strictly decreases every round.

* **In-core handoff.**  Once the survivors fit one chunk bucket
  (``ExecutionPlan.chunk_bucket``, from
  :func:`planner.oocore_chunk_bucket` or the source's own chunk), the
  ordinary in-core solve finishes warm-started from the resident labels.
  If ``oocore_round_cap`` rounds pass first, the finish is forced anyway:
  labels stay correct, only the memory bound is waived (and the waiver
  recorded in provenance).

The copy pipeline is the part the card adds.  Each chunk is padded
straight into one of two pinned host buffers and copied, on a copy
stream of its own, into one of two device buffers; the compute stream
waits on the copy's event before the fold, and the copy stream waits on
an event recorded after the fold before it overwrites that device
buffer.  The host waits on a copy's event before it writes the pinned
buffer the copy reads.  The buffers are allocated once per engine.

The fold's counters are the reference's: a round's iterations are summed
as integers and its ``edges_visited`` in float32, chunk by chunk, before
they join the engine's Python totals.  Each chunk's ids are checked on
the host before its copy, and an id outside ``[0, n)`` raises
``IndexError`` (the reference's gather clamps; a CUDA gather out of
range is a device-side assert that poisons the context).

Recovery (``resilience.oocore_with_recovery``) checkpoints at round
boundaries (labels plus the surviving-chunk manifest), so a mid-round
crash replays one round, not the stream: ``chunk(k)`` purity makes the
replay bit-exact.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.connectivity import frontier as fr
from repro_torch.connectivity import minmap as lab
from repro_torch.connectivity import planner as _planner
from repro_torch.connectivity.options import SolveOptions
from repro_torch.connectivity.result import ComponentResult
from repro_torch.connectivity.solve import make_result, resolve_warm_start
from repro_torch.connectivity.streaming import delta_converge
from repro_torch.graphs.generators import ArrayChunks, EdgeChunks
from repro_torch.graphs.structs import DeviceLike, Graph, resolve_device
from repro_torch.kernels.contour_mm import converged as cv

# Peak-memory model (bytes, int32 everywhere), the reference's: the
# resident labels (plus pointer-jump and gather temporaries) and one
# chunk (double-buffered src/dst pairs plus the fold's rewrite,
# contraction and convergence temporaries).  Deliberately an over-count.
LABEL_ARRAYS = 3    # labels + compress double-buffer + gather temp
CHUNK_ARRAYS = 28   # 2x2 double-buffered src/dst + sweep temporaries
EDGE_BYTES = 8      # one int32 (src, dst) pair — the in-core cost/edge


def estimate_peak_bytes(n_vertices: int, chunk_bucket: int) -> int:
    """Deterministic host-side upper estimate of the resident device
    bytes of an out-of-core solve (labels + one double-buffered chunk)."""
    return 4 * (LABEL_ARRAYS * int(n_vertices)
                + CHUNK_ARRAYS * int(chunk_bucket))


def device_peak_bytes(device: DeviceLike = None) -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` on a CUDA device (the card when
    none is named and one is present), None on the CPU.

    It counts the bytes of allocated tensors since the last
    ``torch.cuda.reset_peak_memory_stats()``, not the allocator's
    reserved cache."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = "cuda"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def _fold_chunk(labels: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                n_active: int, *, variant: str = "C-2",
                backend: str = "torch", fuse: bool = True, warmup: int = 2,
                async_compress: int = 1, local_iters: int = 4):
    """Fold one edge chunk into the resident labels (bounded local work).

    The streaming engine's delta solve (``streaming.delta_converge``:
    the supervertex rewrite, then the masked frontier with ``sampling=0``
    and ``compact_every=1`` over the first ``n_active`` edges) with
    ``max_iters`` capped at ``local_iters``: partial convergence is fine,
    the host-side inter-round contraction and the final in-core finish
    carry global convergence.  Returns ``(labels', sweeps,
    edges_visited)``: ``labels'`` compressed back to a star forest (the
    rewrite's precondition for the next chunk), an int and a numpy
    float32.
    """
    L, it, _, visited = delta_converge(
        src, dst, labels, n_active, variant=variant, backend=backend,
        fuse=fuse, warmup=warmup, async_compress=async_compress,
        sampling=0, compact_every=1, max_iters=local_iters)
    return L, it, visited


def _pad_chunk(src: np.ndarray, dst: np.ndarray, out: np.ndarray,
               n_vertices: int) -> int:
    """Write a host chunk into ``out`` (int32 ``[2, bucket]``: src, dst),
    padded with (0, 0) self-loop no-ops; returns its real edge count.

    The ids are checked first: one outside ``[0, n_vertices)`` raises
    ``IndexError`` before it can reach a gather on the card."""
    m = int(src.shape[0])
    if m:
        lo = min(int(src.min()), int(dst.min()))
        hi = max(int(src.max()), int(dst.max()))
        if lo < 0 or hi >= n_vertices:
            raise IndexError(
                f"edge endpoint {lo if lo < 0 else hi} outside [0, "
                f"{n_vertices}) in an out-of-core chunk")
    out[0, :m] = src
    out[1, :m] = dst
    out[:, m:] = 0
    return m


class _ChunkPipeline:
    """The double-buffered host→device path of one engine's chunks.

    Slot ``k % 2`` carries chunk ``k``: a pinned host buffer and a device
    buffer, each int32 ``[2, bucket]`` (src, dst), an event recorded on
    the copy stream after the copy into the device buffer (``copied``) and
    one recorded on the compute stream after the fold that reads it
    (``folded``).  On the CPU the host buffer is the device buffer and
    every call is synchronous."""

    def __init__(self, bucket: int, device: torch.device):
        on_card = device.type == "cuda"
        self.host = [torch.zeros((2, bucket), dtype=torch.int32,
                                 pin_memory=on_card) for _ in range(2)]
        self.stream = None
        self.device_bufs = self.host
        if on_card:
            self.stream = torch.cuda.Stream(device)
            self.device_bufs = [torch.zeros((2, bucket), dtype=torch.int32,
                                            device=device)
                                for _ in range(2)]
            for buf in self.device_bufs:
                # the allocator must not hand a buffer out again while a
                # copy into it is pending on the copy stream
                buf.record_stream(self.stream)
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.folded = [torch.cuda.Event() for _ in range(2)]

    def put(self, k: int, src: np.ndarray, dst: np.ndarray,
            n_vertices: int) -> tuple:
        """Pad chunk ``k`` into its pinned buffer and start its copy;
        returns ``(src, dst, m)``, views of its device buffer and its
        real edge count."""
        slot = k % 2
        if self.stream is not None:
            # the copy out of this pinned buffer (chunk k - 2) is done
            self.copied[slot].synchronize()
        m = _pad_chunk(src, dst, self.host[slot].numpy(), n_vertices)
        if self.stream is not None:
            self._copy(slot)
        buf = self.device_bufs[slot]
        return buf[0], buf[1], m

    def _copy(self, slot: int) -> None:
        """Copy ``slot``'s pinned buffer into its device buffer on the
        copy stream, once the fold that read that buffer (chunk k - 2) is
        done."""
        self.stream.wait_event(self.folded[slot])
        with torch.cuda.stream(self.stream):
            self.device_bufs[slot].copy_(self.host[slot], non_blocking=True)
            self.copied[slot].record(self.stream)

    def acquire(self, k: int) -> None:
        """The compute stream waits for chunk ``k``'s copy."""
        if self.stream is not None:
            torch.cuda.current_stream(self.stream.device).wait_event(
                self.copied[k % 2])

    def release(self, k: int) -> None:
        """Mark chunk ``k``'s fold as enqueued on the compute stream."""
        if self.stream is not None:
            self.folded[k % 2].record(
                torch.cuda.current_stream(self.stream.device))

    def drain(self) -> None:
        """Wait for every copy issued (one may be in flight after a fault
        in the middle of a round)."""
        if self.stream is not None:
            self.stream.synchronize()


class OutOfCoreContraction:
    """Round-structured out-of-core solver (module docstring for theory).

    The round-level API lets three consumers share one engine: the
    registry solver (:func:`oocore_labels` / ``algorithm="oocore"``) calls
    :meth:`run`; ``resilience.oocore_with_recovery`` drives
    :meth:`run_round` with round-boundary checkpoints; ``chip_smoke.py``
    reads :attr:`round_counts` and the peak-memory accounting.

    ``device`` holds the labels and the chunk buffers (``cuda`` unless
    named; tests pass ``"cpu"``).
    """

    def __init__(self, chunks, options: Optional[SolveOptions] = None,
                 *, init_labels=None, fault_injector=None,
                 device: DeviceLike = None, **overrides):
        if not isinstance(chunks, EdgeChunks):
            raise TypeError(
                f"chunks must be an EdgeChunks source, got "
                f"{type(chunks).__name__}; wrap host arrays in ArrayChunks "
                f"or use graphs.rmat_chunks")
        opts = options if options is not None else SolveOptions()
        if overrides:
            opts = opts.replace(**overrides)
        opts.validate()
        variant = opts.variant or "C-2"
        if variant == "C-Syn":
            raise ValueError(
                "C-Syn is the Alg.-1-verbatim reference and cannot take "
                "the out-of-core schedule; use C-2/C-m or any async "
                "variant")
        if chunks.n_vertices >= 1 << 31:
            raise ValueError(
                f"n_vertices={chunks.n_vertices} exceeds the int32 vertex "
                f"id space")
        self.chunks = chunks
        self.n_vertices = chunks.n_vertices
        self.fault_injector = fault_injector
        self.device = resolve_device(device)
        # solvers registers this module's solver: import it late
        from repro_torch.connectivity.solvers import resolve_backend_plan
        plan = resolve_backend_plan(chunks.n_vertices, chunks.n_edges,
                                    self.device, opts)
        if plan.chunk_bucket == 0:
            plan = plan.replace(chunk_bucket=_planner.oocore_chunk_bucket(
                chunks.n_edges, requested=opts.oocore_chunk_edges))
        # a chunk source dictates its own round-0 granularity; the plan
        # records what actually streams
        if chunks.chunk_edges != plan.chunk_bucket:
            plan = plan.replace(chunk_bucket=chunks.chunk_edges)
        self.backend = plan.backend
        self.plan = plan
        self.bucket = plan.chunk_bucket
        self.opts = opts
        self.round_cap = opts.oocore_round_cap
        self._statics = dict(
            variant=variant,
            backend=plan.backend,
            fuse=plan.fuse_relabel,
            warmup=opts.warmup,
            async_compress=opts.async_compress,
            local_iters=opts.oocore_local_iters,
        )
        init = resolve_warm_start(
            init_labels if init_labels is not None else opts.warm_start,
            chunks.n_vertices)
        self._init_np = (None if init is None
                         else init.cpu().numpy().astype(np.int32))
        self._pipeline = _ChunkPipeline(self.bucket, self.device)
        self.reset()

    # -- state -----------------------------------------------------------
    def reset(self) -> None:
        """Back to the pre-round-0 state (labels = warm start or
        identity, stream = the source).  Round-0 crash recovery: the
        source's ``chunk(k)`` purity makes the replay bit-exact."""
        self._pipeline.drain()
        init = (None if self._init_np is None
                else torch.from_numpy(self._init_np.copy()))
        self.labels = lab.resolve_init_labels(init, self.n_vertices,
                                              self.device)
        self.round_index = 0
        self.iterations = 0
        self.visited = 0.0
        self.round_counts: list = []   # deduped survivors after each round
        self.survivors_src: Optional[np.ndarray] = None
        self.survivors_dst: Optional[np.ndarray] = None
        self.finished_streaming = False
        self.round_cap_exhausted = False
        self._chunk_counter = 0

    def state_dict(self) -> dict:
        """Round-boundary snapshot: labels + surviving-chunk manifest +
        counters, as numpy copies (a held snapshot keeps its round).
        Everything needed to resume at ``round_index``."""
        empty = np.zeros(0, np.int32)
        return {
            "labels": self.labels.to("cpu", copy=True).numpy(),
            "src": (empty if self.survivors_src is None
                    else self.survivors_src),
            "dst": (empty if self.survivors_dst is None
                    else self.survivors_dst),
            "round": np.int64(self.round_index),
            "iterations": np.int64(self.iterations),
            "visited": np.float64(self.visited),
            "counts": np.asarray(self.round_counts, np.int64),
            "finished": np.int64(self.finished_streaming),
            "exhausted": np.int64(self.round_cap_exhausted),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` (of either package) onto the
        engine's device."""
        self._pipeline.drain()
        self.labels = torch.tensor(np.asarray(state["labels"]),
                                   dtype=torch.int32, device=self.device)
        self.round_index = int(state["round"])
        self.iterations = int(state["iterations"])
        self.visited = float(state["visited"])
        self.round_counts = [int(c) for c in state["counts"]]
        self.finished_streaming = bool(int(state["finished"]))
        self.round_cap_exhausted = bool(int(state["exhausted"]))
        if self.round_index == 0:
            self.survivors_src = self.survivors_dst = None
        else:
            self.survivors_src = np.asarray(state["src"], np.int32)
            self.survivors_dst = np.asarray(state["dst"], np.int32)

    def save(self, manager) -> None:
        manager.save(self.round_index, self.state_dict())

    def restore(self, manager, step: Optional[int] = None) -> None:
        state, _ = manager.restore(self.state_dict(), step)
        self.load_state_dict(state)

    # -- the rounds ------------------------------------------------------
    def _round_source(self) -> EdgeChunks:
        if self.round_index == 0:
            return self.chunks
        return ArrayChunks(self.survivors_src, self.survivors_dst,
                           self.n_vertices, self.bucket)

    def _stream(self, source: EdgeChunks) -> None:
        """One double-buffered pass of every chunk of ``source`` through
        :func:`_fold_chunk`."""
        n_chunks = source.n_chunks
        if n_chunks == 0:
            return
        pipe = self._pipeline
        its = 0
        visited = np.float32(0)
        # chunk k+1's copy is issued before chunk k's fold
        nxt = pipe.put(0, *source.chunk(0), self.n_vertices)
        for k in range(n_chunks):
            cur = nxt
            if k + 1 < n_chunks:
                nxt = pipe.put(k + 1, *source.chunk(k + 1), self.n_vertices)
            if self.fault_injector is not None:
                self.fault_injector.maybe_fail(self._chunk_counter,
                                               "oocore_chunk")
            self._chunk_counter += 1
            src, dst, n_active = cur
            pipe.acquire(k)
            self.labels, it, v = _fold_chunk(self.labels, src, dst,
                                             n_active, **self._statics)
            pipe.release(k)
            its += it
            visited = np.float32(visited + v)
        self.iterations += its
        self.visited += float(visited)

    def _contract(self, source: EdgeChunks) -> tuple:
        """Relabel ``source`` to current roots, drop intra-supervertex
        edges, dedup on the unordered root pair — host-side, chunk by
        chunk, so peak host memory is O(chunk + survivors)."""
        L = self.labels.cpu().numpy()
        parts_s, parts_d = [], []
        for s, d in source:
            rs, rd = L[s], L[d]
            keep = rs != rd
            if keep.any():
                parts_s.append(rs[keep].astype(np.int64))
                parts_d.append(rd[keep].astype(np.int64))
        if not parts_s:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        rs = np.concatenate(parts_s)
        rd = np.concatenate(parts_d)
        lo = np.minimum(rs, rd)
        hi = np.maximum(rs, rd)
        _, first = np.unique(lo * np.int64(self.n_vertices) + hi,
                             return_index=True)
        first.sort()  # keep the stream order of first occurrences
        return rs[first].astype(np.int32), rd[first].astype(np.int32)

    def run_round(self) -> dict:
        """Stream every surviving chunk, then contract host-side.

        Returns the round record ``{"round", "edges_in", "survivors",
        "chunks"}`` and flips :attr:`finished_streaming` once the
        survivors fit the chunk bucket (or the round cap is spent).
        """
        if self.finished_streaming:
            raise RuntimeError("streaming already finished; call finish()")
        if self.fault_injector is not None:
            self.fault_injector.maybe_fail(self.round_index, "oocore_round")
        source = self._round_source()
        edges_in = source.n_edges
        self._stream(source)
        ssrc, sdst = self._contract(source)
        self.survivors_src, self.survivors_dst = ssrc, sdst
        n_surv = int(ssrc.shape[0])
        prev = self.round_counts[-1] if self.round_counts else None
        self.round_counts.append(n_surv)
        self.round_index += 1
        if n_surv <= self.bucket:
            self.finished_streaming = True
        elif self.round_index >= self.round_cap or (prev is not None
                                                    and n_surv >= prev):
            # cap spent (or, defensively, a round that made no progress —
            # impossible while survivors are inter-root, but never spin
            # on a broken invariant): finish in-core anyway.  Labels stay
            # correct; only the memory bound is waived, and provenance
            # records the waiver.
            self.finished_streaming = True
            self.round_cap_exhausted = True
        return {"round": self.round_index - 1, "edges_in": edges_in,
                "survivors": n_surv, "chunks": source.n_chunks}

    def finish(self):
        """In-core finish on the surviving edges, warm-started from the
        resident labels (monotone min-mapping labels make any
        intermediate state a valid init).  Returns the registry 4-tuple
        ``(labels, iterations, converged, edges_visited)``, the last three
        0-d tensors on the engine's device.
        """
        if not self.finished_streaming:
            raise RuntimeError("streaming rounds still pending; call "
                               "run_round() until finished_streaming")

        def counters(done):
            return (torch.tensor(self.iterations, dtype=torch.int32,
                                 device=self.device),
                    torch.as_tensor(done, device=self.device),
                    torch.tensor(self.visited, dtype=torch.float32,
                                 device=self.device))

        if int(self.survivors_src.shape[0]) == 0:
            # every edge retired: the star forest is the global fixpoint
            self.labels = fr.compress_full(
                self.labels, cv.loop_ops(self.backend).pointer_jump)
            return (self.labels, *counters(True))
        from repro_torch.connectivity.solvers import _contour_solver
        graph = Graph.from_numpy(self.survivors_src, self.survivors_dst,
                                 self.n_vertices, device=self.device)
        finish_opts = self.opts.replace(
            algorithm="contour", warm_start=None,
            # the handoff keeps the caller's frontier schedule; dense
            # callers still get periodic contraction — the survivors are
            # exactly the frontier, contracting them is the whole point
            compact_every=self.opts.compact_every or 1,
            max_iters=self.opts.max_iters or 100_000)
        # [:4] drops the provenance tuple the contour solver appends
        labels, it, done, visited = _contour_solver(graph, finish_opts,
                                                    self.labels)[:4]
        self.labels = labels
        self.iterations += int(it)
        self.visited += float(visited)
        return (labels, *counters(done))

    def run(self):
        """Rounds to the handoff point, then the in-core finish."""
        while not self.finished_streaming:
            self.run_round()
        return self.finish()

    # -- reporting -------------------------------------------------------
    def peak_bytes_estimate(self) -> int:
        bucket = self.bucket
        if self.round_cap_exhausted and self.survivors_src is not None:
            # waived bound: the forced finish materialised the survivors
            bucket = max(bucket,
                         _planner.next_pow2(self.survivors_src.shape[0]))
        return estimate_peak_bytes(self.n_vertices, bucket)

    def round_provenance(self) -> tuple:
        """The oocore-specific provenance entries — without the plan
        entry, which the registry solver and :func:`solve_chunks` add."""
        entries = [f"oocore:rounds={len(self.round_counts)} "
                   f"bucket={self.bucket} "
                   f"decay={','.join(map(str, self.round_counts))}"]
        if self.round_cap_exhausted:
            entries.append("oocore_round_cap_exhausted")
        return tuple(entries)

    def provenance(self) -> tuple:
        return (self.plan.provenance_entry(),) + self.round_provenance()


def oocore_labels(chunks, options: Optional[SolveOptions] = None,
                  *, init_labels=None, device: DeviceLike = None,
                  **overrides):
    """Functional form: solve an :class:`EdgeChunks` source out-of-core.

    Returns the registry 4-tuple plus a 5th element, the round
    provenance; :func:`solve_chunks` wraps everything in a
    :class:`ComponentResult`.
    """
    engine = OutOfCoreContraction(chunks, options, init_labels=init_labels,
                                  device=device, **overrides)
    return engine.run() + (engine.round_provenance(),)


def solve_chunks(chunks, options: Optional[SolveOptions] = None,
                 *, warm_start=None, device: DeviceLike = None,
                 **overrides) -> ComponentResult:
    """``solve()`` for edge streams: the out-of-core facade entry.

    Example::

        chunks = rmat_chunks(scale=26, edge_factor=16, chunk_edges=1 << 20)
        result = solve_chunks(chunks)        # never holds all edges

    ``warm_start``/``SolveOptions`` behave as in ``solve()``; the resolved
    plan (including the chunk bucket) and the per-round survivor decay
    land in ``result.provenance``.  ``device`` holds the labels and the
    chunk buffers (``cuda`` unless named).
    """
    engine = OutOfCoreContraction(chunks, options, init_labels=warm_start,
                                  device=device, **overrides)
    labels, iterations, converged, visited = engine.run()
    return make_result(labels, iterations, converged, visited,
                       provenance=engine.provenance())
