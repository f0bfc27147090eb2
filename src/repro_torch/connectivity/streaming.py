"""Streaming incremental connectivity over edge micro-batches.

The port's counterpart of ``repro.connectivity.streaming`` (DESIGN.md
§11).  :class:`StreamingConnectivity` ingests a stream of edge batches
and keeps the component labels queryable after every batch, with
per-batch work that tracks the batch, not the accumulated ``m``:

* **Delta re-convergence on the supervertex graph.**  Between batches
  the label array is a star-forest fixed point of everything ingested so
  far.  Each batch edge is first rewritten to its endpoints' current
  roots ``(L[u], L[v])`` — sweeping the original endpoints is unsound
  (two batch edges can redirect a shared non-root vertex and its root
  with different values in one synchronous sweep, and the old edges are
  never reswept); after the rewrite every endpoint is a root of the warm
  star forest, so the delta solve is ordinary Contour on the supervertex
  graph.  The batch then runs the masked frontier of
  ``connectivity.frontier`` with ``active_m0`` = the batch's real size
  (its padded tail is never swept), on the sweep kernels of the chosen
  backend, and ends with a full pointer-jump compression.

* **Ring-buffered edge store.**  Ingested edges land in a growable
  edge store on the device (capacity a power of two, doubled as needed,
  free space filled with self-loop no-op edges); batches are padded to a
  power of two.  The store is written in place; :meth:`state_dict`
  copies it, so a held state dict (a background checkpoint, a test)
  keeps the edges of its own moment.  The store exists for
  :meth:`graph`/:meth:`resolve`; queries never touch it.

* **Snapshots.**  Labels are converged between batches, so
  :meth:`snapshot` wraps them in a :class:`ComponentResult`.

The label array is held at a power-of-two capacity, with identity labels
past the logical ``n``, and both arrays grow on the reference's
schedule, so :meth:`state_dict` is the reference's bit for bit and a
checkpoint of either package restores in the other.

The counters (``iterations`` int32, ``converged`` bool,
``edges_visited`` float32, added in float32 as the reference adds them)
accumulate as 0-d tensors on the device.  The reference's delta solve
reads nothing on the host; the port's masked frontier reads its
convergence flag once an iteration, its survivor count once a
contraction and its star-forest flag once a round of the final
compression.  Out-of-range ids never reach an index on the card: the
batch check (``validate=True``) and the query checks run on the host
first, since a CUDA gather out of range raises a device-side assert that
poisons the context.

With ``SolveOptions.mesh`` each batch's delta solve is
``distributed.distributed_edges`` over the root-rewritten batch, warm
from the resident labels, with ``n_active`` the batch's real size: every
rank of the mesh runs its own engine on the same batches (SPMD), each
holding the replicated labels on its own device (``mesh.device``, the
engine's device unless one is named).

The reference's kernel fallback is not ported: a kernel that fails in an
ingest raises through the rollback to the caller, and is never retried
on the plain path.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch import trace
from repro_torch.connectivity import distributed as dist_cc
from repro_torch.connectivity import frontier as fr
from repro_torch.connectivity import minmap as lab
from repro_torch.connectivity.contour import _make_step
from repro_torch.connectivity.options import SolveOptions
from repro_torch.connectivity.result import ComponentResult
from repro_torch.connectivity.solve import (_resolve, make_result,
                                            resolve_warm_start, solve)
from repro_torch.connectivity.solvers import resolve_backend_plan
from repro_torch.graphs.structs import DeviceLike, Graph, resolve_device
from repro_torch.kernels.contour_mm import converged as cv
from repro_torch.runtime.recovery import FaultInjector

# Smallest edge-store capacity / batch padding bucket (power of two).
MIN_CAPACITY = 64


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(0, x - 1).bit_length()


def delta_converge(
    src: torch.Tensor,
    dst: torch.Tensor,
    labels: torch.Tensor,
    n_active: int,
    *,
    variant: str = "C-2",
    backend: str = "torch",
    fuse: bool = True,
    warmup: int = 2,
    async_compress: int = 1,
    sampling: int = 0,
    compact_every: int = 1,
    max_iters: int = 100_000,
):
    """Re-converge ``labels`` after a new edge micro-batch.

    The core of :class:`StreamingConnectivity`: rewrite the batch
    ``(src, dst)`` to its endpoints' current roots, sweep its first
    ``n_active`` edges warm-started from ``labels`` — which must be a
    star-forest fixed point of everything before the batch — under the
    work-adaptive frontier, and return ``(labels', iterations, converged,
    edges_visited)`` with ``labels'`` compressed back to a star forest:
    an int, a bool and a numpy float32 beside the labels.  ``backend``
    and ``fuse`` pick the sweep kernel (``ops.mm_relax_backend``); the
    frontier's test and jump round follow the backend
    (``converged.loop_ops``).
    """
    # supervertex rewrite: labels is a star forest, so L[u] is u's root
    src = labels[src]
    dst = labels[dst]
    step = _make_step(variant, warmup, async_compress, backend, fuse)
    return fr.adaptive_fixpoint(
        src, dst, labels, step,
        n_vertices=int(labels.shape[0]),
        sampling=sampling,
        compact_every=compact_every,
        max_iters=max_iters,
        active_m0=n_active,
        loop=cv.loop_ops(backend))


def _as_tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A copy of ``x`` (tensor, numpy array or scalar) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype, copy=True)
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


class StreamingConnectivity:
    """Incremental connectivity engine over a stream of edge batches.

    Example::

        eng = StreamingConnectivity(n_vertices=1_000_000)   # on cuda
        for src, dst in edge_batches:
            eng.ingest(src, dst)
            eng.same_component(0, 42)       # no re-solve
        final = eng.snapshot()              # ComponentResult

    Args:
      n_vertices: initial vertex count (``ingest(..., n_vertices=...)``
        grows it later).
      options: a :class:`SolveOptions`; must name a streaming-capable
        solver (Contour, any async variant; ``C-Syn`` is rejected).  If
        neither ``sampling`` nor ``compact_every`` is set, the engine
        defaults to ``compact_every=1`` so merged batch edges retire
        immediately.
      warm_start: labels (or a :class:`ComponentResult`) to seed from.
        Compressed to a star forest on entry.
      min_capacity: initial edge-store capacity (rounded up to a power
        of two).
      store_edges: keep every ingested edge in the device-resident store
        (enables :meth:`graph` and :meth:`resolve`).  ``False`` bounds
        the engine's memory at O(n).
      fault_injector: optional :class:`~repro_torch.runtime.recovery.
        FaultInjector` consulted inside :meth:`ingest` at sites ``"pre"``
        (before the delta solve) and ``"post_write"`` (after the store
        write, before the commit).
      device: where the labels, store and counters live; ``cuda``
        unless named (tests pass ``"cpu"``), or the mesh's device with
        ``SolveOptions.mesh``.
      **overrides: per-field :class:`SolveOptions` overrides, as for
        ``solve()``.
    """

    # the checkpointable state (see state_dict); the reference's key set
    _STATE_KEYS = ("labels", "src", "dst", "m", "n", "n_cap", "n_batches",
                   "iterations", "converged", "edges_visited",
                   "store_edges")

    def __init__(
        self,
        n_vertices: int,
        options: Optional[SolveOptions] = None,
        *,
        warm_start: Union[None, ComponentResult, torch.Tensor] = None,
        min_capacity: int = MIN_CAPACITY,
        store_edges: bool = True,
        fault_injector: Optional[FaultInjector] = None,
        device: DeviceLike = None,
        **overrides,
    ):
        opts, spec = _resolve(options, overrides)
        if not spec.supports_streaming:
            raise ValueError(
                f"solver {spec.name!r} does not support streaming; use "
                "algorithm='contour' (delta resweeps are a minimum-mapping "
                "property)")
        if opts.variant == "C-Syn":
            raise ValueError(
                "C-Syn is the Alg.-1-verbatim reference and rejects the "
                "frontier schedule the streaming engine is built on; use "
                "C-2/C-m (any async variant — the supervertex rewrite "
                "makes every order sound, see DESIGN.md §11)")
        if opts.sampling == 0 and opts.compact_every == 0:
            # the delta IS the frontier: contract merged batch edges away
            # every iteration by default
            opts = opts.replace(compact_every=1)
        self._opts = opts
        self._spec = spec
        self._device = (opts.mesh.device
                        if opts.mesh is not None and device is None
                        else resolve_device(device))
        self._n = int(n_vertices)
        # labels at pow2 capacity: vertices in [n, capacity) are
        # identity-labelled singletons no real edge can touch
        self._n_cap = next_pow2(max(self._n, 1))
        init = resolve_warm_start(
            warm_start if warm_start is not None else opts.warm_start,
            self._n)
        L0 = lab.resolve_init_labels(init, self._n_cap, self._device)
        # engine invariant: labels between batches are a star-forest fixed
        # point (identity already is one; a warm start is only guaranteed
        # L[v]-in-component, so compress)
        loop = cv.loop_ops(self._plan(0, opts).backend)
        self._labels = fr.compress_full(L0, loop) if init is not None else L0

        self._store_edges = bool(store_edges)
        cap = next_pow2(max(int(min_capacity), 1)) if store_edges else 0
        self._src = torch.zeros(cap, dtype=torch.int32, device=self._device)
        self._dst = torch.zeros(cap, dtype=torch.int32, device=self._device)
        self._m = 0                      # real (unpadded) edges ingested
        self._n_batches = 0
        # cumulative counters on the device
        self._iterations = torch.zeros((), dtype=torch.int32,
                                       device=self._device)
        self._converged = torch.ones((), dtype=torch.bool,
                                     device=self._device)
        self._edges_visited = torch.zeros((), dtype=torch.float32,
                                          device=self._device)
        self._snap: Optional[ComponentResult] = None
        self._n_components: Optional[tuple] = None  # (snapshot, count)
        self.fault_injector = fault_injector
        # the resolved plan of each distinct per-batch resolution,
        # surfaced through snapshot().provenance
        self._provenance: list = []
        self._last_plan_entry: Optional[str] = None

    # -- introspection ---------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self._n

    @property
    def n_edges(self) -> int:
        """Real (unpadded) edges ingested so far."""
        return self._m

    @property
    def n_batches(self) -> int:
        return self._n_batches

    @property
    def capacity(self) -> int:
        """Current edge-store capacity (power of two)."""
        return int(self._src.shape[0])

    @property
    def vertex_capacity(self) -> int:
        """Label-array capacity (power of two; growth within it is free)."""
        return self._n_cap

    @property
    def options(self) -> SolveOptions:
        return self._opts

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def labels(self) -> torch.Tensor:
        """Converged labels on the device (min vertex id per component),
        trimmed to the logical vertex count."""
        return self._labels[:self._n]

    def graph(self) -> Graph:
        """The accumulated edge list as a :class:`Graph` (store view)."""
        if not self._store_edges:
            raise ValueError(
                "this engine was built with store_edges=False; the edge "
                "history was not kept")
        return Graph(src=self._src[:self._m], dst=self._dst[:self._m],
                     n_vertices=self._n)

    def _plan(self, n_edges: int, opts: SolveOptions):
        # the delta solve always runs the masked frontier
        return resolve_backend_plan(self._n_cap, n_edges, self._device,
                                    opts).replace(compact_schedule="masked")

    # -- ingestion -------------------------------------------------------
    def _grow_vertices(self, n: int) -> None:
        if n < self._n:
            raise ValueError(
                f"n_vertices={n} shrinks the stream (was {self._n})")
        if n > self._n:
            # within capacity the new vertices already sit
            # identity-labelled past the logical n; past it the label
            # array doubles
            if n > self._n_cap:
                new_cap = next_pow2(n)
                self._labels = torch.cat(
                    [self._labels,
                     torch.arange(self._n_cap, new_cap, dtype=torch.int32,
                                  device=self._device)])
                self._n_cap = new_cap
            self._n = n
            # growth alone changes query results (new singletons)
            self._snap = None

    def _ensure_capacity(self, need: int) -> None:
        cap = self.capacity
        if need <= cap:
            return
        new_cap = next_pow2(need)
        for name in ("_src", "_dst"):
            grown = torch.zeros(new_cap, dtype=torch.int32,
                                device=self._device)
            grown[:cap] = getattr(self, name)
            setattr(self, name, grown)

    def _validate_batch(self, src, dst) -> None:
        # out-of-range ids must never reach an index on the card (a
        # device-side assert poisons the context); numpy input is checked
        # on the host, device input with one read of its bounds
        if isinstance(src, torch.Tensor):
            bounds = torch.stack([torch.minimum(src.min(), dst.min()),
                                  torch.maximum(src.max(), dst.max())])
            with trace.span("read.batch_bounds"):
                lo, hi = bounds.tolist()
        else:
            hi = int(max(src.max(), dst.max()))
            lo = int(min(src.min(), dst.min()))
        if hi >= self._n:
            raise ValueError(
                f"edge endpoint {hi} >= n_vertices={self._n}; pass "
                "n_vertices= to grow the stream")
        if lo < 0:
            raise ValueError("edge endpoints must be >= 0")

    def _pad_batch(self, x, pad_k: int) -> torch.Tensor:
        """The batch as int32 on the device, padded to ``pad_k`` with
        vertex 0 (self-loop no-op edges)."""
        out = torch.zeros(pad_k, dtype=torch.int32, device=self._device)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
        out[:x.shape[0]] = x.to(device=self._device, dtype=torch.int32)
        return out

    def ingest(self, src, dst, n_vertices: Optional[int] = None,
               validate: bool = True) -> "StreamingConnectivity":
        """Ingest one edge micro-batch and re-converge the labels.

        Args:
          src, dst: 1-D arrays or tensors of equal length (each
            undirected edge once; duplicates and self-loops are harmless
            no-ops).  Tensors stay where they are until copied to the
            engine's device; everything else is lifted to numpy.
          n_vertices: optionally grow the vertex set first.
          validate: bounds-check the endpoints first (free for numpy
            input, one read for a tensor).  Disable only for pre-validated
            streams.

        Returns ``self`` (chainable).
        """
        if not isinstance(src, torch.Tensor):
            src = np.asarray(src)
        if not isinstance(dst, torch.Tensor):
            dst = np.asarray(dst)
        if tuple(src.shape) != tuple(dst.shape) or len(src.shape) != 1:
            raise ValueError(
                f"src/dst must be equal-length 1-D, got {tuple(src.shape)} "
                f"vs {tuple(dst.shape)}")
        old_n = self._n
        if n_vertices is not None:
            self._grow_vertices(int(n_vertices))
        k = int(src.shape[0])
        if k == 0:
            return self
        if validate:
            self._validate_batch(src, dst)

        pad_k = next_pow2(k)
        src_p = self._pad_batch(src, pad_k)
        dst_p = self._pad_batch(dst, pad_k)

        # Everything up to the commit below runs inside the rollback
        # guard: vertex growth rolls back on failure (surplus label
        # capacity is invisible identity padding) and store writes only
        # touch slots >= _m, which no reader observes — so ingest is
        # atomic.
        try:
            if self.fault_injector is not None:
                self.fault_injector.maybe_fail(self._n_batches, "pre")
            L, it, done, visited = self._delta_solve(src_p, dst_p, pad_k, k)
            if self._store_edges:
                self._ensure_capacity(self._m + pad_k)
                self._src[self._m:self._m + pad_k] = src_p
                self._dst[self._m:self._m + pad_k] = dst_p
            if self.fault_injector is not None:
                self.fault_injector.maybe_fail(self._n_batches, "post_write")
        except Exception:
            self._n = old_n
            self._snap = None
            raise
        # commit: the store already holds the batch (its padding slots
        # hold self-loops that the next batch overwrites)
        self._m += k
        self._labels = L
        self._iterations = self._iterations + int(it)
        self._converged = self._converged & bool(done)
        # a float32 add, as the reference's (visited is a float32 value)
        self._edges_visited = self._edges_visited + float(visited)
        self._n_batches += 1
        self._snap = None
        return self

    def _record_plan(self, plan) -> None:
        """Append the resolved plan to provenance when it changes."""
        entry = plan.provenance_entry()
        if entry != self._last_plan_entry:
            self._provenance.append(entry)
            self._last_plan_entry = entry
            self._snap = None

    def _delta_solve(self, src_p, dst_p, pad_k: int, k: int):
        opts = self._opts
        plan = self._plan(pad_k, opts)
        self._record_plan(plan)
        if opts.mesh is not None:
            # the supervertex rewrite (delta_converge does it on one
            # device); the padding's self-loops stay self-loops, and the
            # replica spans the label capacity, as the resident labels do
            return dist_cc.distributed_edges(
                self._labels[src_p], self._labels[dst_p], self._n_cap,
                opts.mesh,
                edge_axes=tuple(opts.edge_axes),
                local_rounds=opts.local_rounds,
                max_iters=opts.max_iters,
                async_compress=opts.async_compress,
                backend=plan.backend,
                plan=plan,
                init_labels=self._labels,
                sampling=opts.sampling,
                compact_every=opts.compact_every,
                n_active=k)
        return delta_converge(
            src_p, dst_p, self._labels, k,
            variant=opts.variant,
            backend=plan.backend,
            fuse=plan.fuse_relabel,
            warmup=opts.warmup,
            async_compress=opts.async_compress,
            sampling=opts.sampling,
            compact_every=opts.compact_every,
            max_iters=opts.max_iters)

    def ingest_graph(self, graph: Graph,
                     validate: bool = True) -> "StreamingConnectivity":
        """Ingest a whole :class:`Graph` as one batch (growing vertices)."""
        return self.ingest(graph.src, graph.dst,
                           n_vertices=max(self._n, graph.n_vertices),
                           validate=validate)

    # -- queries (no re-solve) -------------------------------------------
    def snapshot(self) -> ComponentResult:
        """Current components as a :class:`ComponentResult`.

        Labels are already converged, so this wraps the resident arrays;
        ``iterations``/``edges_visited`` are cumulative over the stream
        and ``converged`` is the AND of every batch's fixed-point flag
        (False means some batch exhausted ``max_iters`` — call
        :meth:`resolve` to repair).
        """
        if self._snap is None:
            self._snap = make_result(self._labels[:self._n],
                                     self._iterations, self._converged,
                                     self._edges_visited,
                                     provenance=self._provenance)
        return self._snap

    def _check_query_ids(self, *ids) -> None:
        # host-side bounds check before any index on the card
        for x in ids:
            a = np.asarray(x)
            if np.any(a < 0):
                raise IndexError("vertex ids must be >= 0")
            if a.size and np.any(a >= self._n):
                raise IndexError(
                    f"query vertex id out of range for "
                    f"n_vertices={self._n}; grow the stream with "
                    "ingest(..., n_vertices=...) first")

    def same_component(self, u, v):
        """True iff ``u`` and ``v`` are currently connected."""
        self._check_query_ids(u, v)
        return self.snapshot().same_component(u, v)

    def component_of(self, v):
        """Current component id (min vertex id) of ``v``."""
        self._check_query_ids(v)
        return self.snapshot().component_of(v)

    @property
    def n_components(self) -> int:
        """Number of components: the distinct labels, counted on the
        device (a mark per label and a sum; the reference's ``np.unique``
        over the labels on the host gives the same count), once per
        snapshot."""
        snap = self.snapshot()
        if self._n_components is None or self._n_components[0] is not snap:
            seen = torch.zeros(self._n, dtype=torch.bool, device=self._device)
            seen[snap.labels.long()] = True
            count = seen.sum()
            with trace.span("read.n_components"):
                self._n_components = (snap, int(count))
        return self._n_components[1]

    # -- repair ----------------------------------------------------------
    def resolve(self, max_iters: Optional[int] = None) -> ComponentResult:
        """Full warm-started solve over every stored edge.

        Normally a (cheap) no-op; the repair path when ``snapshot().
        converged`` is False.  It does not inherit the stream's
        ``max_iters`` (``None`` takes the solver's registry default).
        """
        if self._m == 0:
            return self.snapshot()
        res = solve(self.graph(),
                    self._opts.replace(warm_start=None,
                                       max_iters=max_iters),
                    warm_start=self._labels[:self._n])
        # restore the capacity invariant: identity labels past logical n
        self._labels = torch.cat(
            [res.labels.to(torch.int32),
             torch.arange(self._n, self._n_cap, dtype=torch.int32,
                          device=self._device)])
        self._iterations = self._iterations + res.iterations
        self._converged = res.converged.clone()
        if res.edges_visited is not None:
            self._edges_visited = self._edges_visited + res.edges_visited
        self._snap = None
        return self.snapshot()

    # -- checkpointing (DESIGN.md §12) -----------------------------------
    def state_dict(self) -> dict:
        """The engine's complete checkpointable state, as a flat dict.

        The reference's keys and dtypes: the edge store, the labels at
        capacity, the logical sizes (numpy int64), the counters (0-d
        int32, bool and float32 tensors) and ``store_edges`` (numpy
        bool).  The tensors are copies: the store is written in place by
        the next ingest, and a snapshot must keep its moment.
        """
        return {
            "labels": self._labels.clone(),
            "src": self._src.clone(),
            "dst": self._dst.clone(),
            "m": np.int64(self._m),
            "n": np.int64(self._n),
            "n_cap": np.int64(self._n_cap),
            "n_batches": np.int64(self._n_batches),
            "iterations": self._iterations.clone(),
            "converged": self._converged.clone(),
            "edges_visited": self._edges_visited.clone(),
            "store_edges": np.bool_(self._store_edges),
        }

    @classmethod
    def _state_like(cls) -> dict:
        """Key template for ``CheckpointManager.restore``."""
        return {k: np.int64(0) for k in cls._STATE_KEYS}

    def load_state_dict(self, state: dict) -> "StreamingConnectivity":
        """Restore the engine to a :meth:`state_dict` snapshot in place.

        Takes tensors or numpy values (a state dict of either package),
        copies them to the engine's device, and validates the structural
        invariants so a corrupt checkpoint fails loudly.
        """
        missing = set(self._STATE_KEYS) - set(state)
        if missing:
            raise ValueError(f"checkpoint state is missing {sorted(missing)}")
        dev = self._device
        n = int(state["n"])
        n_cap = int(state["n_cap"])
        m = int(state["m"])
        labels = _as_tensor(state["labels"], dev, torch.int32)
        src = _as_tensor(state["src"], dev, torch.int32)
        dst = _as_tensor(state["dst"], dev, torch.int32)
        if tuple(labels.shape) != (n_cap,) or not 0 <= n <= n_cap:
            raise ValueError(
                f"corrupt checkpoint: labels shape {tuple(labels.shape)} vs "
                f"n={n}, n_cap={n_cap}")
        if src.shape != dst.shape or (bool(state["store_edges"])
                                      and m > src.shape[0]):
            raise ValueError(
                f"corrupt checkpoint: edge store {tuple(src.shape)}/"
                f"{tuple(dst.shape)} cannot hold m={m}")
        self._n, self._n_cap, self._m = n, n_cap, m
        self._labels = labels
        self._src, self._dst = src, dst
        self._store_edges = bool(state["store_edges"])
        self._n_batches = int(state["n_batches"])
        self._iterations = _as_tensor(state["iterations"], dev, torch.int32)
        self._converged = _as_tensor(state["converged"], dev, torch.bool)
        self._edges_visited = _as_tensor(state["edges_visited"], dev,
                                         torch.float32)
        self._snap = None
        return self

    def save(self, manager, step: Optional[int] = None) -> int:
        """Checkpoint the stream through ``manager`` (atomic rename).

        ``step`` defaults to :attr:`n_batches`, so "checkpoint step k ==
        resume at batch k".  Returns the step written.
        """
        if step is None:
            step = self._n_batches
        manager.save(int(step), self.state_dict())
        return int(step)

    @classmethod
    def restore(
        cls,
        manager,
        options: Optional[SolveOptions] = None,
        *,
        step: Optional[int] = None,
        fault_injector: Optional[FaultInjector] = None,
        device: DeviceLike = None,
        **overrides,
    ) -> tuple["StreamingConnectivity", int]:
        """Rebuild an engine on ``device`` from a checkpoint written by
        :meth:`save` (by either package).  ``options`` are not
        checkpointed: pass the same ones to resume identically.  Returns
        ``(engine, step)``."""
        state, step = manager.restore(cls._state_like(), step)
        eng = cls(int(state["n"]), options,
                  store_edges=bool(state["store_edges"]),
                  fault_injector=fault_injector, device=device, **overrides)
        eng.load_state_dict(state)
        return eng, int(step)
