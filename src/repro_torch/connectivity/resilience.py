"""Fault tolerance for the port's connectivity stack.

The port's counterpart of ``repro.connectivity.resilience`` (DESIGN.md
§12): the crash-restart loops that wire ``runtime.recovery`` and
``checkpoint`` into the single-device solvers.

* :func:`stream_with_recovery` — a crash-restart loop around
  :class:`~repro_torch.connectivity.streaming.StreamingConnectivity`:
  periodic atomic checkpoints of the full engine state through
  ``CheckpointManager``'s write-to-tmp-then-rename protocol,
  restore-on-failure with a bounded retry budget and exponential
  backoff, and replay of only the batches ingested after the last
  committed checkpoint.  Recovery is bit exact: ingest is deterministic
  and atomic, so replaying the uncommitted suffix from a snapshot lands
  on exactly the state a fault-free run produces.  A
  :class:`~repro_torch.runtime.straggler.StragglerMonitor` can force a
  snapshot when batches are persistently slow.

* :func:`oocore_with_recovery` — round-boundary checkpoint recovery for
  the out-of-core multi-round solver (``connectivity.oocore``): a
  mid-round crash restores labels + the surviving-chunk manifest from
  the last committed round and replays one round, not the stream (exact
  because chunk sources are pure functions of the chunk index).

* :func:`resilient_distributed_contour` — the distributed solve
  (``connectivity.distributed``) in blocks of rounds that survives the
  loss of ranks by an elastic shrink: the mesh is re-derived over the
  surviving ranks (``runtime.elastic``) and the solve resumes warm from
  the last committed labels.  It runs SPMD: every rank of the mesh calls
  it with the same arguments and runs the same block loop (its rules are
  in the function's docstring).

There is no kernel fallback: a CUDA error is not in the recoverable set
by default, and it propagates.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple, Type

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.connectivity import distributed as dist_cc
from repro_torch.connectivity import solvers as _solvers
from repro_torch.connectivity.oocore import OutOfCoreContraction
from repro_torch.connectivity.options import SolveOptions
from repro_torch.connectivity.result import ComponentResult
from repro_torch.connectivity.solve import make_result, resolve_warm_start
from repro_torch.connectivity.streaming import StreamingConnectivity
from repro_torch.graphs.structs import DeviceLike, Graph
from repro_torch.runtime.elastic import elastic_mesh
from repro_torch.runtime.mesh import Mesh
from repro_torch.runtime.recovery import (FaultInjector, ShardLossFault,
                                          SimulatedFault, backoff_delay)
from repro_torch.runtime.straggler import StragglerMonitor


def stream_with_recovery(
    batches: Sequence[tuple],
    n_vertices: int,
    manager,
    options: Optional[SolveOptions] = None,
    *,
    checkpoint_every: int = 8,
    max_restarts: int = 5,
    fault_injector: Optional[FaultInjector] = None,
    straggler: Optional[StragglerMonitor] = None,
    recoverable: Tuple[Type[BaseException], ...] = (SimulatedFault,),
    backoff_base: float = 0.0,
    backoff_factor: float = 2.0,
    backoff_cap: float = 30.0,
    sleep_fn: Callable[[float], None] = time.sleep,
    on_event: Optional[Callable[[str, int], None]] = None,
    device: DeviceLike = None,
    **overrides,
) -> tuple[StreamingConnectivity, dict]:
    """Stream ``batches`` through a checkpointed engine with recovery.

    Args:
      batches: seekable sequence of ``(src, dst)`` or
        ``(src, dst, n_vertices)`` micro-batches — batch ``k`` must be a
        pure function of ``k`` (the replay half of exact recovery; the
        atomic checkpoints are the other half).
      n_vertices: initial vertex count for a cold start.
      manager: a :class:`~repro_torch.checkpoint.manager.
        CheckpointManager`.  If it already holds a checkpoint, the stream
        *resumes* from it (crash-restart across processes) and earlier
        batches are never re-ingested.
      options / overrides: engine :class:`SolveOptions`, as for
        :class:`StreamingConnectivity`.
      checkpoint_every: snapshot cadence in committed batches; the final
        batch always checkpoints.
      fault_injector: consulted by ``ingest`` at its ``"pre"`` /
        ``"post_write"`` sites (see streaming) — chaos-testing hook.
      straggler: optional monitor fed per-batch wall time; a
        ``"checkpoint"``/``"evict"`` escalation forces an immediate
        snapshot regardless of cadence.
      recoverable: exception types that trigger restore-and-retry;
        anything else propagates after rolling the engine back (ingest
        is atomic, so the engine stays queryable).
      max_restarts: total restart budget; exceeding it re-raises.
      backoff_*: exponential backoff between restarts (0 = none);
        ``sleep_fn`` is injectable for tests.
      device: where the engine lives (``cuda`` unless named).

    Returns ``(engine, stats)`` with
    ``stats = {"restarts", "checkpoints", "replayed_batches",
    "straggler_events"}``.
    """
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got "
                         f"{checkpoint_every}")
    stats = {"restarts": 0, "checkpoints": 0, "replayed_batches": 0,
             "straggler_events": 0}

    def fresh():
        return StreamingConnectivity(n_vertices, options,
                                     fault_injector=fault_injector,
                                     device=device, **overrides)

    def restored():
        return StreamingConnectivity.restore(
            manager, options, fault_injector=fault_injector, device=device,
            **overrides)

    if manager.latest_step() is not None:
        eng, start = restored()
    else:
        eng, start = fresh(), 0

    n_batches = len(batches)
    restarts = 0
    b = start
    while b < n_batches:
        try:
            if straggler is not None:
                straggler.start_step()
            eng.ingest(*batches[b])
            action = straggler.end_step() if straggler is not None else "ok"
            committed = b + 1
            forced = action in ("checkpoint", "evict")
            if forced:
                stats["straggler_events"] += 1
                if on_event:
                    on_event(f"straggler_{action}", b)
            if committed % checkpoint_every == 0 or committed == n_batches \
                    or forced:
                eng.save(manager, committed)
                manager.wait()
                stats["checkpoints"] += 1
            b += 1
        except recoverable:
            restarts += 1
            stats["restarts"] += 1
            if on_event:
                on_event("restart", b)
            if restarts > max_restarts:
                raise
            delay = backoff_delay(restarts, base=backoff_base,
                                  factor=backoff_factor, cap=backoff_cap)
            if delay > 0:
                sleep_fn(delay)
            if manager.latest_step() is None:
                eng, resume = fresh(), 0
            else:
                eng, resume = restored()
            stats["replayed_batches"] += b - resume
            b = resume
    return eng, stats


def oocore_with_recovery(
    chunks,
    manager,
    options: Optional[SolveOptions] = None,
    *,
    max_restarts: int = 5,
    fault_injector: Optional[FaultInjector] = None,
    recoverable: Tuple[Type[BaseException], ...] = (SimulatedFault,),
    backoff_base: float = 0.0,
    backoff_factor: float = 2.0,
    backoff_cap: float = 30.0,
    sleep_fn: Callable[[float], None] = time.sleep,
    on_event: Optional[Callable[[str, int], None]] = None,
    device: DeviceLike = None,
    **overrides,
) -> tuple[ComponentResult, dict]:
    """Out-of-core solve with round-boundary checkpoint recovery.

    Drives :class:`~repro_torch.connectivity.oocore.OutOfCoreContraction`
    one round at a time, checkpointing at every round boundary (labels +
    the surviving-chunk manifest — the engine's ``state_dict``) through
    ``manager``'s atomic write-to-tmp-then-rename protocol.  A
    ``recoverable`` fault mid-round restores the last committed round
    boundary and replays *that round only*; a fault inside round 0
    replays round 0 from the source, which is exact because chunk
    sources are pure functions of the chunk index.

    If ``manager`` already holds a checkpoint the solve *resumes* from it
    (crash-restart across processes).  ``device`` holds the engine
    (``cuda`` unless named).  Returns ``(result, stats)`` with ``stats``
    a :class:`RecoveryStats` holding ``restarts``, ``checkpoints``,
    ``replayed_rounds`` and ``rounds``.
    """
    eng = OutOfCoreContraction(chunks, options,
                               fault_injector=fault_injector,
                               device=device, **overrides)
    if manager.latest_step() is not None:
        eng.restore(manager)
    stats = RecoveryStats(restarts=0, checkpoints=0, replayed_rounds=0,
                          rounds=0)
    restarts = 0
    while not eng.finished_streaming:
        at_round = eng.round_index
        try:
            eng.run_round()
            eng.save(manager)
            manager.wait()
            stats["checkpoints"] += 1
            stats["rounds"] += 1
        except recoverable:
            restarts += 1
            stats["restarts"] += 1
            if on_event:
                on_event("restart", at_round)
            if restarts > max_restarts:
                raise
            delay = backoff_delay(restarts, base=backoff_base,
                                  factor=backoff_factor, cap=backoff_cap)
            if delay > 0:
                sleep_fn(delay)
            if manager.latest_step() is not None:
                eng.restore(manager)
            else:
                eng.reset()   # round-0 fault: replay the source
            stats["replayed_rounds"] += 1
    labels, iterations, converged, visited = eng.finish()
    result = make_result(labels, iterations, converged, visited,
                         provenance=eng.provenance())
    return result, stats


class RecoveryStats(dict):
    """Stats of a recovering solve (dict with attr access)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc


def _elastic_edge_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Edge-sharding axes of an ``elastic_mesh``: everything but model."""
    return tuple(a for a in mesh.axis_names if a != "model")


# the straggler monitor's ladder, least to most severe
_ACTIONS = ("ok", "warn", "checkpoint", "evict")


def _mesh_max(mesh: Mesh, value: int) -> int:
    """The largest ``value`` over the mesh's ranks (an ``all_reduce(MAX)``
    over every axis, read on the host); also a barrier."""
    t = torch.tensor([value], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX,
                    group=mesh.group(mesh.axis_names))
    return int(t.item())


def resilient_distributed_contour(
    graph: Graph,
    devices: Optional[Sequence[int]] = None,
    options: Optional[SolveOptions] = None,
    *,
    mesh: Optional[Mesh] = None,
    block_rounds: int = 8,
    max_restarts: int = 5,
    fault_injector: Optional[FaultInjector] = None,
    manager=None,
    straggler: Optional[StragglerMonitor] = None,
    model_parallel: int = 1,
    prefer_pods: int = 1,
    backoff_base: float = 0.0,
    sleep_fn: Callable[[float], None] = time.sleep,
    on_event: Optional[Callable[[str, int], None]] = None,
    device: DeviceLike = None,
    **overrides,
) -> tuple[ComponentResult, RecoveryStats]:
    """Distributed Contour that survives rank loss via elastic shrink.

    Runs :func:`~repro_torch.connectivity.distributed.distributed_contour`
    in blocks of at most ``block_rounds`` global rounds over ``mesh``
    (default: ``elastic_mesh(model_parallel, devices, prefer_pods)`` over
    the ranks ``devices``, default every rank of the world, with
    ``device`` each rank's device).  Between blocks the
    ``fault_injector`` is consulted at site ``"round"`` (in production:
    the collective's failure detector):

    * :class:`ShardLossFault` — drop the lost rank(s), re-derive a smaller
      mesh over the survivors ``devices[:-n_lost]`` (``elastic_mesh``;
      the next block re-shards the edges), and resume warm from the last
      good labels.  Sound because min-mapping labels are monotone
      non-increasing with ``L[v]`` always inside ``v``'s component, so
      any stale snapshot is a valid ``init_labels``.
    * any other :class:`SimulatedFault` — plain warm restart on the same
      mesh (from ``manager``'s last checkpoint when given, else the
      in-memory labels), with exponential backoff.

    A ``straggler`` monitor escalates per the ladder in
    ``runtime.straggler``: ``"checkpoint"`` forces a label snapshot (when
    ``manager`` is given), ``"evict"`` drops one rank and shrinks — both
    recorded in the stats' events and the result's provenance.

    The SPMD rules.  Every rank of the mesh calls this with the same
    arguments and runs the same block loop, so every rank issues the
    same collectives:

    * the ``fault_injector`` is deterministic, so every rank sees the
      same faults at the same blocks and all shrink together; the
      survivors are a prefix of ``devices``, so the mesh's first rank
      always survives;
    * a rank shed from the mesh (or outside it from the start: the
      surplus of ``elastic_mesh``) leaves the loop and returns the result
      of its last committed block, with ``stats["shed"]`` the block at
      which it left;
    * only the mesh's first rank writes through ``manager`` (every rank
      counts the checkpoint in its stats), and every rank restores from
      it after a barrier over the mesh, so no rank reads a checkpoint
      before it is written;
    * the straggler's action is the most severe one any rank of the mesh
      recommends (an ``all_reduce(MAX)``), so all ranks act alike.

    Returns ``(result, stats)``; ``result.converged`` is True iff the
    fixed point was reached within ``options.max_iters`` total rounds
    across every block and restart.
    """
    opts = options if options is not None else SolveOptions()
    if overrides:
        opts = opts.replace(**overrides)
    opts.validate()
    if devices is None:
        devices = (list(mesh.devices.flat) if mesh is not None
                   else list(range(dist.get_world_size())))
    devices = [int(r) for r in devices]
    if mesh is None:
        mesh = elastic_mesh(model_parallel, devices, prefer_pods,
                            device=device)
        edge_axes = _elastic_edge_axes(mesh)
    else:
        edge_axes = tuple(opts.edge_axes)
    rank_device = mesh.device
    max_total = opts.max_iters if opts.max_iters is not None else 10_000

    stats = RecoveryStats(restarts=0, shrinks=0, checkpoints=0, blocks=0,
                          mesh_history=[tuple(mesh.devices.shape)],
                          events=[])
    # one plan for the whole solve: shrinks change the mesh, not the
    # graph's size; it leads the provenance trail
    plan = _solvers.resolve_backend_plan(graph.n_vertices, graph.n_edges,
                                         rank_device, opts)
    provenance: list = [plan.provenance_entry()]
    L = resolve_warm_start(opts.warm_start, graph.n_vertices)

    def restore() -> torch.Tensor:
        state, _ = manager.restore({"labels": np.int64(0)})
        return torch.as_tensor(state["labels"]).to(device=rank_device,
                                                   dtype=torch.int32)

    if manager is not None and manager.latest_step() is not None:
        L = restore()
    iterations = 0
    visited = 0.0
    done = False
    restarts = 0
    block = 0

    def record(event: str):
        stats["events"].append((event, block))
        if on_event:
            on_event(event, block)

    def shrink(n_lost: int, reason: str):
        nonlocal devices, mesh, edge_axes
        survivors = devices[:-n_lost] if n_lost else devices
        new_mesh = elastic_mesh(model_parallel, survivors, prefer_pods,
                                device=rank_device)
        provenance.append(f"{reason}:{len(devices)}->{len(survivors)}")
        devices = survivors
        mesh = new_mesh
        edge_axes = _elastic_edge_axes(mesh)
        stats["shrinks"] += 1
        stats["mesh_history"].append(tuple(mesh.devices.shape))
        record(reason)

    def result() -> ComponentResult:
        labels = (L if L is not None else
                  torch.arange(graph.n_vertices, dtype=torch.int32,
                               device=rank_device))
        return make_result(labels, iterations, done, visited,
                           provenance=provenance)

    while not done and iterations < max_total:
        if mesh.coordinate is None:
            # shed (or never in the mesh): this rank's part ends here
            stats["shed"] = block
            break
        try:
            if fault_injector is not None:
                fault_injector.maybe_fail(block, "round")
            if straggler is not None:
                straggler.start_step()
            labels, it, ok, v = dist_cc.distributed_contour(
                graph, mesh,
                edge_axes=edge_axes,
                local_rounds=opts.local_rounds,
                max_iters=min(block_rounds, max_total - iterations),
                async_compress=opts.async_compress,
                backend=plan.backend,
                plan=plan,
                init_labels=L,
                sampling=opts.sampling,
                compact_every=opts.compact_every)
            action = (straggler.end_step() if straggler is not None
                      else "ok")
            if straggler is not None:
                action = _ACTIONS[_mesh_max(mesh, _ACTIONS.index(action))]
        except ShardLossFault as exc:
            restarts += 1
            stats["restarts"] += 1
            if restarts > max_restarts:
                raise
            shrink(exc.n_lost, "elastic_shrink")
            continue
        except SimulatedFault:
            restarts += 1
            stats["restarts"] += 1
            if restarts > max_restarts:
                raise
            delay = backoff_delay(restarts, base=backoff_base)
            if delay > 0:
                sleep_fn(delay)
            if manager is not None:
                _mesh_max(mesh, 0)  # the first rank's writes are done
                if manager.latest_step() is not None:
                    L = restore()
            record("restart")
            continue
        # commit the block: monotone labels make every block's output a
        # valid warm start for the next
        L = labels
        iterations += int(it)
        visited += float(v)
        done = bool(ok)
        stats["blocks"] += 1
        if manager is not None and (action in ("checkpoint", "evict")
                                    or done):
            if mesh.rank == int(mesh.devices.flat[0]):
                manager.save(block, {"labels": L})
                manager.wait()
            stats["checkpoints"] += 1
            if action == "checkpoint":
                record("straggler_checkpoint")
        if action == "evict" and len(devices) - 1 >= model_parallel:
            shrink(1, "straggler_evict")
        block += 1

    return result(), stats
