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

The reference's ``resilient_distributed_contour`` (elastic
shrink-and-resume over a device mesh) and ``_elastic_edge_axes`` come
with the distributed slice (ROADMAP Queue A item 6).  There is no kernel
fallback: a CUDA error is not in the recoverable set by default, and it
propagates.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple, Type

from repro_torch.connectivity.oocore import OutOfCoreContraction
from repro_torch.connectivity.options import SolveOptions
from repro_torch.connectivity.result import ComponentResult
from repro_torch.connectivity.solve import make_result
from repro_torch.connectivity.streaming import StreamingConnectivity
from repro_torch.graphs.structs import DeviceLike
from repro_torch.runtime.recovery import (FaultInjector, SimulatedFault,
                                          backoff_delay)
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
