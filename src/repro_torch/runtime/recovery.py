"""Crash-restart loop: checkpoint/restore around injected or real faults.

The port's copy of ``repro.runtime.recovery`` (no JAX in it, but the
port imports nothing of the JAX package, so it keeps its own).

``run_with_recovery`` wraps a step function with the full fault-tolerance
loop: periodic checkpoints, restore-on-failure, bounded retries with
exponential backoff.  The ``FaultInjector`` lets tests (and the chaos
example/benchmark) kill arbitrary steps — or arbitrary *sites* within a
step — and assert bit-exact recovery, possible because state is
checkpointed atomically and the replayed inputs are seekable (batch k is
a pure function of k).

The recoverable-exception set is configurable: by default only the
injected :class:`SimulatedFault` triggers a restore (conservative — a
bug should crash loudly), but a production caller passes e.g.
``recoverable=(RuntimeError,)`` so real faults (CUDA runtime
errors, transient I/O) restore from the last checkpoint instead of
propagating with all work lost.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple, Type

from repro_torch.checkpoint.manager import CheckpointManager


class SimulatedFault(RuntimeError):
    """An injected fault (process crash stand-in).

    Deliberately *not* in the transient-kernel-error class
    (:func:`is_transient_error`): a simulated machine fault must be
    handled by checkpoint/restore, never silently absorbed by the
    kernel-fallback path.
    """


class ShardLossFault(SimulatedFault):
    """Simulated loss of ``n_lost`` device shard(s) mid-solve.

    Raised by a :class:`FaultInjector` (via ``exc_factory``) between
    rounds of a distributed solve; the elastic solver
    (``connectivity.resilience.resilient_distributed_contour``) reacts by
    re-deriving a smaller mesh over the surviving ranks and
    warm-restarting from the last good labels.
    """

    def __init__(self, n_lost: int = 1, message: str = ""):
        super().__init__(message or f"simulated loss of {n_lost} shard(s)")
        self.n_lost = int(n_lost)


# Exception classes that signal a caller bug (bad arguments, shape/type
# mismatch) rather than a transient fault; retrying or falling back on
# these would mask the bug.
NON_TRANSIENT_ERRORS: Tuple[Type[BaseException], ...] = (
    ValueError, TypeError, KeyError, IndexError, NotImplementedError)


def is_transient_error(exc: BaseException) -> bool:
    """True iff ``exc`` plausibly came from the machine, not the caller.

    The reference's kernel-fallback path asks it whether a failed launch
    is worth retrying on the plain backend: runtime/compile errors are;
    argument-validation errors and injected :class:`SimulatedFault`\\ s
    are not.  The port has no such fallback (a kernel that fails raises
    to the caller); callers may still classify errors with it.
    """
    if isinstance(exc, SimulatedFault):
        return False
    if isinstance(exc, NON_TRANSIENT_ERRORS):
        return False
    return isinstance(exc, Exception)


def backoff_delay(attempt: int, *, base: float, factor: float = 2.0,
                  cap: float = 30.0) -> float:
    """Exponential backoff delay for retry ``attempt`` (1-based)."""
    if base <= 0:
        return 0.0
    return min(cap, base * factor ** max(0, attempt - 1))


@dataclasses.dataclass
class FaultInjector:
    """Raise a fault at the given step numbers / sites (once each).

    ``fail_at`` entries are either a bare step number — fires at the
    first ``maybe_fail`` call for that step, whatever the site — or a
    ``(step, site)`` pair for a precise injection point, e.g.
    ``(3, "post_write")`` to kill ingest batch 3 after its ring-buffer
    write but before the commit.  ``exc_factory`` customises the raised
    exception (default :class:`SimulatedFault`); pass e.g.
    ``lambda step, site: ShardLossFault(1)`` to simulate shard loss.
    """
    fail_at: tuple = ()
    exc_factory: Optional[Callable[[int, Optional[str]], Exception]] = None
    _fired: set = dataclasses.field(default_factory=set)

    def _make(self, step: int, site: Optional[str]) -> Exception:
        if self.exc_factory is not None:
            return self.exc_factory(step, site)
        where = f"step {step}" + (f" at site {site!r}" if site else "")
        return SimulatedFault(f"injected fault at {where}")

    def maybe_fail(self, step: int, site: Optional[str] = None):
        for entry in self.fail_at:
            if entry in self._fired:
                continue
            if isinstance(entry, tuple):
                if entry == (step, site):
                    self._fired.add(entry)
                    raise self._make(step, site)
            elif entry == step:
                self._fired.add(entry)
                raise self._make(step, site)


def run_with_recovery(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    n_steps: int,
    manager: CheckpointManager,
    *,
    checkpoint_every: int = 10,
    max_restarts: int = 5,
    fault_injector: Optional[FaultInjector] = None,
    on_event: Optional[Callable[[str, int], None]] = None,
    recoverable: Tuple[Type[BaseException], ...] = (SimulatedFault,),
    backoff_base: float = 0.0,
    backoff_factor: float = 2.0,
    backoff_cap: float = 30.0,
    sleep_fn: Callable[[float], None] = time.sleep,
) -> tuple[Any, Dict[str, int]]:
    """Run ``state = step_fn(state, k)`` for k in [0, n_steps) with recovery.

    Any exception in ``recoverable`` restores from the latest checkpoint
    and retries (up to ``max_restarts``, with exponential backoff when
    ``backoff_base > 0``); everything else propagates immediately.
    ``sleep_fn`` is injectable so tests assert the backoff schedule
    without actually sleeping.
    """
    stats = {"restarts": 0, "checkpoints": 0}
    state = init_state
    start = 0
    latest = manager.latest_step()
    if latest is not None:
        state, start = manager.restore(init_state)
        start += 1

    restarts = 0
    k = start
    while k < n_steps:
        try:
            if fault_injector is not None:
                fault_injector.maybe_fail(k)
            state = step_fn(state, k)
            if (k + 1) % checkpoint_every == 0 or k == n_steps - 1:
                manager.save(k, state)
                manager.wait()
                stats["checkpoints"] += 1
            k += 1
        except recoverable:
            restarts += 1
            stats["restarts"] += 1
            if on_event:
                on_event("restart", k)
            if restarts > max_restarts:
                raise
            delay = backoff_delay(restarts, base=backoff_base,
                                  factor=backoff_factor, cap=backoff_cap)
            if delay > 0:
                sleep_fn(delay)
            latest = manager.latest_step()
            if latest is None:
                state, k = init_state, 0
            else:
                state, kk = manager.restore(init_state)
                k = kk + 1
    return state, stats
