"""Straggler mitigation: per-step timing EWMA with outlier detection.

The port's copy of ``repro.runtime.straggler``.

At multi-pod scale a single slow host drags every synchronous collective.
The monitor tracks per-step wall time (per host in a real deployment —
here, per process), flags steps slower than ``threshold ×`` the EWMA, and
recommends an action the caller acts on:

  * ``"warn"``      — sporadic outlier (logging only)
  * ``"checkpoint"``— persistent degradation: snapshot now so a replace-
                      and-restart loses no work
  * ``"evict"``     — repeated offender past ``evict_after``: the caller
                      should drop the host and re-derive an elastic mesh
                      (the reference's ``runtime.elastic``)

This is the same escalation ladder MaxText/Pathways-style deployments use;
the decision logic is fully testable on one host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0          # step slower than threshold*ewma = outlier
    alpha: float = 0.1              # EWMA coefficient
    evict_after: int = 3            # consecutive outliers before eviction
    ewma: Optional[float] = None
    consecutive_slow: int = 0
    history: List[float] = dataclasses.field(default_factory=list)
    _t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self) -> str:
        assert self._t0 is not None, "start_step() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, dt: float) -> str:
        """Feed one step duration; returns the recommended action."""
        self.history.append(dt)
        if self.ewma is None:
            self.ewma = dt
            return "ok"
        slow = dt > self.threshold * self.ewma
        if slow:
            self.consecutive_slow += 1
        else:
            self.consecutive_slow = 0
            # only fold non-outlier steps into the EWMA (robustness)
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        if self.consecutive_slow >= self.evict_after:
            return "evict"
        if self.consecutive_slow >= 2:
            return "checkpoint"
        if slow:
            return "warn"
        return "ok"
