"""The ``algorithm="auto"`` cost model: measured strategy choice per graph.

The port's counterpart of ``repro.connectivity.planner.costmodel``, with
the same features, fit, thresholds and precedence:

* **features** — ``(n, m, m/n, degree skew)`` in log1p space; skew is
  max/mean degree (``graphs.stats.degree_skew``; the ``auto`` solver
  computes it on the card), the cheap separator between regular families
  (paths, grids: skew ~ 1-2) and hub-dominated ones (stars, R-MAT).
* **fitted model** — a 1-nearest-neighbour predictor over the
  ``strategy_gate`` rows of a benchmark artifact (schema >= 7): each
  measured graph contributes its features and the fixed strategy that
  won wall clock there.
* **precedence** — pinned > fitted > heuristic: an explicit
  ``SolveOptions.sampling_strategy`` (or ``variant``) always wins; the
  fitted model applies when a usable artifact is named; otherwise the
  heuristic table keyed on average degree and skew.

The chosen (solver, strategy) is recorded in provenance as
``auto:solver=... strategy=... origin=...``.

The artifact comes from ``bench_path=`` or ``$REPRO_TORCH_BENCH_ARTIFACT``
and has **no default**: the repo's ``BENCH_connectivity.json`` was
measured for the JAX package on another host, and its winners say
nothing about the card, so with neither set the heuristic decides, as the
reference's does when its file is unusable.  Loading is corrupt-safe: a
missing, truncated or pre-schema-7 artifact falls back to the heuristic.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path
from typing import List, Optional, Tuple

ENV_BENCH_ARTIFACT = "REPRO_TORCH_BENCH_ARTIFACT"

# Strategy rows appear in artifacts from this schema on.
_MIN_SCHEMA = 7

# Heuristic regime boundaries (used only below the fitted model):
# hub-dominated graphs (skew >> 1) with real average degree benefit from
# the k-out sampler bounding per-vertex sample work; everything else
# keeps the deterministic prefix (zero preparation cost).
_KOUT_MIN_AVG_DEGREE = 16.0
_KOUT_MIN_SKEW = 8.0


@dataclasses.dataclass(frozen=True)
class StrategyChoice:
    """A resolved (solver family, sampling strategy) decision."""

    solver: str
    variant: Optional[str]
    sampling_strategy: str
    sampling: int
    compact_every: int
    origin: str                      # "pinned" | "fitted" | "heuristic"
    neighbor: Optional[str] = None   # fitted: the measured graph copied

    def provenance_entry(self) -> str:
        entry = (f"auto:solver={self.solver} "
                 f"strategy={self.sampling_strategy} origin={self.origin}")
        if self.neighbor:
            entry += f" nn={self.neighbor}"
        return entry


def artifact_path(bench_path=None) -> Optional[Path]:
    """Resolve the artifact path: explicit > $REPRO_TORCH_BENCH_ARTIFACT;
    None when neither names one."""
    if bench_path is not None:
        return Path(bench_path)
    env = os.environ.get(ENV_BENCH_ARTIFACT)
    return Path(env) if env else None


def _features(n: int, m: int, skew: float) -> Tuple[float, ...]:
    """Log1p-scaled feature vector; log space keeps the 1-NN distance
    scale-free across the orders of magnitude n/m span."""
    density = m / n if n > 0 else 0.0
    return (math.log1p(float(n)), math.log1p(float(m)),
            math.log1p(density), math.log1p(max(0.0, float(skew))))


def _fit_examples(payload) -> List[Tuple[Tuple[float, ...], str, str]]:
    """(features, winning fixed strategy, graph name) per measured graph.

    The winner is re-derived from the raw per-side best seconds — the
    model never trusts a summary field that ``check_artifact.py`` would
    itself recompute.
    """
    gate = payload.get("strategy_gate")
    if not isinstance(gate, dict):
        return []
    examples = []
    for name, row in sorted(gate.items()):
        if not isinstance(row, dict):
            continue
        sides = row.get("sides", {})
        fixed = {s: d for s, d in sides.items() if s != "auto"}
        timed = {}
        for s, d in fixed.items():
            secs = d.get("seconds") or []
            if secs and all(isinstance(x, (int, float)) and x > 0
                            for x in secs):
                timed[s] = min(secs)
        if not timed:
            continue
        winner = min(timed, key=timed.get)
        feats = _features(int(row.get("n", 0)), int(row.get("m", 0)),
                          float(row.get("degree_skew", 0.0)))
        examples.append((feats, winner, name))
    return examples


# (path, mtime) -> fitted examples; refits automatically when the bench
# artifact is regenerated, costs one json parse per solve otherwise.
_FIT_CACHE: dict = {}


def load_fitted(bench_path=None):
    """Fitted examples from the artifact, or None when unusable."""
    path = artifact_path(bench_path)
    if path is None:
        return None
    try:
        mtime = path.stat().st_mtime_ns
    except OSError:
        return None
    key = (str(path), mtime)
    if key in _FIT_CACHE:
        return _FIT_CACHE[key]
    try:
        payload = json.loads(path.read_text())
        if int(payload.get("schema", 0)) < _MIN_SCHEMA:
            examples = None
        else:
            examples = _fit_examples(payload) or None
    except (OSError, ValueError, TypeError, AttributeError):
        # corrupt artifact (a list where a dict belongs included, where
        # the reference raises): fall through to the heuristic
        examples = None
    _FIT_CACHE.clear()  # one artifact in play at a time; stay bounded
    _FIT_CACHE[key] = examples
    return examples


def _predict_1nn(examples, n: int, m: int, skew: float):
    """Nearest measured graph's winning strategy (name for provenance)."""
    target = _features(n, m, skew)
    best = None
    for feats, winner, name in examples:
        dist = sum((a - b) ** 2 for a, b in zip(feats, target))
        if best is None or dist < best[0]:
            best = (dist, winner, name)
    return best[1], best[2]


def _heuristic(n: int, m: int, skew: float) -> StrategyChoice:
    """Fallback table keyed on average degree and skew (no artifact)."""
    if m <= 0 or n <= 1:
        # nothing to sample; dense sweeps converge in O(1) anyway
        return StrategyChoice("contour", "C-2", "prefix", 0, 0, "heuristic")
    avg_degree = 2.0 * m / n
    if avg_degree >= _KOUT_MIN_AVG_DEGREE and skew >= _KOUT_MIN_SKEW:
        strategy = "kout"
    else:
        strategy = "prefix"
    return StrategyChoice("contour", "C-2", strategy, 2, 2, "heuristic")


def resolve_strategy(
    n: int,
    m: int,
    *,
    degree_skew: Optional[float] = None,
    platform: Optional[str] = None,
    pinned_strategy: Optional[str] = None,
    pinned_variant: Optional[str] = None,
    bench_path=None,
) -> StrategyChoice:
    """Pick (solver, sampling strategy) for a graph: pinned > fitted >
    heuristic.

    ``degree_skew=None`` (``solve_batch``, where the reference's tracer
    cannot read degrees) is treated as 0 — the regular-graph regime,
    which biases toward the zero-preparation prefix strategy.
    ``platform`` is accepted for parity with the reference; the tables
    are platform-free (kernel choice is the plan layer's job).
    """
    del platform
    skew = 0.0 if degree_skew is None else float(degree_skew)
    base = _heuristic(n, m, skew)

    if pinned_strategy is not None:
        return dataclasses.replace(
            base, sampling_strategy=pinned_strategy,
            variant=pinned_variant or base.variant, origin="pinned",
            # a pinned strategy implies the adaptive schedule is wanted
            sampling=max(2, base.sampling), compact_every=2)

    if m > 0 and n > 1:
        examples = load_fitted(bench_path)
        if examples:
            winner, name = _predict_1nn(examples, n, m, skew)
            return dataclasses.replace(
                base, sampling_strategy=winner,
                variant=pinned_variant or base.variant,
                origin="fitted", neighbor=name)

    if pinned_variant is not None:
        return dataclasses.replace(base, variant=pinned_variant)
    return base
