"""On-disk tuning cache: measured plans per (device type, n-bucket,
m-bucket).

The port's counterpart of ``repro.connectivity.planner.cache``, with the
reference's protocol: one JSON file (schema 1) maps
:func:`~repro_torch.connectivity.planner.plan.plan_key` buckets to the
config the measuring autotuner found fastest, plus its timings.

* **solve() stays fast and deterministic** — a lookup is an in-process
  dict hit (the file is re-read only when its mtime changes); tuning
  happens only when :func:`planner.autotune.autotune` is called.
* **a corrupt or stale entry never breaks a solve** — any parse error,
  schema mismatch, unknown field, wrong type or invalid backend makes
  :func:`lookup` return ``None``, and the heuristic table decides.
* **only measured plans are read** — an entry whose origin is not
  ``"tuned"`` is a miss.  The reference also reads ``"fallback"``
  demotions written after a kernel-launch failure; the port has no
  kernel fallback, so it writes none and reads none.

Location: ``$REPRO_TORCH_TUNING_CACHE`` if set, else
``~/.cache/repro_torch/contour_tuning.json``: a file of its own, apart
from the JAX package's, since the two packages' configs name different
backends.  Delete the file to clear every tuned plan.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Optional, Tuple

from repro_torch.connectivity.planner.plan import ExecutionPlan, plan_key

ENV_CACHE_PATH = "REPRO_TORCH_TUNING_CACHE"
CACHE_SCHEMA = 1

# In-process mirror: path -> (mtime_ns or None, entries dict)
_LOADED: Dict[str, Tuple[Optional[int], dict]] = {}


def cache_path() -> str:
    env = os.environ.get(ENV_CACHE_PATH)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "contour_tuning.json")


def _read(path: str) -> dict:
    """Entries dict from disk; {} on any corruption (never raises)."""
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        _LOADED[path] = (None, {})
        return {}
    cached = _LOADED.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    try:
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict) or \
                payload.get("schema") != CACHE_SCHEMA:
            entries: dict = {}
        else:
            entries = payload.get("entries", {})
            if not isinstance(entries, dict):
                entries = {}
    except (OSError, ValueError):
        entries = {}
    _LOADED[path] = (mtime, entries)
    return entries


def _write(path: str, entries: dict) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".contour_tuning.")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"schema": CACHE_SCHEMA, "entries": entries}, f,
                      indent=2, sort_keys=True)
        os.replace(tmp, path)  # atomic publish
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _LOADED.pop(path, None)


def entries(path: Optional[str] = None) -> dict:
    """A copy of the raw cache entries."""
    return dict(_read(path or cache_path()))


def lookup(n_vertices: int, m_edges: int, device_type: str,
           path: Optional[str] = None) -> Optional[ExecutionPlan]:
    """The tuned plan for this bucket, or None (a miss, a corrupt entry,
    or one whose origin is not ``"tuned"``)."""
    path = path or cache_path()
    entry = _read(path).get(plan_key(device_type, n_vertices, m_edges))
    if not isinstance(entry, dict):
        return None
    if entry.get("origin", "tuned") != "tuned":
        return None
    try:
        return ExecutionPlan.from_config(entry.get("config"), origin="tuned",
                                         device=device_type)
    except (ValueError, TypeError):
        return None  # stale/corrupt entry: the heuristic table decides


def store(n_vertices: int, m_edges: int, device_type: str,
          plan: ExecutionPlan, *, time_s: Optional[float] = None,
          timings: Optional[dict] = None, path: Optional[str] = None,
          now: Optional[float] = None) -> dict:
    """Persist a measured plan for this bucket; returns the stored
    entry."""
    path = path or cache_path()
    entry = {
        "config": plan.to_config(),
        "origin": "tuned",
        "measured_at": time.time() if now is None else now,
    }
    if time_s is not None:
        entry["time_s"] = float(time_s)
    if timings is not None:
        entry["timings"] = timings
    ents = dict(_read(path))
    ents[plan_key(device_type, n_vertices, m_edges)] = entry
    _write(path, ents)
    return entry


def clear(path: Optional[str] = None) -> None:
    """Drop every cached plan."""
    path = path or cache_path()
    try:
        os.unlink(path)
    except OSError:
        pass
    _LOADED.pop(path, None)
