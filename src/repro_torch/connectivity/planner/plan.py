"""The resolved execution plan a kernel-backed solve runs under.

The port's counterpart of ``repro.connectivity.planner.plan``, cut to the
fields the port honours: which backend realises the MM sweep, whether
order-2 ``cuda`` sweeps take the fused kernel, how the work-adaptive
frontier is realised, the out-of-core solver's edge chunk, the device
the plan was made for, and where the plan came from (``origin``:
``"heuristic"`` table, ``"tuned"`` by the measuring autotuner's cache,
``"pinned"`` by the caller).  The tile sizes of the TPU plan have no
meaning for the CUDA kernels, and the reference's ``"fallback"`` origin
has no counterpart: the port has no kernel fallback.

The backends carry new names for the reference's:

* ``"torch"``      — plain torch scatter-min (the reference's ``"xla"``);
* ``"cuda"``       — the synchronous sweep kernels ``fused_relax`` and
  ``scatter_min`` (the reference's ``"pallas_blocked"``);
* ``"cuda_async"`` — the in-order asynchronous sweep kernel ``mm2`` (the
  reference's scalar ``"pallas"``).

Cache keys bucket sizes by powers of two (:func:`size_bucket`,
:func:`plan_key`), so one tuned plan serves graphs of similar scale.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

BACKENDS = ("auto", "torch", "cuda", "cuda_async")
COMPACT_SCHEDULES = ("masked", "staged")
ORIGINS = ("heuristic", "tuned", "pinned")

# the fields of a plan's config (what the tuning cache stores); device and
# origin are per resolution, not part of the program that runs
_CONFIG_FIELDS = ("backend", "fuse_relabel", "compact_schedule",
                  "chunk_bucket")


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def size_bucket(x: int) -> int:
    """The pow2 bucket a vertex/edge count falls in (for plan keys)."""
    return next_pow2(max(int(x), 1))


def plan_key(device_type: str, n_vertices: int, m_edges: int) -> str:
    """Tuning-cache key: ``"<device type>/n<bucket>/m<bucket>"``."""
    return (f"{device_type}/n{size_bucket(n_vertices)}"
            f"/m{size_bucket(m_edges)}")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Resolved backend and schedule for one solve (frozen, hashable)."""

    backend: str                    # concrete: "torch"|"cuda"|"cuda_async"
    fuse_relabel: bool = True       # order-2 cuda sweeps take fused_relax
    # frontier realisation: "masked" keeps the edge arrays whole and
    # bounds each sweep; "staged" also slices them to a pow2 capacity
    # that shrinks with the frontier (planner.staged)
    compact_schedule: str = "masked"
    # the out-of-core solver's pow2 edge chunk (0 = not out-of-core)
    chunk_bucket: int = 0
    device: str = "cuda"            # device type the plan was made for
    origin: str = "heuristic"       # heuristic | tuned | pinned

    def __post_init__(self):
        cb = self.chunk_bucket
        if not isinstance(cb, int) or cb < 0 or (cb and cb & (cb - 1)):
            raise ValueError(
                f"chunk_bucket must be 0 or a power of two, got {cb!r}")

    def validate(self) -> "ExecutionPlan":
        if self.backend not in BACKENDS[1:]:
            raise ValueError(
                f"ExecutionPlan.backend must be concrete, one of "
                f"{BACKENDS[1:]}; got {self.backend!r}")
        if self.compact_schedule not in COMPACT_SCHEDULES:
            raise ValueError(
                f"compact_schedule {self.compact_schedule!r} not one of "
                f"{COMPACT_SCHEDULES}")
        if self.origin not in ORIGINS:
            raise ValueError(f"origin {self.origin!r} not one of {ORIGINS}")
        if not isinstance(self.fuse_relabel, bool):
            raise ValueError(f"fuse_relabel must be a bool, got "
                             f"{self.fuse_relabel!r}")
        return self

    def replace(self, **updates) -> "ExecutionPlan":
        return dataclasses.replace(self, **updates)

    # -- serialisation (tuning cache) ------------------------------------
    def to_config(self) -> dict:
        """JSON-safe config dict (device and origin excluded: they belong
        to a resolution, not to the program that runs)."""
        return {f: getattr(self, f) for f in _CONFIG_FIELDS}

    @classmethod
    def from_config(cls, config: dict, origin: str = "tuned",
                    device: str = "cuda") -> "ExecutionPlan":
        """Rebuild a plan from :meth:`to_config` output; raises
        ``ValueError`` on any unknown or mistyped field (the cache turns
        that into a miss)."""
        if not isinstance(config, dict):
            raise ValueError(f"plan config must be a dict, got "
                             f"{type(config).__name__}")
        unknown = set(config) - set(_CONFIG_FIELDS)
        if unknown:
            raise ValueError(f"unknown plan config fields {sorted(unknown)}")
        if "fuse_relabel" in config and \
                not isinstance(config["fuse_relabel"], bool):
            raise ValueError("fuse_relabel must be a bool")
        for f in ("backend", "compact_schedule"):
            if f in config and not isinstance(config[f], str):
                raise ValueError(f"{f} must be a str")
        cb = config.get("chunk_bucket", 0)
        if isinstance(cb, bool) or not isinstance(cb, int):
            raise ValueError("chunk_bucket must be an int")
        return cls(origin=origin, device=device, **config).validate()

    def config_equal(self, other: Optional["ExecutionPlan"]) -> bool:
        """True when the two plans run the same program (device, origin
        and provenance aside)."""
        return other is not None and self.to_config() == other.to_config()

    def provenance_entry(self) -> str:
        """The ``plan:`` line recorded in ``ComponentResult.provenance``."""
        oc = f" chunk={self.chunk_bucket}" if self.chunk_bucket else ""
        return (f"plan:{self.backend} origin={self.origin} "
                f"schedule={self.compact_schedule} "
                f"fused={int(self.fuse_relabel)} device={self.device}{oc}")
