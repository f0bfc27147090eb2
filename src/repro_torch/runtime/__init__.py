"""Fault tolerance of the port: the crash-restart loop and the
straggler monitor (``repro.runtime``'s ``recovery`` and ``straggler``;
``elastic`` comes with the distributed slice)."""
from repro_torch.runtime.recovery import (
    NON_TRANSIENT_ERRORS,
    FaultInjector,
    ShardLossFault,
    SimulatedFault,
    backoff_delay,
    is_transient_error,
    run_with_recovery,
)
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = [
    "NON_TRANSIENT_ERRORS", "FaultInjector", "ShardLossFault",
    "SimulatedFault", "StragglerMonitor", "backoff_delay",
    "is_transient_error", "run_with_recovery",
]
