"""Fault tolerance and placement of the port: the crash-restart loop, the
straggler monitor, the mesh of ``torch.distributed`` ranks and the
elastic mesh (``repro.runtime``'s ``recovery``, ``straggler`` and
``elastic``; ``mesh`` stands for ``jax.sharding.Mesh``)."""
from repro_torch.runtime.elastic import derive_mesh_shape, elastic_mesh
from repro_torch.runtime.mesh import Mesh
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
    "Mesh", "NON_TRANSIENT_ERRORS", "FaultInjector", "ShardLossFault",
    "SimulatedFault", "StragglerMonitor", "backoff_delay",
    "derive_mesh_shape", "elastic_mesh", "is_transient_error",
    "run_with_recovery",
]
