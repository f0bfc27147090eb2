"""Production and host meshes (the port's ``repro.launch.mesh``).

Mesh construction is a function, never a module-level constant, so
importing this module touches no process group.  The production meshes
are abstract (:class:`repro_torch.runtime.mesh.AbstractMesh`): axis names
and sizes with no ranks, on which ``shardings_for`` and
``cache_shardings`` resolve every placement on one host.  The host mesh
is a :class:`repro_torch.runtime.Mesh` over the ranks of the initialised
``torch.distributed`` world (one process a rank, ``torchrun``).

Topology: the ``pod`` axis only ever carries data-parallel reductions;
every tensor- and expert-parallel collective stays on the ``model``
axis.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from repro_torch.graphs.structs import DeviceLike
from repro_torch.runtime.mesh import AbstractMesh, Mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh: 16 x 16 ``(data, model)`` in one pod, 2 x 16
    x 16 ``(pod, data, model)`` across two."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_host_mesh(model_parallel: int = 1,
                   devices: Optional[Sequence[int]] = None,
                   device: DeviceLike = None) -> Mesh:
    """A ``(data, model)`` mesh of shape ``(n // model_parallel,
    model_parallel)`` over ``devices`` (ranks; default: every rank of the
    initialised world).  Raises ``ValueError`` where ``model_parallel``
    does not divide their number.  ``device`` is each rank's device (the
    card unless one is named)."""
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} devices not divisible by tp={model_parallel}")
    shape = (n // model_parallel, model_parallel)
    return Mesh(np.asarray(ranks).reshape(shape), ("data", "model"),
                device=device)
