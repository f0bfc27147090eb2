"""Elastic scaling: re-derive a mesh from whatever ranks survive.

The port's counterpart of ``repro.runtime.elastic``.  Policy: preserve
the model (TP/EP) axis if possible — model-parallel state is the
expensive thing to reshard — and absorb rank loss on the data-parallel
axes.  Combined with label checkpoints (``repro_torch.checkpoint``) a
solve can resume on any rank count that still fits the model axis.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.graphs.structs import DeviceLike
from repro_torch.runtime.mesh import Mesh


def derive_mesh_shape(
    n_devices: int, model_parallel: int, prefer_pods: int = 1
) -> Tuple[int, ...]:
    """Largest (pod, data, model) grid using <= n_devices devices.

    ``model_parallel`` is fixed (weights are sharded that way); data/pod
    axes shrink to fit.  Raises if even one model replica doesn't fit.
    """
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot hold model_parallel={model_parallel}"
        )
    replicas = n_devices // model_parallel
    pods = prefer_pods
    while pods > 1 and replicas % pods:
        pods -= 1
    data = replicas // pods
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)


def elastic_mesh(
    model_parallel: int,
    devices: Optional[Sequence[int]] = None,
    prefer_pods: int = 1,
    *,
    device: DeviceLike = None,
) -> Mesh:
    """A :class:`Mesh` over the first ranks of ``devices`` (default: every
    rank of the world) with the axes ``("pod", "data", "model")`` or
    ``("data", "model")`` of :func:`derive_mesh_shape`.  Surplus ranks
    are left outside the mesh.  ``device`` is the calling rank's device
    (:func:`~repro_torch.runtime.mesh.mesh_device`)."""
    devices = list(devices if devices is not None
                   else range(dist.get_world_size()))
    shape = derive_mesh_shape(len(devices), model_parallel, prefer_pods)
    n_used = int(np.prod(shape))
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    ranks = np.asarray(devices[:n_used], dtype=np.int64).reshape(shape)
    return Mesh(ranks, names, device=device)
