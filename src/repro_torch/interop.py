"""Carry connectivity state into the port from host arrays.

Connectivity has no weights: its state is the graph and the labels.
These helpers build the port's objects from numpy arrays — for example
the reference's outputs passed through ``np.asarray`` — and take nothing
else, so no object of another framework crosses into the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.connectivity.result import ComponentResult
from repro_torch.connectivity.solve import make_result
from repro_torch.graphs.structs import DeviceLike, Graph, resolve_device

_SCALARS = (np.ndarray, np.generic, bool, int, float)


def _require_numpy(name: str, x, scalar: bool = False) -> np.ndarray:
    ok = isinstance(x, _SCALARS) if scalar else isinstance(x, np.ndarray)
    if not ok:
        raise TypeError(f"{name} must be a numpy "
                        f"{'value' if scalar else 'array'}, got "
                        f"{type(x).__module__}.{type(x).__name__}; pass "
                        "np.asarray(...) of it")
    return np.array(x) if scalar else np.asarray(x)


def graph_from_arrays(src, dst, n_vertices: int,
                      device: DeviceLike = None) -> Graph:
    """The port's :class:`Graph` from numpy edge arrays."""
    return Graph.from_numpy(_require_numpy("src", src),
                            _require_numpy("dst", dst), n_vertices,
                            device=device)


def result_from_arrays(labels, iterations, converged, edges_visited=None,
                       device: DeviceLike = None) -> ComponentResult:
    """A :class:`ComponentResult` from numpy values (usable as a warm
    start)."""
    dev = resolve_device(device)
    labels = _require_numpy("labels", labels)
    return make_result(
        torch.as_tensor(labels.astype(np.int32), device=dev),
        _require_numpy("iterations", iterations, scalar=True),
        _require_numpy("converged", converged, scalar=True),
        None if edges_visited is None else
        _require_numpy("edges_visited", edges_visited, scalar=True))
