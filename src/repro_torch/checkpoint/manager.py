"""Checkpointing: atomic, keep-k, async-capable.

The port's counterpart of ``repro.checkpoint.manager``, with the same
layout on disk, so a checkpoint written by either package restores in
the other: ``<dir>/step_<k>/`` (``step_%08d``) holds one ``.npy`` per
leaf plus a ``manifest.json`` with each leaf's name, shape and dtype.
Commit protocol: write into ``step_<k>.tmp`` then ``os.rename`` —
readers never observe a partial checkpoint, and a crash mid-save leaves
the previous step intact.

The state is a dict (or a list or tuple) of tensors, numpy arrays and
numpy scalars, which may nest (``StreamingDedup``'s holds its engine's);
a bare array is a state of one leaf.  Leaves are named and ordered as
the reference's tree flattening names them: a dict's keys sorted, a
sequence's indices, joined with ``"__"`` along the path.  Every leaf is
saved as a host array of its own dtype (a CUDA tensor is copied to the
host when the save is called).  ``restore`` loads numpy arrays, or
tensors on the ``device`` it is given; the reference's ``shardings``
have no meaning on one card.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.graphs.structs import DeviceLike


def _children(node):
    """``(key, child)`` pairs of a container, in the reference's order
    (a dict's keys sorted, a list's or tuple's by index); None for a
    leaf."""
    if isinstance(node, dict):
        for key in node:
            if not isinstance(key, str):
                raise TypeError(f"checkpoint keys must be str, got {key!r}")
        return [(key, node[key]) for key in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), child) for i, child in enumerate(node)]
    return None


def _flatten(state, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs named as the reference's tree flattening
    names them: the keys on the leaf's path joined with ``"__"``."""
    children = _children(state)
    if children is None:
        return [(prefix, state)]
    out = []
    for key, child in children:
        out += _flatten(child, f"{prefix}__{key}" if prefix else key)
    return out


def _unflatten_like(like, leaves: Dict[str, Any], prefix: str = ""):
    children = _children(like)
    if children is None:
        return leaves[prefix]
    built = [(key, _unflatten_like(child, leaves,
                                   f"{prefix}__{key}" if prefix else key))
             for key, child in children]
    if isinstance(like, dict):
        return dict(built)
    return type(like)(value for _, value in built)


def _to_host(leaf) -> np.ndarray:
    """A host numpy copy of the leaf: the copy, not a view, is what an
    async save writes after the caller changed its arrays in place."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.cpu() if t.device.type != "cpu" else t.clone()).numpy()
    return np.array(leaf)


def _host_state(state) -> List[Tuple[str, np.ndarray]]:
    return [(name, _to_host(leaf)) for name, leaf in _flatten(state)]


def _write(directory: str, step: int,
           leaves: List[Tuple[str, np.ndarray]]) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for name, arr in leaves:
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)            # atomic commit
    return final


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Atomically save ``state`` at ``step``. Returns the final path."""
    return _write(directory, step, _host_state(state))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore_checkpoint(
    directory: str, like: Any, step: Optional[int] = None,
    device: DeviceLike = None,
) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (only its keys are used).

    Leaves come back as numpy arrays, or as tensors on ``device`` when
    one is named.  ``step=None`` takes the latest.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    leaves = {name: np.load(os.path.join(path, name + ".npy"))
              for name, _ in _flatten(like)}
    if device is not None:
        dev = torch.device(device)
        leaves = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for k, a in leaves.items()}
    return _unflatten_like(like, leaves), step


class CheckpointManager:
    """Keep-k manager with optional async (background-thread) saves."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d))

    def save(self, step: int, state: Any):
        # copy to the host *now* (the caller may change its tensors in
        # place after this returns), write in the background
        leaves = _host_state(state)

        def work():
            _write(self.directory, step, leaves)
            self._gc()

        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, like: Any, step: Optional[int] = None,
                device: DeviceLike = None):
        self.wait()
        return restore_checkpoint(self.directory, like, step, device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)
