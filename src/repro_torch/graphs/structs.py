"""Edge-list graph structure used by every connectivity algorithm.

The port's counterpart of ``repro.graphs.structs``: two int32 tensors
``src`` and ``dst`` of equal length ``m`` (each undirected edge stored
once) plus the static vertex count ``n``.  The tensors live on one device;
an entry point that builds a graph puts it on ``cuda`` unless the caller
names another device, and never picks the CPU on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is named.

    Raises when no device is named and CUDA is absent, so a caller never
    lands on the CPU without asking for it (tests pass ``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _check_endpoints(src: np.ndarray, dst: np.ndarray, n: int) -> None:
    # eager bounds check on the host copy, before the cast to int32 could
    # wrap an id into range; Graph checks the tensors again when built
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs "
                         f"{dst.shape}")
    if src.size and int(max(src.max(), dst.max())) >= n:
        raise ValueError(
            f"edge endpoint {int(max(src.max(), dst.max()))} >= "
            f"n_vertices={n}; pass n_vertices= to grow the graph")
    if src.size and int(min(src.min(), dst.min())) < 0:
        raise ValueError("edge endpoints must be >= 0")


def _check_edge_tensors(src: torch.Tensor, dst: torch.Tensor,
                        n: int) -> None:
    # however a Graph is built, its endpoints are ids in [0, n): the sweep
    # kernels on the main path rely on it and do not wait to check
    for name, t in (("src", src), ("dst", dst)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
                or t.dim() not in (1, 2):
            raise TypeError(f"{name} must be a 1-D int32 tensor (or "
                            "[B, m] for a batched graph)")
    if src.shape != dst.shape or src.device != dst.device:
        raise ValueError(f"src/dst mismatch: {tuple(src.shape)} on "
                         f"{src.device} vs {tuple(dst.shape)} on {dst.device}")
    if src.numel():
        lo, hi = torch.stack([torch.minimum(src.min(), dst.min()),
                              torch.maximum(src.max(), dst.max())]).tolist()
        if hi >= n:
            raise ValueError(
                f"edge endpoint {hi} >= n_vertices={n}; pass n_vertices= "
                "to grow the graph")
        if lo < 0:
            raise ValueError("edge endpoints must be >= 0")


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph as an edge list.

    Attributes:
      src: int32[m] edge sources (``[B, m]`` for a batched graph:
        ``connectivity.batch.stack_graphs``).
      dst: int32[m] edge destinations, on the same device as ``src``.
      n_vertices: static python int, number of vertices (ids are 0..n-1).

    Building one checks that the endpoints lie in ``[0, n_vertices)``
    (one device-to-host read on the card) and raises ``ValueError`` if not.
    """

    src: torch.Tensor
    dst: torch.Tensor
    n_vertices: int

    def __post_init__(self):
        _check_edge_tensors(self.src, self.dst, self.n_vertices)

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def symmetrized(self) -> "Graph":
        """Return a graph with both edge directions materialised."""
        return Graph(src=torch.cat([self.src, self.dst]),
                     dst=torch.cat([self.dst, self.src]),
                     n_vertices=self.n_vertices)

    @classmethod
    def from_numpy(cls, src, dst, n_vertices: int,
                   device: DeviceLike = None) -> "Graph":
        """Build a graph from host arrays; ``device=None`` means ``cuda``."""
        dev = resolve_device(device)
        src = np.asarray(src)
        dst = np.asarray(dst)
        _check_endpoints(src, dst, int(n_vertices))
        return cls(src=torch.as_tensor(src.astype(np.int32), device=dev),
                   dst=torch.as_tensor(dst.astype(np.int32), device=dev),
                   n_vertices=int(n_vertices))

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, int]:
        return self.src.cpu().numpy(), self.dst.cpu().numpy(), self.n_vertices

    def add_edges(self, src, dst, n_vertices: Optional[int] = None
                  ) -> "Graph":
        """Return a graph with the given edges appended (incremental use).

        ``n_vertices`` may grow the vertex set at the same time; combined
        with ``repro_torch.solve(..., warm_start=prev_result)`` this is the
        batch-incremental update path.
        """
        n = self.n_vertices if n_vertices is None else int(n_vertices)
        if n < self.n_vertices:
            raise ValueError(
                f"n_vertices={n} shrinks the graph (was {self.n_vertices})")
        src = np.asarray(torch.as_tensor(src).cpu(), dtype=np.int64)
        dst = np.asarray(torch.as_tensor(dst).cpu(), dtype=np.int64)
        _check_endpoints(src, dst, n)
        dev = self.device
        return Graph(
            src=torch.cat([self.src, torch.as_tensor(src, dtype=torch.int32,
                                                     device=dev)]),
            dst=torch.cat([self.dst, torch.as_tensor(dst, dtype=torch.int32,
                                                     device=dev)]),
            n_vertices=n)

    def pad_edges(self, target_m: int, fill_vertex: int = 0) -> "Graph":
        """Pad the edge list to ``target_m`` with self-loop edges.

        Self-loops ``(fill_vertex, fill_vertex)`` are no-ops for every
        connectivity algorithm here (min(L[v], L[v]) == L[v]).
        """
        m = self.n_edges
        if target_m < m:
            raise ValueError(f"target_m={target_m} < m={m}")
        pad = target_m - m
        if pad == 0:
            return self
        fill = torch.full((pad,), fill_vertex, dtype=torch.int32,
                          device=self.device)
        return Graph(src=torch.cat([self.src, fill]),
                     dst=torch.cat([self.dst, fill]),
                     n_vertices=self.n_vertices)


def canonicalize_edges(
    src: np.ndarray, dst: np.ndarray, n_vertices: int, drop_self_loops: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort edges as (min,max) pairs, dedupe, optionally drop self loops."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    if drop_self_loops:
        keep = lo != hi
        lo, hi = lo[keep], hi[keep]
    key = lo * n_vertices + hi
    key = np.unique(key)
    return (key // n_vertices).astype(np.int32), (key % n_vertices).astype(np.int32)


def build_csr(src: np.ndarray, dst: np.ndarray, n_vertices: int):
    """Build a CSR adjacency (row_ptr, col_idx) from an undirected edge list."""
    s = np.concatenate([src, dst]).astype(np.int64)
    d = np.concatenate([dst, src]).astype(np.int64)
    order = np.argsort(s, kind="stable")
    s, d = s[order], d[order]
    counts = np.bincount(s, minlength=n_vertices)
    row_ptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, d.astype(np.int32)
