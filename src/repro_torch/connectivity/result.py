"""Typed result of a connectivity solve: labels + lazy component views.

The port's counterpart of ``repro.connectivity.result``, for single
solves and for ``solve_batch``'s batched results (:attr:`is_batched`,
:meth:`unstack`).  Labels follow the Contour fixed-point convention: the
label of a vertex is the minimum vertex id of its component.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class ComponentResult:
    """Component labels plus solve metadata.

    Attributes:
      labels: int32[n] min-vertex-id component labels (``[B, n]`` for a
        batched solve — see :meth:`unstack`).
      iterations: int32 0-d tensor (``[B]`` batched), the iteration count.
      converged: bool 0-d tensor (``[B]`` batched) — True iff the solver
        hit the connectivity fixed point before ``max_iters``.
      batch_sizes: per-graph vertex counts of a batched solve (None for a
        single solve); :meth:`unstack` trims the padding vertices with
        them.
      edges_visited: float32 0-d tensor (``[B]`` batched), the edges
        swept (``iterations × m`` on the dense schedule), or None.
      provenance: tuple of strings recording how the solve ran (the
        resolved ``plan:`` line); None/empty for none.
    """

    labels: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    batch_sizes: Optional[Tuple[int, ...]] = None
    edges_visited: Optional[torch.Tensor] = None
    provenance: Optional[Tuple[str, ...]] = None

    # -- lazy host-side views --------------------------------------------
    @property
    def is_batched(self) -> bool:
        return self.labels.dim() > 1

    def _require_single(self, what: str):
        if self.is_batched:
            raise ValueError(
                f"{what} is per-graph; this is a batched result — call "
                ".unstack() first")

    @functools.cached_property
    def _np_labels(self) -> np.ndarray:
        return self.labels.cpu().numpy()

    @functools.cached_property
    def _uniq(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(unique labels, dense inverse, counts) — computed once."""
        self._require_single("component decomposition")
        return np.unique(self._np_labels, return_inverse=True,
                         return_counts=True)

    @property
    def n_components(self) -> int:
        """Number of connected components."""
        return int(self._uniq[0].size)

    def compact_labels(self) -> np.ndarray:
        """Dense ``0..k-1`` relabeling (component order = ascending min id)."""
        return self._uniq[1].astype(np.int32)

    def component_sizes(self) -> np.ndarray:
        """Vertex count per component, indexed like :meth:`compact_labels`."""
        return self._uniq[2]

    def _check_ids(self, *ids):
        # NumPy would silently wrap negative ids to the array tail; both
        # bounds are checked eagerly so every query fails the same way
        n = self._np_labels.shape[-1]
        for v in ids:
            a = np.asarray(v)
            if np.any(a < 0):
                raise IndexError("vertex ids must be >= 0")
            if a.size and np.any(a >= n):
                raise IndexError(
                    f"vertex id {int(a.max())} out of range for "
                    f"n_vertices={n}")

    def same_component(self, u, v):
        """True iff ``u`` and ``v`` are connected (vectorises over arrays)."""
        self._require_single("same_component")
        self._check_ids(u, v)
        L = self._np_labels
        out = L[np.asarray(u)] == L[np.asarray(v)]
        return bool(out) if np.ndim(out) == 0 else out

    def component_of(self, v):
        """Component id (the component's min vertex id) of ``v``."""
        self._require_single("component_of")
        self._check_ids(v)
        out = self._np_labels[np.asarray(v)]
        return int(out) if np.ndim(out) == 0 else out

    # -- batched results -------------------------------------------------
    def unstack(self) -> List["ComponentResult"]:
        """Split a batched result into per-graph results.

        Padded vertices (ids >= the graph's original ``n_vertices``) are
        isolated self-labelled singletons; ``batch_sizes`` trims them away
        so each returned result matches its source graph exactly.
        """
        if not self.is_batched:
            return [self]
        n_graphs = int(self.labels.shape[0])
        sizes = self.batch_sizes or (self.labels.shape[1],) * n_graphs
        return [
            ComponentResult(
                labels=self.labels[i, :sizes[i]],
                iterations=self.iterations[i],
                converged=self.converged[i],
                edges_visited=(None if self.edges_visited is None
                               else self.edges_visited[i]),
                provenance=self.provenance,
            )
            for i in range(n_graphs)
        ]
