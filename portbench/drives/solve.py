"""One graph, solved again and again from scratch: ``repro_torch.solve``.

A call is one ``solve(graph, options)`` of the whole graph, which the
harness ends at ``synchronize()``; its answer is the labels.
"""
from __future__ import annotations

import torch

from portbench import reference, roofline
from repro_torch import Graph, SolveOptions, solve


class Drive:
    def __init__(self, make, params, traffic, device, seed, options):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.src, self.dst, self.n = make(**params, gen=gen)
        self.m = int(self.src.shape[0])
        self.graph = Graph(src=self.src, dst=self.dst, n_vertices=self.n)
        self.options = SolveOptions(**options)
        self._provenance = None
        self._expected = None

    def call(self):
        return solve(self.graph, self.options)

    def ok(self, result) -> bool:
        return bool(result.converged)

    def answer(self, result) -> torch.Tensor:
        self._provenance = result.provenance
        return result.labels

    def info(self, result) -> dict:
        return {"iterations": int(result.iterations)}

    def facts(self) -> dict:
        return {"n": self.n, "m": self.m,
                "least_bytes": roofline.least_solve_bytes(self.n, self.m),
                "sweep_kernel": "contour_fused_relax",
                "sweep_bytes": roofline.sweep_bytes(self.n, self.m)}

    def provenance(self):
        return self._provenance

    def release(self) -> None:
        self.graph = None

    def mismatches(self, labels: torch.Tensor) -> int:
        if self._expected is None:
            self._expected = reference.components(self.src, self.dst, self.n)
        return reference.mismatches(labels, self._expected)
