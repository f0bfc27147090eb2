"""Three-term roofline analysis of a rank's priced program (the port's
``repro.roofline.analysis``).

    compute term    = FLOPs / peak_FLOP/s
    memory term     = HBM bytes / HBM_bw
    collective term = collective link bytes / link_bw

every quantity per rank, over one card's peaks, as the reference's
formulas reduce to per-device quantities.  The reference reads them from
a compiled XLA artifact (``analyze_compiled``: ``cost_analysis``, the
optimized HLO through ``hlo_cost``, ``memory_analysis``); the port has no
HLO and reads them from the rank's program run on ``meta`` tensors
(``repro_torch.roofline.op_cost``: FLOPs and bytes an aten op, the
collectives a :class:`~repro_torch.runtime.mesh.PricedRank` records, the
traced live bytes), in :func:`analyze_program`.  The reference's
``xla_flops_loop_once``/``xla_bytes_loop_once`` fields (XLA's own counts,
a loop body once) have no counterpart and are left out.

Per-collective link traffic uses the standard ring-algorithm byte counts
(per participant, group size n), as the reference's:

    all-reduce       2 x bytes x (n-1)/n
    all-gather       out_bytes x (n-1)/n
    reduce-scatter   in_bytes  x (n-1)/n      (= out x (n-1))

The port's collectives are these three (``repro_torch.runtime.mesh``); it
has no all-to-all or collective-permute.

Hardware model: one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet, dense
rates): 989 TFLOP/s bf16, 3.35 TB/s HBM, and NVLink 4's 900 GB/s both
ways, 450 GB/s a direction per GPU.  The production meshes (256 and 512
ranks) span many 8-GPU nodes, whose links between nodes (the NICs) are
slower than NVLink: one link rate for every collective makes the
collective term a floor.  No figure across several cards has been
measured.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import numpy as np

from repro_torch.models.common import ParamSpec

HW_H100 = {
    "peak_flops": 989e12,    # dense bf16 FLOP/s per card (tensor cores)
    "hbm_bw": 3.35e12,       # bytes/s per card
    "link_bw": 450e9,        # bytes/s per card, one direction of NVLink 4
    # float32 outside the tensor cores: the data sheet's closest entry for
    # int32 min/compare work (the connectivity kernels' bounds)
    "alu_ops": 67e12,
}

def link_bytes(kind: str, n: int, out_bytes: float) -> float:
    """One participant's ring-model link traffic of a collective ``kind``
    (``all_reduce``, ``all_gather``, ``reduce_scatter``; hyphens or
    underscores) over ``n`` ranks whose result is ``out_bytes``."""
    kind = kind.replace("_", "-")
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * out_bytes * frac
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "reduce-scatter":
        return float(out_bytes * (n - 1))
    raise ValueError(f"no ring model for a collective {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    """Per-rank collective byte counts, by the reference's op names
    (``all-reduce``, ``all-gather``, ``reduce-scatter``)."""

    op_counts: Dict[str, int]
    out_bytes: Dict[str, int]      # raw output bytes by op kind
    link_bytes: Dict[str, int]     # ring-model per-device link traffic

    @property
    def total_link_bytes(self) -> int:
        return sum(self.link_bytes.values())

    @property
    def total_out_bytes(self) -> int:
        return sum(self.out_bytes.values())


def collective_stats(records: Iterable) -> CollectiveStats:
    """The stats of a :class:`~repro_torch.runtime.mesh.PricedRank`'s
    records (anything with ``kind``, ``n`` and ``out_bytes``)."""
    counts: Dict[str, int] = {}
    out_b: Dict[str, int] = {}
    link_b: Dict[str, int] = {}
    for r in records:
        op = r.kind.replace("_", "-")
        counts[op] = counts.get(op, 0) + 1
        out_b[op] = out_b.get(op, 0) + r.out_bytes
        link_b[op] = link_b.get(op, 0) + int(link_bytes(op, r.n,
                                                        r.out_bytes))
    return CollectiveStats(op_counts=counts, out_bytes=out_b,
                           link_bytes=link_b)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    kind: str                      # train | prefill | decode | contour
    n_devices: int
    # per-device quantities
    hlo_flops: float
    hlo_bytes: float
    collective_link_bytes: float
    peak_hbm_bytes: float          # the traced peak of live bytes
    # three terms, seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    # usefulness
    model_flops_global: float = 0.0
    flops_ratio: float = 0.0       # model_flops / (hlo_flops x devices)
    collective_detail: Optional[Dict[str, Any]] = None
    note: str = ""

    def finalize(self, hw=HW_H100) -> "RooflineReport":
        self.t_compute = self.hlo_flops / hw["peak_flops"]
        self.t_memory = self.hlo_bytes / hw["hbm_bw"]
        self.t_collective = self.collective_link_bytes / hw["link_bw"]
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.dominant = max(terms, key=terms.get)
        total_hlo = self.hlo_flops * self.n_devices
        self.flops_ratio = (self.model_flops_global / total_hlo
                            if total_hlo else 0.0)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def analyze_program(cost, memory, *, arch: str, shape: str, mesh_name: str,
                    kind: str, n_devices: int,
                    model_flops_global: float = 0.0,
                    note: str = "", hw=HW_H100) -> RooflineReport:
    """The report of one rank's priced program (``analyze_compiled``'s
    counterpart): ``cost`` an ``op_cost.Cost``, ``memory`` an
    ``op_cost.Memory``; the ``hlo_*`` fields keep the reference's names
    and hold the traced program's counts."""
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, kind=kind,
        n_devices=n_devices,
        hlo_flops=float(cost.flops),
        hlo_bytes=float(cost.bytes),
        collective_link_bytes=float(cost.total_coll_link_bytes),
        peak_hbm_bytes=float(memory.peak_bytes),
        model_flops_global=model_flops_global,
        collective_detail={
            "counts": dict(cost.coll_counts),
            "link_bytes": dict(cost.coll_link_bytes),
            "ops": cost.ops,
        },
        note=note,
    )
    return rep.finalize(hw)


# ---------------------------------------------------------------------------
# MODEL_FLOPS: 6·N·D (train) / 2·N·D (forward), N_active for MoE
# ---------------------------------------------------------------------------

def count_params(model, active_only: bool = False) -> float:
    """Non-embedding parameter count from the model's ParamSpec tree.

    ``active_only`` scales expert tensors by top_k/n_experts (MoE active
    parameters — the N in the assignment's 6·N_active·D).
    """
    cfg = model.config
    specs = model.param_specs()
    total = 0.0

    def visit(tree, path):
        nonlocal total
        if isinstance(tree, ParamSpec):
            name = path[-1] if path else ""
            if name in ("tok_embed", "lm_head"):
                return
            n = float(np.prod(tree.shape))
            if active_only and name.endswith("_e"):  # stacked expert tensors
                n *= cfg.top_k / max(cfg.n_experts, 1)
            total += n
            return
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, path + [k])
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                visit(v, path + [str(i)])

    visit(specs, [])
    return total


def model_flops(model, kind: str, seq_len: int, global_batch: int) -> float:
    """Assignment MODEL_FLOPS for one step of a grid cell."""
    n_active = count_params(model, active_only=True)
    if kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * global_batch
