"""The model side of the roofline: parameter counts and MODEL_FLOPS
(``count_params`` and ``model_flops`` of ``repro.roofline.analysis``,
as they are).

The reference's three-term roofline over a compiled XLA artifact
(``RooflineReport``, ``analyze_compiled``, ``collective_stats``,
``hlo_cost``) and its TPU constants wait for ROADMAP Queue A item (e).
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.common import ParamSpec


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
