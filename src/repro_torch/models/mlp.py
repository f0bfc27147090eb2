"""Dense MLP (the port's counterpart of ``repro.models.mlp``'s dense part).

Gated (SwiGLU-style: act(x W_gate) ⊙ x W_up) or ungated (act(x W_up)),
then W_down; plain ``matmul``s in the activations' type.  The
Mixture-of-Experts half of the reference's module comes with the ``moe``
family (ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig, ParamSpec


def mlp_specs(config: ModelConfig, d_ff: int | None = None) -> Dict[str, ParamSpec]:
    d, f = config.d_model, d_ff or config.d_ff
    s = {
        "w_up": ParamSpec((d, f), ("embed", "ffn"), scale=d ** -0.5),
        "w_down": ParamSpec((f, d), ("ffn", "embed"), scale=f ** -0.5),
    }
    if config.mlp_gated:
        s["w_gate"] = ParamSpec((d, f), ("embed", "ffn"), scale=d ** -0.5)
    return s


def mlp_apply(params, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    up = x @ params["w_up"].to(x.dtype)
    if config.mlp_gated:
        gate = cm.activate(x @ params["w_gate"].to(x.dtype), config.act)
        h = gate * up
    else:
        h = cm.activate(up, config.act)
    return h @ params["w_down"].to(x.dtype)
