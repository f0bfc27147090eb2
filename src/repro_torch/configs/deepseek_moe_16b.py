"""deepseek-moe-16b — [arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base].

Assignment: [moe] 28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400,
MoE 64 experts top-6, fine-grained, 2 shared experts, first layer dense.
d_ff=1408 is the per-expert width; the first dense layer uses the model's
published 10944.  Activated width per token = (6 routed + 2 shared) x 1408.

Sharding: ep — expert weights STATIONARY on their model rank (4 experts per
chip at 16-way EP; tokens move through the dispatch all-to-all, weights
never do), grouped local dispatch over the data axis.  bf16 params and
optimizer moments keep the per-rank expert slice (16B/16 x {p,m,v}) inside
16 GB — the fp32 variant doesn't fit, see EXPERIMENTS.md §Dry-run.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    norm_type="rmsnorm",
    rotary_pct=1.0,
    act="silu",
    mlp_gated=True,
    moe_style="deepseek",
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_expert=1408,
    first_k_dense=1,
    dense_d_ff=10944,
    capacity_factor=1.25,
    moe_groups=32,   # divides data(16) and pod*data(32)
    param_dtype=torch.bfloat16,
    sharding_profile="ep",
    serve_profile="ep",
)

ARCH = ArchSpec(config=CONFIG, source="arXiv:2401.06066", grad_accum=8, grad_accum_multipod=8)
