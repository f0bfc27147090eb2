"""arctic-480b — [hf:Snowflake/snowflake-arctic-base].

Assignment: [moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 PLUS a dense residual FFN in every layer
(dense-MoE hybrid: y = moe(x) + dense_ffn(x)).

480B total / ~17B active.  Numerics: bf16 params and bf16 optimizer
moments — at 256 x 16 GB chips a 480B model is capacity-critical (see
EXPERIMENTS.md §Dry-run for the honest accounting; it truly needs 2 pods
for comfortable training).  grad_accum=8 keeps the per-microbatch
activation live-set bounded on both meshes.

Sharding: ep_fsdp — flat batch over (pod, data, model); experts -> model;
expert inner dim + attention storage-sharded over data.  56 heads don't
divide 16, so attention weights shard on the embed dim instead (FSDP
gathers per layer); KV cache shards its seq dim (kv=8).
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    norm_type="rmsnorm",
    rotary_pct=1.0,
    act="silu",
    mlp_gated=True,
    moe_style="arctic",
    n_experts=128,
    top_k=2,
    d_expert=4864,
    dense_d_ff=4864,
    capacity_factor=1.25,
    moe_groups=32,   # divides data(16) and pod*data(32)
    param_dtype=torch.bfloat16,
    sharding_profile="ep_fsdp",
    serve_profile="ep_fsdp",  # serving params 960GB bf16: must storage-shard
    shard_cache_seq=True,
)

ARCH = ArchSpec(config=CONFIG, source="hf:Snowflake/snowflake-arctic-base",
                grad_accum=1, grad_accum_multipod=8)
