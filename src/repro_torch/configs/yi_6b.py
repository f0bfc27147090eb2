"""yi-6b — [arXiv:2403.04652; hf:01-ai/Yi-6B].

Assignment: [dense] 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-architecture GQA.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
    norm_type="rmsnorm",
    rotary_pct=1.0,
    rope_theta=10_000.0,
    act="silu",
    mlp_gated=True,
    param_dtype=torch.bfloat16,   # fsdp weight AGs in bf16 (f32 doubles wire)
    sharding_profile="fsdp",    # kv=4 GQA cannot TP-shard on 16 (see §Perf it.8)
    serve_profile="tp",
    shard_cache_seq=True,
)

ARCH = ArchSpec(config=CONFIG, source="arXiv:2403.04652", grad_accum=1)
