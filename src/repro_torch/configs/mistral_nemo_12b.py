"""mistral-nemo-12b — [hf:mistralai/Mistral-Nemo-Base-2407].

Assignment: [dense] 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072,
128k context.  head_dim=128 (not d_model/n_heads), rope_theta=1e6.

Sharding: tp_sp — the 40-layer 4k-seq residual carries need the sequence-
parallel residual stream; kv=8 doesn't divide the 16-way model axis, so the
KV cache shards its seq dim instead (shard_cache_seq).
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    norm_type="rmsnorm",
    rotary_pct=1.0,
    rope_theta=1_000_000.0,
    act="silu",
    mlp_gated=True,
    max_seq_len=131_072,
    param_dtype=torch.bfloat16,   # fsdp weight AGs in bf16
    sharding_profile="fsdp",    # kv=8 GQA cannot TP-shard on 16 (see §Perf it.8)
    serve_profile="tp",
    shard_cache_seq=True,
)

ARCH = ArchSpec(config=CONFIG, source="hf:mistralai/Mistral-Nemo-Base-2407",
                grad_accum=1)
