"""zamba2-2.7b — [arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B].

Assignment: [hybrid] 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64 — Mamba2 backbone + one *shared* attention+MLP block (single
weight set) applied every 6 Mamba2 blocks, with per-use KV caches.

Sharding: fsdp — the Mamba2 chunk scan is sequential over time, so the
sequence axis cannot shard; flat-batch FSDP supplies the activation relief
instead.  Mamba-2 state & linear decode => ``long_500k`` runs.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,            # shared block's MLP width
    vocab_size=32_000,
    norm_type="rmsnorm",
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    attn_every=6,          # 9 unit repetitions of 6 mamba blocks
    sharding_profile="fsdp",
    serve_profile="tp",
    supports_long_context=True,
)

ARCH = ArchSpec(config=CONFIG, source="arXiv:2411.15242")
