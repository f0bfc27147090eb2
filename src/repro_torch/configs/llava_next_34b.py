"""llava-next-34b — [hf:llava-hf/llava-v1.6-34b-hf; unverified].

Assignment: [vlm] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
anyres tiling.  Per assignment the modality frontend is a STUB: the
backbone receives precomputed patch embeddings (anyres 5 tiles x 576
patches = 2880 frontend tokens) through ``input_specs``; a learned
projection maps them into the residual stream.

Sharding: fsdp (flat batch) — 60 x (4k x 7168) residual carries exceed
HBM under plain tp; grad_accum=8 bounds the multi-pod microbatch.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    norm_type="rmsnorm",
    rotary_pct=1.0,
    rope_theta=5_000_000.0,
    act="silu",
    mlp_gated=True,
    frontend="patch_stub",
    n_frontend_tokens=2880,    # anyres: 5 tiles x 576 patches
    sharding_profile="fsdp",
    serve_profile="ep",   # = tp + embed->data storage: 56 heads don't TP-shard,
                          # so attention weights must storage-shard over data
    shard_cache_seq=True,
)

ARCH = ArchSpec(config=CONFIG, source="hf:llava-hf/llava-v1.6-34b-hf",
                grad_accum=1, grad_accum_multipod=8)
