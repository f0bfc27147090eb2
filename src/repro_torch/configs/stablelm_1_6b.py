"""stablelm-1.6b — [hf:stabilityai/stablelm-2-1_6b; unverified].

Assignment: [dense] 24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
StableLM-2 flavour: parametric LayerNorm, partial rotary (25%), qkv biases,
SwiGLU MLP.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    norm_type="layernorm",
    rotary_pct=0.25,
    rope_theta=10_000.0,
    use_qkv_bias=True,
    act="silu",
    mlp_gated=True,
    sharding_profile="fsdp",   # 1.6B on 256 chips: DP-dominant (see §Perf)
    serve_profile="tp",
)

ARCH = ArchSpec(config=CONFIG, source="hf:stabilityai/stablelm-2-1_6b")
