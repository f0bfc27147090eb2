"""olmo-1b — [arXiv:2402.00838; hf:allenai/OLMo-1B].

Assignment: [dense] 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm (no affine), SwiGLU, tied embeddings, full rotary.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    norm_type="nonparametric",
    rotary_pct=1.0,
    rope_theta=10_000.0,
    act="silu",
    mlp_gated=True,
    tie_embeddings=True,
    sharding_profile="fsdp",   # 1.3B on 256 chips: DP-dominant (see §Perf)
    serve_profile="tp",
)

ARCH = ArchSpec(config=CONFIG, source="arXiv:2402.00838")
