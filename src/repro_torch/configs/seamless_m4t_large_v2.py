"""seamless-m4t-large-v2 — [arXiv:2308.11596].

Assignment: [audio] 24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206,
encoder-decoder, multimodal.  Per assignment the speech frontend is a
STUB: ``input_specs`` supplies precomputed frame embeddings (already at
d_model) to the bidirectional encoder; the autoregressive text decoder
(self-attn + cross-attn + MLP) carries the decode shapes.

24 encoder + 24 decoder layers.  Training pairs ``seq_len/2`` encoder
frames with ``seq_len`` decoder tokens; serving uses ``src_frames``
encoder frames with the decoder KV cache at ``seq_len``.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    norm_type="layernorm",
    rotary_pct=0.0,            # seamless uses learned/relative positions;
                               # the backbone stub runs position-free decoder
    act="gelu",
    mlp_gated=False,
    frontend="audio_stub",
    sharding_profile="fsdp",   # 2.3B enc-dec: DP-dominant (see §Perf)
    serve_profile="tp",
)

ARCH = ArchSpec(config=CONFIG, source="arXiv:2308.11596", src_frames=4096)
