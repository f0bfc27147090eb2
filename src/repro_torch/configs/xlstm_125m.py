"""xlstm-125m — [arXiv:2405.04517].

Assignment: [ssm] 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304, sLSTM +
mLSTM blocks.  d_ff=0: xLSTM blocks carry their own up/down projections
(factor-2 mLSTM, gated sLSTM) instead of a separate FFN.  Every 4th block
is sLSTM (true recurrence, lax.scan), the rest mLSTM (chunked matrix
memory — parallel over time).

Linear-time recurrence => ``long_500k`` runs (O(1) decode state).
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    norm_type="layernorm",
    slstm_every=4,
    ssm_conv=4,
    sharding_profile="fsdp",   # 125M: model axis folds into flat DP
    serve_profile="tp",
    supports_long_context=True,
)

ARCH = ArchSpec(config=CONFIG, source="arXiv:2405.04517")
