"""Architecture/shape registry machinery for the assigned (arch x shape) grid
(the port's ``repro.configs.base``).

Every assigned architecture ships one module exporting an :class:`ArchSpec`;
the four assignment shapes are global.  ``input_specs`` produces tensors on
the ``meta`` device (shape and dtype, no storage) for every model input of
a cell, so no giant array is ever allocated.

Shape semantics (assignment):
  * ``train_4k``    — ``train_step``  (loss + AdamW update)
  * ``prefill_32k`` — ``serve_step``  prefill: build the KV cache
  * ``decode_32k``  — ``serve_step``  decode: one new token against a
                      ``seq_len``-deep cache
  * ``long_500k``   — decode at 512k context; only sub-quadratic
                      architectures run it (ssm / hybrid), per assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One assigned architecture: exact config + grid metadata."""

    config: ModelConfig
    source: str = ""                   # public-literature citation tag
    grad_accum: int = 1                # training microbatch split (single pod)
    grad_accum_multipod: int = 0       # override for the 2-pod mesh: batch
                                       # 256 flat-shards 256 chips exactly,
                                       # but needs microbatching at 512
    src_frames: int = 4_096            # enc-dec: encoder frames at serving
    smoke_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def accum_for(self, multi_pod: bool) -> int:
        if multi_pod and self.grad_accum_multipod:
            return self.grad_accum_multipod
        return self.grad_accum

    @property
    def name(self) -> str:
        return self.config.name

    def skip_reason(self, shape_name: str) -> Optional[str]:
        shape = SHAPES[shape_name]
        if shape.name == "long_500k" and not self.config.supports_long_context:
            return ("full quadratic attention: 512k decode cache/score is "
                    "out of scope per assignment (sub-quadratic archs only)")
        if shape.kind in ("decode", "prefill") and not self.config.supports_decode:
            return "encoder-only architecture has no decode step"
        return None

    def cells(self):
        """[(shape_name, skip_reason | None)] over the full grid."""
        return [(s, self.skip_reason(s)) for s in SHAPES]

    # -- reduced config for CPU smoke tests --------------------------------
    def smoke_config(self) -> ModelConfig:
        c = self.config
        ratio = max(1, c.n_heads // max(c.n_kv_heads, 1))
        heads = 4
        kv = max(1, heads // ratio)
        over = dict(
            n_layers=4 if c.family in ("ssm", "hybrid") else 2,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=0 if c.d_ff == 0 else 128,
            vocab_size=512,
            vocab_pad_multiple=64,
            max_seq_len=512,
            remat="none",
            param_dtype=torch.float32,
        )
        if c.n_experts:
            over.update(
                n_experts=8,
                top_k=min(c.top_k, 4),
                d_expert=32,
                n_shared_experts=min(c.n_shared_experts, 1),
                first_k_dense=min(c.first_k_dense, 1),
                dense_d_ff=128 if c.dense_d_ff else 0,
                moe_groups=2,
            )
        if c.family == "hybrid":
            over.update(attn_every=2, ssm_state=16)
        if c.family == "ssm" and c.slstm_every:
            over.update(slstm_every=4)
        if c.n_enc_layers:
            over.update(n_enc_layers=2, n_dec_layers=2)
        if c.frontend == "patch_stub":
            over.update(n_frontend_tokens=4)
        over.update(self.smoke_overrides)
        return c.replace(**over)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_spec(batch: int, seq: int) -> torch.Tensor:
    return _meta((batch, seq), torch.int32)


def input_specs(arch: ArchSpec, shape_name: str) -> Dict[str, Any]:
    """``meta``-device stand-ins for the model inputs of one grid cell.

    For ``train``/``prefill`` this is the full batch dict; for ``decode``
    it is the one-token batch (the cache is built separately by the
    model's ``init_cache``).
    """
    c = arch.config
    shape = SHAPES[shape_name]
    b = shape.global_batch
    emb_dtype = c.dtype

    if shape.kind == "train":
        specs = {
            "tokens": _token_spec(b, shape.seq_len),
            "labels": _token_spec(b, shape.seq_len),
        }
        if c.frontend == "patch_stub":
            specs["patch_embeds"] = _meta(
                (b, c.n_frontend_tokens, c.d_model), emb_dtype)
        if c.frontend == "audio_stub":
            specs["frame_embeds"] = _meta(
                (b, shape.seq_len // 2, c.d_model), emb_dtype)
        return specs

    if shape.kind == "prefill":
        specs = {"tokens": _token_spec(b, shape.seq_len)}
        if c.frontend == "patch_stub":
            specs["patch_embeds"] = _meta(
                (b, c.n_frontend_tokens, c.d_model), emb_dtype)
        if c.frontend == "audio_stub":
            specs["frame_embeds"] = _meta(
                (b, arch.src_frames, c.d_model), emb_dtype)
        return specs

    # decode: one new token; the seq_len lives in the cache
    return {"tokens": _token_spec(b, 1)}
