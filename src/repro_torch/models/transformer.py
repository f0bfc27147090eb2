"""LM assembly: block registry, layer plan, loop over layers.

The port's counterpart of ``repro.models.transformer``.  Every
architecture is a *layer plan*: an optional unrolled ``prefix`` (e.g.
DeepSeek-MoE's first dense layer), a repeating ``unit`` of block types
run ``n_repeat`` times with its parameters stacked on a leading layer
axis, and an optional ``shared`` block applied after each unit
repetition with one weight set and a cache per use (Zamba2's shared
attention).  Where the reference scans over the layer axis, the port
loops over it with views of the stacked parameters (no copies) and
returns the stacked cache the scan returns.  In the training mode under
autograd, one repetition of the unit (with the shared block) is rematted
as the config says (:func:`remat_unit`), as the reference's scan body
is; serving has no remat.

A block's cache is any of: a :class:`~repro_torch.models.attention.
KVCache`; an :class:`~repro_torch.models.ssm.SSMState` (Mamba2, mLSTM) or
:class:`~repro_torch.models.ssm.SLSTMState`; the decoder block's
``{"self": KVCache, "cross_k", "cross_v"}``.  The machinery below stacks,
slices and merges them generically: tensors carry the layer axis, a
``length`` (a Python int) is one for every layer.

A decode step **updates the cache it is given in place**: attention
writes its K/V into the cache's tensors (``attention.attention_block``),
and the recurrent blocks' new states (which ``ssm`` computes as new
tensors) are copied into the given state's tensors.  The returned cache
holds the given tensors, with the new lengths, for every block kind.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ModelConfig, ParamSpec


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------

class LayerPlan(NamedTuple):
    prefix: Tuple[str, ...]    # unrolled leading blocks
    unit: Tuple[str, ...]      # repeated block pattern (params stacked)
    n_repeat: int
    shared: Optional[str]      # block applied after each unit repetition


def layer_plan(config: ModelConfig) -> LayerPlan:
    """The decoder-only plan of ``config`` (the ``audio`` family's two
    plans are :func:`seq2seq_plans`)."""
    L = config.n_layers
    if config.family in ("dense", "vlm"):
        return LayerPlan((), ("attn_mlp",), L, None)
    if config.family == "moe":
        k = config.first_k_dense
        return LayerPlan(("attn_dense_mlp",) * k, ("attn_moe",), L - k, None)
    if config.family == "ssm":           # xLSTM
        se = config.slstm_every
        if se > 0:
            if L % se:
                raise ValueError(f"{L} layers are not a multiple of "
                                 f"slstm_every={se}")
            unit = ("mlstm",) * (se - 1) + ("slstm",)
            return LayerPlan((), unit, L // se, None)
        return LayerPlan((), ("mlstm",), L, None)
    if config.family == "hybrid":        # Zamba2
        ae = config.attn_every
        if ae <= 0 or L % ae:
            raise ValueError(f"{L} layers need a positive attn_every that "
                             f"divides them, got {ae}")
        shared = "shared_attn_mlp" if config.d_ff > 0 else "shared_attn"
        return LayerPlan((), ("mamba",) * ae, L // ae, shared)
    raise ValueError(config.family)


def seq2seq_plans(config: ModelConfig) -> Tuple[LayerPlan, LayerPlan]:
    """The encoder's and the decoder's plans of an ``audio`` config."""
    n_enc = config.n_enc_layers or config.n_layers
    n_dec = config.n_dec_layers or config.n_layers
    return (LayerPlan((), ("enc_attn_mlp",), n_enc, None),
            LayerPlan((), ("dec_block",), n_dec, None))


# ---------------------------------------------------------------------------
# Block registry: specs(config) and apply(params, x, ctx, cache) per type
# ---------------------------------------------------------------------------

class BlockCtx(NamedTuple):
    config: ModelConfig
    mode: str                  # train | prefill | decode
    positions: Optional[torch.Tensor]
    max_cache_len: int
    enc_out: Optional[torch.Tensor] = None   # encoder memory (enc-dec)


def _attn_mlp_specs(config: ModelConfig, dense_ff: bool = False):
    d_ff = config.dense_d_ff if dense_ff and config.dense_d_ff else config.d_ff
    return {
        "ln_attn": cm.norm_params(config, config.d_model),
        "attn": attn.attention_specs(config),
        "ln_mlp": cm.norm_params(config, config.d_model),
        "mlp": mlp_mod.mlp_specs(config, d_ff=d_ff),
    }


def _pad_cache_len(k: torch.Tensor, max_len: int) -> torch.Tensor:
    """Grow the cache seq dim to capacity (prefill must leave decode room)."""
    pad = max_len - k.shape[1]
    if pad <= 0:
        return k
    return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))


def _apply_attn(params, x: torch.Tensor, ctx: BlockCtx, cache):
    config = ctx.config
    h = cm.apply_norm(x, params["ln_attn"], config)
    if ctx.mode == "train":
        out, _ = attn.attention_block(
            params["attn"], h, config, positions=ctx.positions, cache=None)
        new_cache = None
    elif ctx.mode == "prefill":
        out, (k, v) = attn.attention_block(
            params["attn"], h, config, positions=ctx.positions, cache=None)
        new_cache = attn.KVCache(
            k=_pad_cache_len(k.to(config.dtype), ctx.max_cache_len),
            v=_pad_cache_len(v.to(config.dtype), ctx.max_cache_len),
            length=x.shape[1],
        )
    else:  # decode
        out, new_cache = attn.attention_block(params["attn"], h, config,
                                              cache=cache)
    return x + out, new_cache


def _apply_attn_mlp(params, x: torch.Tensor, ctx: BlockCtx, cache):
    x, new_cache = _apply_attn(params, x, ctx, cache)
    h = cm.apply_norm(x, params["ln_mlp"], ctx.config)
    x = x + mlp_mod.mlp_apply(params["mlp"], h, ctx.config)
    return x, new_cache, 0.0


def _attn_moe_specs(config: ModelConfig):
    return {
        "ln_attn": cm.norm_params(config, config.d_model),
        "attn": attn.attention_specs(config),
        "ln_mlp": cm.norm_params(config, config.d_model),
        "moe": mlp_mod.moe_specs(config),
    }


def _apply_attn_moe(params, x: torch.Tensor, ctx: BlockCtx, cache):
    x, new_cache = _apply_attn(params, x, ctx, cache)
    h = cm.apply_norm(x, params["ln_mlp"], ctx.config)
    y, aux = mlp_mod.moe_apply(params["moe"], h, ctx.config)
    return x + y, new_cache, aux


def _recurrent(key: str, specs_fn, apply, decode):
    """A pre-norm residual block (norm ``ln``) around an ``ssm``
    apply/decode pair whose parameters sit under ``key``."""

    def specs(config: ModelConfig):
        return {"ln": cm.norm_params(config, config.d_model),
                key: specs_fn(config)}

    def run(params, x: torch.Tensor, ctx: BlockCtx, cache):
        config = ctx.config
        h = cm.apply_norm(x, params["ln"], config)
        if ctx.mode == "train":
            y, new_cache = apply(params[key], h, config), None
        elif ctx.mode == "prefill":
            y, new_cache = apply(params[key], h, config, return_state=True)
        else:
            y, new_cache = decode(params[key], h, config, cache)
        return x + y, new_cache, 0.0

    return specs, run


def _shared_attn_specs(config: ModelConfig):
    return {
        "ln": cm.norm_params(config, config.d_model),
        "attn": attn.attention_specs(config),
    }


def _apply_shared_attn(params, x: torch.Tensor, ctx: BlockCtx, cache):
    x, new_cache = _apply_attn(
        {"ln_attn": params["ln"], "attn": params["attn"]}, x, ctx, cache)
    return x, new_cache, 0.0


def _apply_enc_attn_mlp(params, x: torch.Tensor, ctx: BlockCtx, cache):
    """Bidirectional encoder block — never cached."""
    config = ctx.config
    h = cm.apply_norm(x, params["ln_attn"], config)
    out, _ = attn.attention_block(params["attn"], h, config,
                                  positions=ctx.positions, causal=False,
                                  cache=None)
    x = x + out
    h = cm.apply_norm(x, params["ln_mlp"], config)
    x = x + mlp_mod.mlp_apply(params["mlp"], h, config)
    return x, None, 0.0


def _dec_block_specs(config: ModelConfig):
    return {
        "ln_self": cm.norm_params(config, config.d_model),
        "self_attn": attn.attention_specs(config),
        "ln_cross": cm.norm_params(config, config.d_model),
        "cross_attn": attn.attention_specs(config),
        "ln_mlp": cm.norm_params(config, config.d_model),
        "mlp": mlp_mod.mlp_specs(config),
    }


def _cross_kv(params, enc_out: torch.Tensor, config: ModelConfig):
    k = torch.einsum("btd,dhk->bthk", enc_out, params["wk"].to(enc_out.dtype))
    v = torch.einsum("btd,dhk->bthk", enc_out, params["wv"].to(enc_out.dtype))
    return k, v


def _apply_dec_block(params, x: torch.Tensor, ctx: BlockCtx, cache):
    """Decoder block: causal self-attn (cached) + cross-attn + MLP.

    Cache layout: {"self": KVCache, "cross_k": ..., "cross_v": ...} — the
    cross K/V are computed once from the encoder memory at prefill and
    reused every decode step.
    """
    config = ctx.config
    x, self_cache = _apply_attn(
        {"ln_attn": params["ln_self"], "attn": params["self_attn"]}, x, ctx,
        cache["self"] if ctx.mode == "decode" else None)
    h = cm.apply_norm(x, params["ln_cross"], config)
    if ctx.mode == "decode":
        ck, cv = cache["cross_k"].to(h.dtype), cache["cross_v"].to(h.dtype)
    else:
        ck, cv = _cross_kv(params["cross_attn"], ctx.enc_out, config)
    out, _ = attn.attention_block(params["cross_attn"], h, config,
                                  cross_kv=(ck, cv))
    x = x + out
    h = cm.apply_norm(x, params["ln_mlp"], config)
    x = x + mlp_mod.mlp_apply(params["mlp"], h, config)
    if ctx.mode == "train":
        return x, None, 0.0
    return x, {"self": self_cache, "cross_k": ck.to(config.dtype),
               "cross_v": cv.to(config.dtype)}, 0.0


_mamba = _recurrent("mamba", ssm_mod.mamba2_specs, ssm_mod.mamba2_apply,
                    ssm_mod.mamba2_decode)
_mlstm = _recurrent("mlstm", ssm_mod.mlstm_specs, ssm_mod.mlstm_apply,
                    ssm_mod.mlstm_decode)
_slstm = _recurrent("slstm", ssm_mod.slstm_specs, ssm_mod.slstm_apply,
                    ssm_mod.slstm_decode)

BLOCKS = {
    "attn_mlp": (_attn_mlp_specs, _apply_attn_mlp),
    "enc_attn_mlp": (_attn_mlp_specs, _apply_enc_attn_mlp),
    "dec_block": (_dec_block_specs, _apply_dec_block),
    "attn_dense_mlp": (
        functools.partial(_attn_mlp_specs, dense_ff=True), _apply_attn_mlp),
    "attn_moe": (_attn_moe_specs, _apply_attn_moe),
    "mamba": _mamba,
    "mlstm": _mlstm,
    "slstm": _slstm,
    "shared_attn": (_shared_attn_specs, _apply_shared_attn),
    # Zamba2-style shared transformer block: attention + MLP, one set of
    # weights applied after every unit repetition (caches stay per use)
    "shared_attn_mlp": (_attn_mlp_specs, _apply_attn_mlp),
}

_ATTN_BLOCKS = {"attn_mlp", "attn_dense_mlp", "attn_moe", "shared_attn",
                "shared_attn_mlp"}


def _stack_spec(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec((n,) + spec.shape, (None,) + spec.logical_axes,
                     spec.init, spec.scale)


def _stack_tree(specs, n: int):
    return cm.tree_map(lambda s: _stack_spec(s, n), specs, cm.is_spec)


# ---------------------------------------------------------------------------
# Caches: construction, stacking, layer views
# ---------------------------------------------------------------------------

def init_block_cache(btype: str, batch: int, max_len: int,
                     config: ModelConfig, device=None, src_len: int = 0):
    if btype in _ATTN_BLOCKS:
        return attn.init_kv_cache(batch, max_len, config, config.dtype,
                                  device)
    if btype == "dec_block":
        kv_shape = (batch, src_len, config.n_kv_heads, config.hd)
        return {
            "self": attn.init_kv_cache(batch, max_len, config, config.dtype,
                                       device),
            "cross_k": torch.zeros(kv_shape, dtype=config.dtype,
                                   device=device),
            "cross_v": torch.zeros(kv_shape, dtype=config.dtype,
                                   device=device),
        }
    if btype == "mamba":
        return ssm_mod.mamba2_init_state(batch, config, config.dtype, device)
    if btype == "mlstm":
        return ssm_mod.mlstm_init_state(batch, config, config.dtype, device)
    if btype == "slstm":
        return ssm_mod.slstm_init_state(batch, config, device)
    raise ValueError(btype)


def _is_cache_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, int))


def _cache_leaves(cache) -> Dict[str, Any]:
    return dict(cm.tree_leaves_with_path(cache, _is_cache_leaf))


def _stack_caches(caches):
    """Per-layer caches as one cache with a leading layer axis on every
    tensor; a ``length`` must be the same in every layer."""
    per_layer = [_cache_leaves(c) for c in caches]

    def stack(path: str, leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.stack([layer[path] for layer in per_layer])
        if any(layer[path] != leaf for layer in per_layer):
            raise ValueError(f"{path} differs between the layers")
        return leaf

    return cm.tree_map_with_path(stack, caches[0], _is_cache_leaf)


def _layer_view(cache, i: int):
    """Layer ``i`` of a stacked cache, as views of its tensors."""
    return cm.tree_map(lambda t: t[i] if isinstance(t, torch.Tensor) else t,
                       cache, _is_cache_leaf)


def _with_lengths(stacked, layer):
    """``stacked``'s tensors with the lengths of one of its layers."""
    lengths = _cache_leaves(layer)
    return cm.tree_map_with_path(
        lambda path, leaf: leaf if isinstance(leaf, torch.Tensor)
        else lengths[path], stacked, _is_cache_leaf)


def _consume(given, out):
    """Copy a decode step's new state tensors ``out`` into the cache
    ``given`` (those it did not write already), and return ``given``
    with ``out``'s lengths."""
    new = _cache_leaves(out)
    for path, leaf in _cache_leaves(given).items():
        if isinstance(leaf, torch.Tensor) and new[path] is not leaf:
            leaf.copy_(new[path])
    return _with_lengths(given, out)


def init_cache(config: ModelConfig, batch: int, max_len: int,
               plan: Optional[LayerPlan] = None, device=None,
               src_len: int = 0):
    """Full-model cache pytree matching the layer plan (zeros, length 0)."""
    plan = plan or layer_plan(config)
    n = plan.n_repeat

    def block(btype: str, src: int = 0):
        return init_block_cache(btype, batch, max_len, config, device, src)

    cache = {
        "prefix": [block(b, src_len) for b in plan.prefix],
        "unit": [_stack_caches([block(b, src_len)] * n) for b in plan.unit],
    }
    if plan.shared is not None:
        cache["shared"] = _stack_caches([block(plan.shared)] * n)
    return cache


# ---------------------------------------------------------------------------
# Backbone specs / apply
# ---------------------------------------------------------------------------

def backbone_specs(config: ModelConfig,
                   plan: Optional[LayerPlan] = None) -> Dict[str, Any]:
    plan = plan or layer_plan(config)
    specs: Dict[str, Any] = {
        "prefix": [BLOCKS[b][0](config) for b in plan.prefix],
        "unit": [_stack_tree(BLOCKS[b][0](config), plan.n_repeat)
                 for b in plan.unit],
        "final_norm": cm.norm_params(config, config.d_model),
    }
    if plan.shared is not None:
        specs["shared"] = BLOCKS[plan.shared][0](config)
    return specs


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree, as views."""
    return cm.tree_map(lambda t: t[i], tree,
                       lambda x: isinstance(x, torch.Tensor))


# the 2-D products, which "dots" keeps (jax.checkpoint_policies.
# checkpoint_dots_with_no_batch_dims): x @ w reaches aten as mm
_DOTS = {torch.ops.aten.mm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_unit(fn, remat: str):
    """``fn`` (one repetition of the unit) under the config's ``remat``:
    ``"full"`` keeps nothing inside it for the backward (it is run again),
    ``"dots"`` keeps the outputs of the 2-D products and runs the rest
    again, ``"none"`` is ``fn`` itself.  The values are the same in all
    three."""
    if remat == "none":
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"remat must be none, dots or full, got {remat!r}")
    kwargs = {} if remat == "full" else {
        "context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)}
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                             **kwargs)


def backbone_apply(params, x: torch.Tensor, ctx: BlockCtx, cache=None,
                   plan: Optional[LayerPlan] = None):
    """Run all layers. Returns (x, new_cache, aux_loss_sum).

    Prefill builds each layer's cache and stacks them; decode runs each
    layer on a view of the stacked cache it is given and updates it in
    place (see the module's docstring), returning it with the new
    lengths.
    """
    config = ctx.config
    plan = plan or layer_plan(config)
    decode = ctx.mode == "decode"
    use_cache = ctx.mode != "train"
    new_cache: Dict[str, Any] = {"prefix": [], "unit": None}
    aux_total = 0.0

    def run(btype, block_params, x, c_in):
        x, c_out, aux = BLOCKS[btype][1](block_params, x, ctx, c_in)
        if decode:
            c_out = _consume(c_in, c_out)
        return x, c_out, aux

    for i, btype in enumerate(plan.prefix):
        c_in = cache["prefix"][i] if decode else None
        x, c_out, aux = run(btype, params["prefix"][i], x, c_in)
        aux_total = aux_total + aux
        new_cache["prefix"].append(c_out)

    unit_in = cache["unit"] if decode else None
    shared_in = cache.get("shared") if decode else None
    unit_out = [[] for _ in plan.unit]
    shared_out = []

    def repetition(i, x, aux_sum):
        outs = []
        for j, btype in enumerate(plan.unit):
            c_in = _layer_view(unit_in[j], i) if decode else None
            x, c_out, aux = run(btype, _layer(params["unit"][j], i), x, c_in)
            aux_sum = aux_sum + aux
            outs.append(c_out)
        shared = None
        if plan.shared is not None:
            c_in = _layer_view(shared_in, i) if decode else None
            x, shared, _ = run(plan.shared, params["shared"], x, c_in)
        return x, aux_sum, outs, shared

    if ctx.mode == "train" and torch.is_grad_enabled():
        body = remat_unit(lambda i, x, a: repetition(i, x, a)[:2],
                          config.remat)
        for i in range(plan.n_repeat):
            x, aux_total = body(i, x, aux_total)
    else:
        for i in range(plan.n_repeat):
            x, aux_total, outs, shared = repetition(i, x, aux_total)
            for j, c_out in enumerate(outs):
                unit_out[j].append(c_out)
            shared_out.append(shared)

    if decode:
        # the layers updated views of the stacked tensors
        new_cache["unit"] = [_with_lengths(stacked, outs[-1])
                             for stacked, outs in zip(unit_in, unit_out)]
        if plan.shared is not None:
            new_cache["shared"] = _with_lengths(shared_in, shared_out[-1])
    elif use_cache:
        new_cache["unit"] = [_stack_caches(outs) for outs in unit_out]
        if plan.shared is not None:
            new_cache["shared"] = _stack_caches(shared_out)
    x = cm.apply_norm(x, params["final_norm"], config)
    return x, (new_cache if use_cache else None), aux_total
