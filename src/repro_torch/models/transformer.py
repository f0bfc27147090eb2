"""Decoder-only LM assembly: block registry, layer plan, loop over layers.

The port's counterpart of ``repro.models.transformer``.  Every
architecture is a *layer plan*: an optional unrolled ``prefix``, a
repeating ``unit`` of block types run ``n_repeat`` times with its
parameters stacked on a leading layer axis, and an optional ``shared``
block.  Where the reference scans over the layer axis, the port loops
over it with views of the stacked parameters (no copies) and returns the
stacked cache the scan returns.  Serving has no remat; the training mode
runs the forward only (its backward comes with the training slice).

The decoder families ``dense`` and ``vlm`` (block ``attn_mlp``) are
built; ``moe``, ``ssm`` and ``hybrid`` raise ``NotImplementedError`` from
:func:`layer_plan`, before any parameter is made (ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import ModelConfig, ParamSpec

# the families the port does not build yet, and their ROADMAP items
NOT_BUILT = {
    "moe": "ROADMAP Queue A item (a), the moe family",
    "ssm": "ROADMAP Queue A item (b), ssm.py with ssm/hybrid",
    "hybrid": "ROADMAP Queue A item (b), ssm.py with ssm/hybrid",
    "audio": "ROADMAP Queue A item (c), Seq2Seq/audio",
}


def not_built(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {family!r} family is not ported yet ({NOT_BUILT[family]})")


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------

class LayerPlan(NamedTuple):
    prefix: Tuple[str, ...]    # unrolled leading blocks
    unit: Tuple[str, ...]      # repeated block pattern (params stacked)
    n_repeat: int
    shared: Optional[str]      # block applied after each unit repetition


def layer_plan(config: ModelConfig) -> LayerPlan:
    if config.family in ("dense", "vlm"):
        return LayerPlan((), ("attn_mlp",), config.n_layers, None)
    if config.family in NOT_BUILT:
        raise not_built(config.family)
    raise ValueError(config.family)


# ---------------------------------------------------------------------------
# Block registry: specs(config) and apply(params, x, ctx, cache) per type
# ---------------------------------------------------------------------------

class BlockCtx(NamedTuple):
    config: ModelConfig
    mode: str                  # train | prefill | decode
    positions: Optional[torch.Tensor]
    max_cache_len: int


def _attn_mlp_specs(config: ModelConfig):
    return {
        "ln_attn": cm.norm_params(config, config.d_model),
        "attn": attn.attention_specs(config),
        "ln_mlp": cm.norm_params(config, config.d_model),
        "mlp": mlp_mod.mlp_specs(config),
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


BLOCKS = {
    "attn_mlp": (_attn_mlp_specs, _apply_attn_mlp),
}

_ATTN_BLOCKS = {"attn_mlp"}


def _stack_spec(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec((n,) + spec.shape, (None,) + spec.logical_axes,
                     spec.init, spec.scale)


def _stack_tree(specs, n: int):
    return cm.tree_map(lambda s: _stack_spec(s, n), specs, cm.is_spec)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def init_block_cache(btype: str, batch: int, max_len: int,
                     config: ModelConfig, device=None):
    if btype in _ATTN_BLOCKS:
        return attn.init_kv_cache(batch, max_len, config, config.dtype,
                                  device)
    raise ValueError(btype)


def _stack_caches(caches) -> attn.KVCache:
    """Per-layer caches as one cache with a leading layer axis."""
    return attn.KVCache(k=torch.stack([c.k for c in caches]),
                        v=torch.stack([c.v for c in caches]),
                        length=caches[0].length)


def _layer_view(cache: attn.KVCache, i: int) -> attn.KVCache:
    """Layer ``i`` of a stacked cache, as views of its tensors."""
    return cache._replace(k=cache.k[i], v=cache.v[i])


def init_cache(config: ModelConfig, batch: int, max_len: int,
               plan: Optional[LayerPlan] = None, device=None):
    """Full-model cache pytree matching the layer plan (zeros, length 0)."""
    plan = plan or layer_plan(config)
    n = plan.n_repeat
    cache = {
        "prefix": [init_block_cache(b, batch, max_len, config, device)
                   for b in plan.prefix],
        "unit": [_stack_caches([init_block_cache(b, batch, max_len, config,
                                                 device)] * n)
                 for b in plan.unit],
    }
    if plan.shared is not None:
        cache["shared"] = _stack_caches(
            [init_block_cache(plan.shared, batch, max_len, config,
                              device)] * n)
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


def backbone_apply(params, x: torch.Tensor, ctx: BlockCtx, cache=None,
                   plan: Optional[LayerPlan] = None):
    """Run all layers. Returns (x, new_cache, aux_loss_sum).

    Prefill builds each layer's cache and stacks them; decode writes into
    the stacked cache it is given, in place (a decode consumes its cache,
    ``attention.attention_block``), and returns it with the new length.
    """
    config = ctx.config
    plan = plan or layer_plan(config)
    new_cache: Dict[str, Any] = {"prefix": [], "unit": None}
    aux_total = 0.0
    use_cache = ctx.mode != "train"

    for i, btype in enumerate(plan.prefix):
        c_in = cache["prefix"][i] if use_cache and cache else None
        x, c_out, aux = BLOCKS[btype][1](params["prefix"][i], x, ctx, c_in)
        aux_total = aux_total + aux
        new_cache["prefix"].append(c_out)

    unit_in = cache["unit"] if use_cache and cache else None
    shared_in = cache.get("shared") if use_cache and cache else None
    unit_out = [[] for _ in plan.unit]
    shared_out = []
    for i in range(plan.n_repeat):
        for j, btype in enumerate(plan.unit):
            c_in = _layer_view(unit_in[j], i) if unit_in is not None \
                else None
            x, c_out, aux = BLOCKS[btype][1](_layer(params["unit"][j], i),
                                             x, ctx, c_in)
            aux_total = aux_total + aux
            unit_out[j].append(c_out)
        if plan.shared is not None:
            c_in = _layer_view(shared_in, i) if shared_in is not None \
                else None
            x, c_out, _ = BLOCKS[plan.shared][1](params["shared"], x, ctx,
                                                 c_in)
            shared_out.append(c_out)

    if use_cache:
        if ctx.mode == "decode":
            # the layers wrote into views of the stacked tensors
            new_cache["unit"] = [stacked._replace(length=outs[-1].length)
                                 for stacked, outs in zip(unit_in, unit_out)]
            if plan.shared is not None:
                new_cache["shared"] = shared_in._replace(
                    length=shared_out[-1].length)
        else:
            new_cache["unit"] = [_stack_caches(outs) for outs in unit_out]
            if plan.shared is not None:
                new_cache["shared"] = _stack_caches(shared_out)
    x = cm.apply_norm(x, params["final_norm"], config)
    return x, (new_cache if use_cache else None), aux_total
