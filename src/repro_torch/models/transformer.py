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

Every block runs one body, on a mesh or not: ``BlockCtx.place`` (a
``repro_torch.models.common.Placement``) places it, and a context made
without one gets the placement of a single rank (:func:`placed`), under
which every layout is empty and every collective the identity, so the
body computes op for op what a mesh-less body would.  On a mesh the
residual stream between blocks is laid out as the reference's
``constrain(x, "batch", "seq", "embed")`` resolves (``ctx.res``; in
decode ``"batch", None, "embed"``), which makes its ``_anchor`` between
repetitions hold by construction.  Each sub-block (attention, MLP, MoE,
recurrent, the final norm) enters from that layout and leaves to it
(``Placement.enter``/``exit``), tensor parallel where its main weight
dim is in place.  Caches are held as :func:`cache_shardings` resolves
them: prefill cuts each layer's cache to the rank's block, a recurrent
decode gathers its state, steps it and cuts it back, an attention decode
works on the rank's block (``attention._decode_seq_sharded`` where the
positions are sharded).  The recurrent blocks gather their weights on
use and compute alike on the ranks of a batch block (no head-parallel
scan).
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
    place: Any = None          # common.Placement (None: one rank)
    res: tuple = ()            # the residual stream's layout
    enc_res: tuple = ()        # enc_out's layout


def placed(ctx: BlockCtx) -> BlockCtx:
    """``ctx`` with a placement: one made without (no mesh) gets a single
    rank's, whose layouts are all empty."""
    if ctx.place is not None:
        return ctx
    flat = ((),) * 3
    return ctx._replace(place=cm.Placement.single(ctx.config), res=flat,
                        enc_res=flat)


# ---------------------------------------------------------------------------
# Sub-blocks
# ---------------------------------------------------------------------------

def _global_batch(ctx: BlockCtx, x: torch.Tensor) -> int:
    return x.shape[0] * ctx.place.n(ctx.res[0])


def _kv_layout(ctx: BlockCtx, batch: int, seq: int) -> tuple:
    c = ctx.config
    return ctx.place.layout((batch, seq, c.n_kv_heads, c.hd),
                            "batch", "kv_seq", "kv_heads", None)


def _decode_seq_axes(ctx: BlockCtx, cache, batch: int) -> tuple:
    """The axes a decode cache's positions are sharded over: a cache of
    ``s`` local positions is ``s * n`` positions long where the model
    axis (of size ``n``) shards them, which ``check_capacity`` ensures
    whenever it can."""
    place, s = ctx.place, cache.k.shape[1]
    if "model" in place.mesh.shape:
        seq = _kv_layout(ctx, batch, s * place.mesh.shape["model"])[1]
        if seq:
            return seq
    return ()


def check_capacity(place, config: ModelConfig, batch: int,
                   max_len: int) -> None:
    """Raise ``ValueError`` where a cache of ``max_len`` positions would
    leave the model axis unused by its positions only for want of
    divisibility (``shard_cache_seq``): a decode reads the sharding of
    a cache's positions from its block's length."""
    mesh = place.mesh
    if not config.shard_cache_seq or mesh.shape.get("model", 1) == 1:
        return
    m = mesh.shape["model"]
    seq = place.layout((batch, max_len * m, config.n_kv_heads, config.hd),
                       "batch", "kv_seq", "kv_heads", None)[1]
    if seq and max_len % m:
        raise ValueError(f"a cache of {max_len} positions does not divide "
                         f"into the model axis's {m} blocks "
                         f"(shard_cache_seq)")


def _attn_sub(params, ln, x, ctx: BlockCtx, specs, ln_specs, cache=None,
              causal: bool = True):
    """Pre-norm attention sub-block: (the residual's update,
    the layer's new cache (prefill: cut to its block; decode: the given
    tensors))."""
    place, config, res = ctx.place, ctx.config, ctx.res
    act = res[0]
    tp = place.split(specs["wq"], "heads", act)
    h = place.enter(x, res, tp)
    h = cm.apply_norm(h, place.weights(ln, ln_specs, act, tp), config)
    if ctx.mode == "decode":
        out, new_cache = attn.attention_block(
            params, h, config, cache=cache, place=place, specs=specs,
            act=act, tp=tp,
            seq_axes=_decode_seq_axes(ctx, cache, _global_batch(ctx, x)))
        return place.exit(out, res, tp), new_cache
    out, (k, v) = attn.attention_block(
        params, h, config, positions=ctx.positions, causal=causal,
        place=place, specs=specs, act=act, tp=tp)
    new_cache = None
    if ctx.mode == "prefill":
        dst = _kv_layout(ctx, _global_batch(ctx, x), ctx.max_cache_len)
        src = (act, (), tp if k.shape[2] != config.n_kv_heads else (), ())

        def put(t):
            t = _pad_cache_len(t.to(config.dtype), ctx.max_cache_len)
            return cm.relayout(t, place.mesh, src, dst).contiguous()

        new_cache = attn.KVCache(k=put(k), v=put(v), length=k.shape[1])
    return place.exit(out, res, tp), new_cache


def _mlp_sub(params, ln, x, ctx: BlockCtx, specs, ln_specs):
    place, res = ctx.place, ctx.res
    act = res[0]
    tp = place.split(specs["w_up"], "ffn", act)
    h = place.enter(x, res, tp)
    h = cm.apply_norm(h, place.weights(ln, ln_specs, act, tp), ctx.config)
    y = mlp_mod.mlp_apply(params, h, ctx.config, place, specs, act, tp)
    return place.exit(y, res, tp)


def _moe_sub(params, ln, x, ctx: BlockCtx, specs, ln_specs):
    place, res = ctx.place, ctx.res
    act = res[0]
    h = place.enter(x, res)
    h = cm.apply_norm(h, place.weights(ln, ln_specs, act), ctx.config)
    y, aux = mlp_mod.moe_apply(params, h, ctx.config, place, specs, act)
    return place.exit(y, res), aux


def _state_layouts(ctx: BlockCtx, btype: str, batch: int):
    """A recurrent block's state leaves: (their layout as a whole on the
    rank's batch block, their cache layout)."""
    place, act = ctx.place, ctx.res[0]

    def make():
        shapes = init_block_cache(btype, batch, 0, ctx.config, "meta")
        axes = block_cache_axes(btype, ctx.config)
        whole = cm.tree_map(lambda t: (act,) + ((),) * (t.dim() - 1),
                            shapes, _is_cache_leaf)
        held = _zip_cache(lambda t, a: place.layout(t.shape, *a.axes),
                          shapes, axes)
        return whole, held

    return place.memo(("state", btype, batch, act), make)


def _zip_cache(fn, cache, axes):
    """``fn(leaf, ax)`` over a cache's tensors and its :class:`Ax` tree."""
    ax_of = dict(cm.tree_leaves_with_path(axes, lambda a: isinstance(a, Ax)))
    return cm.tree_map_with_path(
        lambda path, t: fn(t, ax_of[path]) if isinstance(t, torch.Tensor)
        else t, cache, _is_cache_leaf)


def _relayout_tree(place, tree, src, dst):
    if place.one_rank:
        return tree
    lay_src = dict(cm.tree_leaves_with_path(src, _is_layout))
    lay_dst = dict(cm.tree_leaves_with_path(dst, _is_layout))
    return cm.tree_map_with_path(
        lambda path, t: cm.relayout(t, place.mesh, lay_src[path],
                                    lay_dst[path]).contiguous()
        if isinstance(t, torch.Tensor) else t, tree, _is_cache_leaf)


def _is_layout(x) -> bool:
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(isinstance(a, tuple)
                    and all(isinstance(n, str) for n in a) for a in x))


def _recurrent_block(key, apply, decode, params, x, ctx, cache, specs):
    """A recurrent block (``key``: its block type and its
    parameters' key): the weights gathered on use, the state gathered for
    a decode step and cut back to the cache's layout."""
    place, config, res = ctx.place, ctx.config, ctx.res
    act = res[0]
    h = place.enter(x, res)
    h = cm.apply_norm(h, place.weights(params["ln"], specs["ln"], act),
                      config)
    w = place.weights(params[key], specs[key], act)
    new_cache = None
    if ctx.mode == "train":
        y = apply(w, h, config)
    else:
        whole, held = _state_layouts(ctx, key, _global_batch(ctx, x))
        if ctx.mode == "prefill":
            y, state = apply(w, h, config, return_state=True)
        else:
            y, state = decode(w, h, config,
                              _relayout_tree(place, cache, held, whole))
        new_cache = _relayout_tree(place, state, whole, held)
    return x + place.exit(y, res), new_cache


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


def _apply_attn_mlp(params, x: torch.Tensor, ctx: BlockCtx, cache,
                    specs):
    out, new_cache = _attn_sub(params["attn"], params["ln_attn"], x, ctx,
                               specs["attn"], specs["ln_attn"], cache)
    x = x + out
    x = x + _mlp_sub(params["mlp"], params["ln_mlp"], x, ctx, specs["mlp"],
                     specs["ln_mlp"])
    return x, new_cache, 0.0


def _attn_moe_specs(config: ModelConfig):
    return {
        "ln_attn": cm.norm_params(config, config.d_model),
        "attn": attn.attention_specs(config),
        "ln_mlp": cm.norm_params(config, config.d_model),
        "moe": mlp_mod.moe_specs(config),
    }


def _apply_attn_moe(params, x: torch.Tensor, ctx: BlockCtx, cache,
                    specs):
    out, new_cache = _attn_sub(params["attn"], params["ln_attn"], x, ctx,
                               specs["attn"], specs["ln_attn"], cache)
    x = x + out
    y, aux = _moe_sub(params["moe"], params["ln_mlp"], x, ctx, specs["moe"],
                      specs["ln_mlp"])
    return x + y, new_cache, aux


def _recurrent(key: str, specs_fn, apply, decode):
    """A pre-norm residual block (norm ``ln``) around an ``ssm``
    apply/decode pair whose parameters sit under ``key``."""

    def specs(config: ModelConfig):
        return {"ln": cm.norm_params(config, config.d_model),
                key: specs_fn(config)}

    def run(params, x: torch.Tensor, ctx: BlockCtx, cache, specs):
        y, new_cache = _recurrent_block(key, apply, decode, params, x, ctx,
                                        cache, specs)
        return y, new_cache, 0.0

    return specs, run


def _shared_attn_specs(config: ModelConfig):
    return {
        "ln": cm.norm_params(config, config.d_model),
        "attn": attn.attention_specs(config),
    }


def _apply_shared_attn(params, x: torch.Tensor, ctx: BlockCtx, cache,
                       specs):
    out, new_cache = _attn_sub(params["attn"], params["ln"], x, ctx,
                               specs["attn"], specs["ln"], cache)
    return x + out, new_cache, 0.0


def _apply_enc_attn_mlp(params, x: torch.Tensor, ctx: BlockCtx, cache,
                        specs):
    """Bidirectional encoder block — never cached."""
    out, _ = _attn_sub(params["attn"], params["ln_attn"], x, ctx,
                       specs["attn"], specs["ln_attn"], causal=False)
    x = x + out
    x = x + _mlp_sub(params["mlp"], params["ln_mlp"], x, ctx, specs["mlp"],
                     specs["ln_mlp"])
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


def _apply_dec_block(params, x: torch.Tensor, ctx: BlockCtx, cache,
                     specs):
    """Decoder block: causal self-attn (cached) + cross-attn + MLP.

    Cache layout: {"self": KVCache, "cross_k": ..., "cross_v": ...} — the
    cross K/V are computed once from the encoder memory at prefill and
    reused every decode step.
    """
    place, config, res = ctx.place, ctx.config, ctx.res
    act = res[0]
    out, self_cache = _attn_sub(
        params["self_attn"], params["ln_self"], x, ctx, specs["self_attn"],
        specs["ln_self"], cache["self"] if ctx.mode == "decode" else None)
    x = x + out
    cspecs = specs["cross_attn"]
    tp = place.split(cspecs["wq"], "heads", act)
    h = place.enter(x, res, tp)
    h = cm.apply_norm(h, place.weights(params["ln_cross"], specs["ln_cross"],
                                       act, tp), config)
    if ctx.mode == "decode":
        ck, cv = cache["cross_k"].to(h.dtype), cache["cross_v"].to(h.dtype)
    else:
        enc = place.enter(ctx.enc_out, ctx.enc_res, tp)
        kv = {k: params["cross_attn"][k] for k in ("wk", "wv")}
        ck, cv = _cross_kv(
            place.weights(kv, {k: cspecs[k] for k in kv}, act, tp,
                          inplace=("kv_heads",)), enc, config)
    out, _ = attn.attention_block(params["cross_attn"], h, config,
                                  cross_kv=(ck, cv), place=place,
                                  specs=cspecs, act=act, tp=tp)
    x = x + place.exit(out, res, tp)
    x = x + _mlp_sub(params["mlp"], params["ln_mlp"], x, ctx, specs["mlp"],
                     specs["ln_mlp"])
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


class Ax:
    """Logical-axes annotation of a cache leaf, a leaf itself (a plain
    tuple would be walked as a container), so an axes tree zips against
    a cache tree."""

    def __init__(self, *axes):
        self.axes = axes

    def __repr__(self):
        return f"Ax{self.axes}"

    def __eq__(self, other):
        return isinstance(other, Ax) and self.axes == other.axes


def block_cache_axes(btype: str, config: ModelConfig):
    """Logical axes for one block's cache, mirroring init_block_cache.

    KV caches carry ("batch", "kv_seq", "kv_heads", None): with
    ``shard_cache_seq`` the seq dim takes the model axis; otherwise
    kv_heads does — resolve_spec's used-axis bookkeeping makes the two
    mutually exclusive.  A ``length`` is ``Ax()``."""
    kv = Ax("batch", "kv_seq", "kv_heads", None)
    if btype in _ATTN_BLOCKS:
        return attn.KVCache(k=kv, v=kv, length=Ax())
    if btype == "dec_block":
        cross = Ax("batch", None, "kv_heads", None)
        return {"self": attn.KVCache(k=kv, v=kv, length=Ax()),
                "cross_k": cross, "cross_v": cross}
    if btype in ("mamba", "mlstm"):
        return ssm_mod.SSMState(conv=Ax("batch", None, "ffn"),
                                ssd=Ax("batch", "heads", None, None))
    if btype == "slstm":
        a = Ax("batch", "heads", None)
        return ssm_mod.SLSTMState(h=a, c=a, n=a, m=a)
    raise ValueError(btype)


def cache_axes(config: ModelConfig, plan: Optional[LayerPlan] = None):
    """Logical-axes tree matching ``init_cache`` (Ax leaves; the stacked
    entries with a leading layer axis of None)."""
    plan = plan or layer_plan(config)

    def stack(tree):
        return cm.tree_map(lambda a: Ax(None, *a.axes), tree,
                           lambda x: isinstance(x, Ax))

    axes = {"prefix": [block_cache_axes(b, config) for b in plan.prefix],
            "unit": [stack(block_cache_axes(b, config)) for b in plan.unit]}
    if plan.shared is not None:
        axes["shared"] = stack(block_cache_axes(plan.shared, config))
    return axes


class _AxResolver:
    """Deferred sharding: logical axes resolved against a concrete shape
    (divisibility depends on it)."""

    def __init__(self, ax: Ax, mesh, rules):
        self.ax, self.mesh, self.rules = ax, mesh, rules

    def resolve(self, shape) -> cm.Sharding:
        axes = self.ax.axes
        if len(axes) != len(shape):   # a length, stacked or not
            axes = (None,) * len(shape)
        return cm.Sharding(self.mesh, cm.resolve_spec(shape, axes, self.mesh,
                                                      self.rules))


def cache_shardings(config: ModelConfig, mesh,
                    plan: Optional[LayerPlan] = None):
    """_AxResolver tree for the model cache (zip it with a cache by
    :func:`resolve_cache_shardings`)."""
    rules = cm.make_rules(config, mesh)
    return cm.tree_map(lambda a: _AxResolver(a, mesh, rules),
                       cache_axes(config, plan), lambda x: isinstance(x, Ax))


def resolve_cache_shardings(resolvers, cache):
    """Zip an _AxResolver tree with a cache (tensors, ``meta`` tensors or
    anything with a ``shape``; a Python-int ``length`` has shape ())."""
    by_path = dict(cm.tree_leaves_with_path(
        resolvers, lambda x: isinstance(x, _AxResolver)))
    return cm.tree_map_with_path(
        lambda path, leaf: by_path[path].resolve(tuple(getattr(leaf, "shape",
                                                               ()))),
        cache, _is_cache_leaf)


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
               src_len: int = 0, mesh=None):
    """Full-model cache pytree matching the layer plan (zeros, length 0);
    on a mesh, each tensor the rank's block as :func:`cache_shardings`
    resolves it."""
    plan = plan or layer_plan(config)
    if mesh is not None:
        check_capacity(cm.Placement(mesh, config), config, batch, max_len)
        whole = init_cache(config, batch, max_len, plan, "meta", src_len)
        shardings = resolve_cache_shardings(
            cache_shardings(config, mesh, plan), whole)
        by_path = dict(cm.tree_leaves_with_path(
            shardings, lambda x: isinstance(x, cm.Sharding)))
        return cm.tree_map_with_path(
            lambda path, t: torch.zeros(by_path[path].shard_shape(t.shape),
                                        dtype=t.dtype, device=device)
            if isinstance(t, torch.Tensor) else t, whole, _is_cache_leaf)
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
    ctx = placed(ctx)
    config = ctx.config
    plan = plan or layer_plan(config)
    decode = ctx.mode == "decode"
    use_cache = ctx.mode != "train"
    new_cache: Dict[str, Any] = {"prefix": [], "unit": None}
    aux_total = 0.0
    specs = ctx.place.memo(("block_specs", plan), lambda: {
        b: BLOCKS[b][0](config)
        for b in set(plan.prefix + plan.unit + (plan.shared,)) - {None}})

    def run(btype, block_params, x, c_in):
        x, c_out, aux = BLOCKS[btype][1](block_params, x, ctx, c_in,
                                         specs[btype])
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
        return _anchor(x), aux_sum, outs, shared

    def _anchor(x):
        # the reference's residual-stream constraint between repetitions
        # (not in decode); the blocks keep ctx.res, so it moves nothing
        if decode:
            return x
        return cm.constrain(x, ctx.place.mesh, config, "batch", "seq",
                            "embed", layout=ctx.res)

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
    place, act = ctx.place, ctx.res[0]
    norm = place.memo("final_norm", lambda: cm.norm_params(config,
                                                           config.d_model))
    h = cm.apply_norm(place.enter(x, ctx.res),
                      place.weights(params["final_norm"], norm, act), config)
    x = place.exit(h, ctx.res)
    return x, (new_cache if use_cache else None), aux_total

