"""Model facade: embeddings, modality frontends, LM head, loss, serving.

The port's counterpart of ``repro.models.model``.  ``build_model(config)``
returns an :class:`LM` (decoder-only: the ``dense``, ``moe``, ``ssm``,
``hybrid`` and ``vlm`` families) or a :class:`Seq2Seq` (the ``audio``
encoder-decoder), each with the reference's surface:

  * ``param_specs()``          — pytree of ParamSpec
  * ``init(generator)``        — concrete params (a ``torch.Generator``)
  * ``loss(params, batch)``    — scalar LM loss (+ MoE aux), differentiable
    in the leaves of ``params`` (``repro_torch.train.step`` takes its
    gradient with ``torch.autograd.grad``)
  * ``prefill(params, batch)`` — (last-position logits, cache)
  * ``decode_step(params, tokens, cache)`` — (logits, cache); consumes
    the cache it is given (it updates it in place)

Batches are dicts of tensors; the modality frontends are stubs, as in
the reference: ``patch_embeds`` / ``frame_embeds`` arrive pre-computed at
``d_model`` and pass through a learned projection.  Both models are
``nn.Module``s whose parameters are the tree's leaves, with the tree's
paths as ``state_dict()`` keys (``backbone.unit.0.attn.wq``, stacked over
layers; ``encoder.*``/``decoder.*`` for the encoder-decoder).  The
module's own parameters do not require grad (serving takes them as they
are); a train step passes a tree of its own leaves that do.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.graphs.structs import DeviceLike, resolve_device
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import NEG_INF
from repro_torch.models.common import ModelConfig, ParamSpec


def _embed_specs(config: ModelConfig) -> Dict[str, ParamSpec]:
    d, vp = config.d_model, config.padded_vocab
    s = {"tok_embed": ParamSpec((vp, d), ("vocab", "embed"), scale=0.02)}
    if not config.tie_embeddings:
        s["lm_head"] = ParamSpec((d, vp), ("embed", "vocab"), scale=d ** -0.5)
    if config.frontend == "patch_stub":
        s["patch_proj"] = ParamSpec((d, d), ("embed", "embed"), scale=d ** -0.5)
    if config.frontend == "audio_stub":
        s["frame_proj"] = ParamSpec((d, d), ("embed", "embed"), scale=d ** -0.5)
    return s


def _logits(params, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    if config.tie_embeddings:
        w = params["tok_embed"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    logits = x @ w
    # mask the vocab padding rows out of the softmax
    if config.padded_vocab != config.vocab_size:
        pad_mask = torch.arange(config.padded_vocab,
                                device=x.device) >= config.vocab_size
        logits = logits.masked_fill(pad_mask, NEG_INF)
    return logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy by a one-hot reduction, in float32 (the reference's;
    no gradient through the row maximum, as its ``stop_gradient``)."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    shifted = lf - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    onehot = nn.functional.one_hot(labels.long(), logits.shape[-1]).float()
    label_logit = (shifted * onehot).sum(dim=-1)
    nll = lse - label_logit
    if valid_mask is not None:
        valid_mask = valid_mask.float()
        nll = nll * valid_mask
        return nll.sum() / torch.clamp(valid_mask.sum(), min=1.0)
    return nll.mean()


def lm_param_specs(config: ModelConfig,
                   plan: Optional[tfm.LayerPlan] = None) -> Dict[str, Any]:
    """The ParamSpec tree of ``build_model(config)``: the decoder LM's
    (``embed``, ``backbone``), or for the ``audio`` family the
    encoder-decoder's (``embed``, ``encoder``, ``decoder``)."""
    if config.family == "audio":
        enc, dec = tfm.seq2seq_plans(config)
        return {"embed": _embed_specs(config),
                "encoder": tfm.backbone_specs(config, enc),
                "decoder": tfm.backbone_specs(config, dec)}
    return {
        "embed": _embed_specs(config),
        "backbone": tfm.backbone_specs(config, plan or tfm.layer_plan(config)),
    }


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class _Node(nn.Module):
    """One dict of the parameter tree: tensors become parameters, dicts
    nodes and lists ``ModuleList``s, each under its key."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, sub in tree.items():
            if _is_tensor(sub):
                self.register_parameter(
                    key, nn.Parameter(sub, requires_grad=False))
            elif isinstance(sub, dict):
                self.add_module(key, _Node(sub))
            else:
                self.add_module(key, nn.ModuleList(_Node(s) for s in sub))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self._parameters)
        for key, module in self._modules.items():
            out[key] = (module.tree() if isinstance(module, _Node)
                        else [m.tree() for m in module])
        return out


class _Model(nn.Module):
    """What both models share: the parameter tree as modules, on
    ``device`` (the card unless one is named; no card and no named
    device raises).  Until :meth:`init` or :meth:`load_params` the
    parameters are ``meta`` tensors.  The methods take the parameter
    tree explicitly, as the reference's do; :meth:`params` returns the
    module's own."""

    def __init__(self, config: ModelConfig, mesh=None,
                 device: DeviceLike = None):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(
                "a model on a mesh waits for the launch slice (ROADMAP "
                "Queue A item (e), launch/mesh.py)")
        self.config = config
        self.device = resolve_device(device)
        self._set(cm.abstract_tree(self.param_specs(), config.param_dtype))

    def _set(self, tree) -> Dict[str, Any]:
        self._trees = tuple(tree)
        for key, sub in tree.items():
            setattr(self, key, _Node(sub))
        return self.params()

    # -- parameters -------------------------------------------------------
    def param_specs(self):
        raise NotImplementedError

    def params(self) -> Dict[str, Any]:
        """The module's parameter tree (its own tensors, no copies)."""
        return {key: getattr(self, key).tree() for key in self._trees}

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Draw every parameter from ``generator`` (on this model's device),
        a stacked leaf one layer at a time (an expert leaf one expert at
        a time), in ``config.param_dtype``."""
        stacked = tuple(f"{key}.unit." for key in self._trees)
        return self._set(cm.init_tree(
            generator, self.param_specs(), self.config.param_dtype,
            self.device, stacked=stacked))

    def load_params(self, tree) -> Dict[str, Any]:
        """Take ``tree`` (the reference's layout, tensors) as the module's
        parameters, on this model's device in ``config.param_dtype``;
        raises on a missing, extra or misshapen leaf."""
        check_tree(tree, self.param_specs())
        dtype, device = self.config.param_dtype, self.device
        return self._set(cm.tree_map(
            lambda t: t.to(device=device, dtype=dtype), tree, _is_tensor))

    def _embed_tokens(self, params, tokens: torch.Tensor) -> torch.Tensor:
        # gathered, then cast (the same values as the reference's cast
        # table, gathered): the backward sums a token's rows in the table's
        # float32, where the reference's scatter-add sums them in the
        # compute type (PERF.md §6)
        return params["embed"]["tok_embed"][tokens.long()].to(
            self.config.dtype)

    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        return torch.arange(x.shape[1], device=x.device)


class LM(_Model):
    """Decoder-only language model (dense / moe / ssm / hybrid / vlm)."""

    def __init__(self, config: ModelConfig, mesh=None,
                 device: DeviceLike = None):
        self.plan = tfm.layer_plan(config)
        super().__init__(config, mesh, device)

    def param_specs(self):
        return lm_param_specs(self.config, self.plan)

    # -- shared input processing ------------------------------------------
    def _embed_inputs(self, params, batch) -> torch.Tensor:
        config = self.config
        x = self._embed_tokens(params, batch["tokens"])
        if config.frontend == "patch_stub" and "patch_embeds" in batch:
            p = batch["patch_embeds"].to(config.dtype)
            p = p @ params["embed"]["patch_proj"].to(config.dtype)
            n = p.shape[1]
            x = torch.cat([p, x[:, n:, :]], dim=1)   # patches prepend
        return x

    # -- training ----------------------------------------------------------
    def loss(self, params, batch):
        config = self.config
        x = self._embed_inputs(params, batch)
        ctx = tfm.BlockCtx(config=config, mode="train",
                           positions=self._positions(x), max_cache_len=0)
        x, _, aux = tfm.backbone_apply(params["backbone"], x, ctx,
                                       plan=self.plan)
        logits = _logits(params["embed"], x, config)
        ce = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
        if not isinstance(aux, torch.Tensor):     # no MoE layer: 0.0
            aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux}

    # -- serving -----------------------------------------------------------
    def prefill(self, params, batch, max_len: int = 0):
        """Build the cache; ``max_len`` reserves decode capacity beyond
        the prompt (defaults to prompt length - no decode room)."""
        config = self.config
        x = self._embed_inputs(params, batch)
        ctx = tfm.BlockCtx(config=config, mode="prefill",
                           positions=self._positions(x),
                           max_cache_len=max(max_len, x.shape[1]))
        x, cache, _ = tfm.backbone_apply(params["backbone"], x, ctx,
                                         plan=self.plan)
        logits = _logits(params["embed"], x[:, -1:, :], config)
        return logits, cache

    def decode_step(self, params, tokens: torch.Tensor, cache):
        """One step of ``tokens`` (B, t) against ``cache``, which it
        consumes: the step writes its K/V and new recurrent states into
        the cache's tensors and returns them with the new lengths."""
        config = self.config
        x = self._embed_tokens(params, tokens)
        ctx = tfm.BlockCtx(config=config, mode="decode", positions=None,
                           max_cache_len=0)
        x, cache, _ = tfm.backbone_apply(
            params["backbone"], x, ctx, cache=cache, plan=self.plan)
        logits = _logits(params["embed"], x, config)
        return logits, cache

    def init_cache(self, batch: int, max_len: int):
        return tfm.init_cache(self.config, batch, max_len, plan=self.plan,
                              device=self.device)


def check_tree(tree, specs) -> None:
    """Raise ``ValueError`` unless ``tree``'s leaves have exactly the paths
    and shapes of ``specs``."""
    have = {path: tuple(leaf.shape) for path, leaf in
            cm.tree_leaves_with_path(tree, lambda x: hasattr(x, "shape"))}
    want = {path: tuple(spec.shape) for path, spec in
            cm.tree_leaves_with_path(specs, cm.is_spec)}
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    wrong = sorted(f"{p}: {have[p]} != {want[p]}"
                   for p in set(want) & set(have) if have[p] != want[p])
    if missing or extra or wrong:
        raise ValueError(f"parameter tree differs from the model's specs: "
                         f"missing {missing}, extra {extra}, misshapen "
                         f"{wrong}")


class Seq2Seq(_Model):
    """Encoder-decoder LM (the ``audio`` family's seamless backbone): a
    bidirectional encoder over the stub's frame embeddings, and a
    decoder of causal self-attention, cross-attention and MLP."""

    def __init__(self, config: ModelConfig, mesh=None,
                 device: DeviceLike = None):
        self.enc_plan, self.dec_plan = tfm.seq2seq_plans(config)
        super().__init__(config, mesh, device)

    def param_specs(self):
        return lm_param_specs(self.config)

    def encode(self, params, batch) -> torch.Tensor:
        config = self.config
        frames = batch["frame_embeds"].to(config.dtype)
        x = frames @ params["embed"]["frame_proj"].to(config.dtype)
        ctx = tfm.BlockCtx(config=config, mode="train",
                           positions=self._positions(x), max_cache_len=0)
        x, _, _ = tfm.backbone_apply(params["encoder"], x, ctx,
                                     plan=self.enc_plan)
        return x

    def loss(self, params, batch):
        config = self.config
        enc_out = self.encode(params, batch)
        x = self._embed_tokens(params, batch["tokens"])
        ctx = tfm.BlockCtx(config=config, mode="train",
                           positions=self._positions(x), max_cache_len=0,
                           enc_out=enc_out)
        x, _, _ = tfm.backbone_apply(params["decoder"], x, ctx,
                                     plan=self.dec_plan)
        logits = _logits(params["embed"], x, config)
        ce = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}

    def prefill(self, params, batch, max_len: int = 0):
        """Encode ``frame_embeds``, then prefill the decoder with
        ``tokens``; the cache holds each layer's cross K/V."""
        config = self.config
        enc_out = self.encode(params, batch)
        x = self._embed_tokens(params, batch["tokens"])
        ctx = tfm.BlockCtx(config=config, mode="prefill",
                           positions=self._positions(x),
                           max_cache_len=max(max_len, x.shape[1]),
                           enc_out=enc_out)
        x, cache, _ = tfm.backbone_apply(params["decoder"], x, ctx,
                                         plan=self.dec_plan)
        logits = _logits(params["embed"], x[:, -1:, :], config)
        return logits, cache

    def decode_step(self, params, tokens: torch.Tensor, cache):
        """As :meth:`LM.decode_step`: consumes ``cache``."""
        x = self._embed_tokens(params, tokens)
        ctx = tfm.BlockCtx(config=self.config, mode="decode",
                           positions=None, max_cache_len=0)
        x, cache, _ = tfm.backbone_apply(
            params["decoder"], x, ctx, cache=cache, plan=self.dec_plan)
        logits = _logits(params["embed"], x, self.config)
        return logits, cache

    def init_cache(self, batch: int, max_len: int, src_len: int = 0):
        return tfm.init_cache(self.config, batch, max_len,
                              plan=self.dec_plan, device=self.device,
                              src_len=src_len or max_len)


def build_model(config: ModelConfig, mesh=None,
                device: DeviceLike = None):
    if config.family == "audio":
        return Seq2Seq(config, mesh, device)
    return LM(config, mesh, device)
