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

On a mesh (``build_model(config, mesh)``, a ``repro_torch.runtime.Mesh``;
the model's device is then the mesh's) every rank holds exactly its
block of each leaf as ``shardings_for`` resolves it (``self.shardings``),
and ``init``, ``load_params`` and ``init_cache`` keep the rank's block.
Every rank is given the whole batch and computes on its block of it.
Without a mesh the same code runs under a single rank's placement
(``common.Placement.single``), where every layout is empty and every
collective the identity.
The embedding is vocab-parallel where ``vocab`` is in place (the rank's
rows, masked, summed over the axis); the logits are the rank's block as
the reference's ``constrain("batch", None, "vocab")`` lays them out
(:meth:`_Model.whole` joins them), with the padding mask on the global
vocab index; the cross-entropy (:func:`token_nll`) reduces its row max,
log-sum-exp and label logit over the vocab axis, and the loss is the
global masked mean: its value is the whole batch's on every rank, its
gradient the rank's part of it, whose sum over the ranks
``repro_torch.models.common``'s placement rule gives each leaf's block.
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


def token_nll(logits: torch.Tensor, labels: torch.Tensor, place,
              tp: tuple = (), v0: int = 0) -> torch.Tensor:
    """The per-token negative log-likelihood of the reference's
    ``softmax_xent``, in float32, from the rank's vocab slice ``[v0, v0 +
    V)`` of ``logits`` (split over ``tp``; the whole vocab for none): the
    row max (no gradient through it, as the reference's
    ``stop_gradient``), the sum of exponentials and the label's logit
    are each reduced over ``tp``; no one-hot wider than the slice."""
    mesh = place.mesh
    lf = logits.float()
    m = place.all_reduce(lf.amax(dim=-1, keepdim=True), tp, "max")
    shifted = lf - m
    lse = torch.log(cm.reduce_from(torch.exp(shifted).sum(dim=-1), mesh, tp))
    cols = torch.arange(v0, v0 + logits.shape[-1], device=logits.device)
    onehot = (cols == labels.long()[..., None]).float()
    label_logit = cm.reduce_from((shifted * onehot).sum(dim=-1), mesh, tp)
    return lse - label_logit


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
    module's own.  ``self.place`` places every computation: the mesh's
    placement, or a single rank's without a mesh (the same code)."""

    def __init__(self, config: ModelConfig, mesh=None,
                 device: DeviceLike = None):
        super().__init__()
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if mesh is not None and device is None else device)
        specs = self.param_specs()
        self.place, self.shardings = cm.Placement.single(config), None
        if mesh is not None:
            self.place = cm.Placement(mesh, config)
            self.shardings = cm.shardings_for(specs, config, mesh)
        sh = self._sharding_of()
        self._set(cm.tree_map_with_path(
            lambda path, s: torch.empty(
                sh[path].shard_shape(s.shape) if sh else s.shape,
                dtype=config.param_dtype, device="meta"), specs, cm.is_spec))

    def _sharding_of(self) -> Dict[str, cm.Sharding]:
        """path -> the leaf's Sharding ({} without a mesh)."""
        return dict(cm.tree_leaves_with_path(
            self.shardings, lambda x: isinstance(x, cm.Sharding)))

    def block(self, tree):
        """The rank's blocks of a tree of whole leaves (the tree itself
        without a mesh)."""
        if self.mesh is None:
            return tree
        return cm.tree_blocks(tree, self.shardings)

    def whole(self, x: torch.Tensor, shape, *logical_axes) -> torch.Tensor:
        """The whole array (of ``shape``) of the rank's block ``x`` of an
        activation laid out as ``logical_axes`` resolve for ``shape``
        (the logits: ``"batch", None, "vocab"``), gathered from the
        ranks; ``x`` itself without a mesh."""
        layout = self.place.layout(tuple(shape), *logical_axes)
        return cm.relayout(x, self.place.mesh, layout, ((),) * x.dim())

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
            self.device, stacked=stacked, shardings=self.shardings))

    def load_params(self, tree) -> Dict[str, Any]:
        """Take ``tree`` (the reference's layout, tensors) as the module's
        parameters, on this model's device in ``config.param_dtype``;
        raises on a missing, extra or misshapen leaf.  On a mesh the
        rank keeps its block of each whole leaf."""
        check_tree(tree, self.param_specs())
        dtype, device = self.config.param_dtype, self.device
        return self._set(self.block(cm.tree_map(
            lambda t: t.to(device=device, dtype=dtype), tree, _is_tensor)))

    def _ctx(self, mode: str, tokens: torch.Tensor, max_cache_len: int = 0,
             **kw):
        """(the residual layout, the blocks' context) of a batch of
        ``tokens`` (the whole batch)."""
        b, t = tokens.shape
        res = self.place.residual((b, t, self.config.d_model),
                                  decode=mode == "decode")
        positions = (None if mode == "decode" else
                     torch.arange(t, device=self.device))
        return res, tfm.BlockCtx(config=self.config, mode=mode,
                                 positions=positions,
                                 max_cache_len=max_cache_len,
                                 place=self.place, res=res, **kw)

    def _check_capacity(self, tokens: torch.Tensor, max_len: int) -> int:
        """The cache's capacity for a prefill of ``tokens`` reserving
        ``max_len`` (the prompt's length at least)."""
        cap = max(max_len, tokens.shape[1])
        tfm.check_capacity(self.place, self.config, tokens.shape[0], cap)
        return cap

    def _decode(self, params, tokens, cache, plan, key: str):
        res, ctx = self._ctx("decode", tokens)
        x = self._to_residual(self._embed_block(params, tokens, res[0]), res)
        x, cache, _ = tfm.backbone_apply(params[key], x, ctx, cache=cache,
                                         plan=plan)
        return self._logits(params, x, res)[0], cache

    # -- embeddings, logits, loss -------------------------------------------
    def _embed_specs(self) -> Dict[str, ParamSpec]:
        return self.place.memo("embed_specs",
                               lambda: _embed_specs(self.config))

    def _embed_block(self, params, tokens: torch.Tensor, act: tuple):
        """The rank's batch block (over ``act``) of the token embeddings,
        whole sequence and width: vocab-parallel where ``vocab`` is in
        place (the rank's rows, masked, summed over the axis).  Gathered,
        then cast (the same values as the reference's cast table,
        gathered): the backward sums a token's rows in the table's
        float32, where the reference's scatter-add sums them in the
        compute type (PERF.md §6)."""
        place, config, mesh = self.place, self.config, self.place.mesh
        spec = self._embed_specs()["tok_embed"]
        tp = place.split(spec, "vocab", act)
        tokens = cm.block_of(tokens, mesh, (act, ())).long()
        table = place.weight(params["embed"]["tok_embed"], spec, act, tp,
                             inplace=("vocab",))
        if not tp:
            return table[tokens].to(config.dtype)
        n = table.shape[0]
        local = tokens - place.index(tp) * n
        inside = (local >= 0) & (local < n)
        x = table[local.clamp(0, n - 1)].to(config.dtype)
        x = torch.where(inside[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
        return cm.reduce_from(x, mesh, tp)

    def _project_block(self, params, name: str, a: torch.Tensor,
                       act: tuple) -> torch.Tensor:
        """The rank's batch block of ``a`` (a frontend's embeddings, the
        whole batch) through the ``name`` projection."""
        spec = self._embed_specs()[name]
        w = self.place.weight(params["embed"][name], spec, act)
        a = cm.block_of(a, self.place.mesh, (act, (), ())).to(
            self.config.dtype)
        return a @ w.to(self.config.dtype)

    def _to_residual(self, x: torch.Tensor, res: tuple) -> torch.Tensor:
        return cm.relayout(x, self.place.mesh, self.place.block(res), res)

    def _logits(self, params, x: torch.Tensor, res: tuple,
                last: bool = False):
        """(the rank's logits block, the vocab's axes, the block's first
        vocab index) of the residual ``x`` (at its last position with
        ``last``); the vocab padding masked out of the softmax."""
        config, place = self.config, self.place
        act = res[0]
        name = "tok_embed" if config.tie_embeddings else "lm_head"
        spec = self._embed_specs()[name]
        tp = place.split(spec, "vocab", act)
        h = place.enter(x, res, tp)
        if last:
            h = h[:, -1:, :]
        w = place.weight(params["embed"][name], spec, act, tp,
                         inplace=("vocab",)).to(h.dtype)
        logits = h @ (w.T if config.tie_embeddings else w)
        v0 = place.index(tp) * logits.shape[-1]
        if config.padded_vocab != config.vocab_size:
            cols = torch.arange(v0, v0 + logits.shape[-1], device=h.device)
            logits = logits.masked_fill(cols >= config.vocab_size, NEG_INF)
        return logits, tp, v0

    def _loss(self, params, x: torch.Tensor, res: tuple, batch, aux):
        """The global masked mean of the cross-entropy (its value on
        every rank, the rank's part of its gradient) plus the aux loss,
        and the metrics."""
        place, act = self.place, res[0]
        logits, tp, v0 = self._logits(params, x, res)
        labels = cm.block_of(batch["labels"], place.mesh, (act, ()))
        nll = token_nll(logits, labels, place, tp, v0)
        mask = batch.get("loss_mask")
        if mask is None:
            part = nll.mean() * (nll.numel() / batch["labels"].numel())
        else:
            mask = mask.float()
            part = (nll * cm.block_of(mask, place.mesh, (act, ()))).sum() \
                / torch.clamp(mask.sum(), min=1.0)
        # the whole batch's value on every rank, the rank's part's gradient
        ce = place.all_reduce(part, act) + (part - part.detach())
        if not isinstance(aux, torch.Tensor):     # no MoE layer: 0.0
            aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}


class LM(_Model):
    """Decoder-only language model (dense / moe / ssm / hybrid / vlm)."""

    def __init__(self, config: ModelConfig, mesh=None,
                 device: DeviceLike = None):
        self.plan = tfm.layer_plan(config)
        super().__init__(config, mesh, device)

    def param_specs(self):
        return lm_param_specs(self.config, self.plan)

    # -- shared input processing ------------------------------------------
    def _embed_inputs(self, params, batch, res: tuple):
        x = self._embed_block(params, batch["tokens"], res[0])
        if self.config.frontend == "patch_stub" and "patch_embeds" in batch:
            p = self._project_block(params, "patch_proj",
                                    batch["patch_embeds"], res[0])
            x = torch.cat([p, x[:, p.shape[1]:, :]], dim=1)  # patches prepend
        return self._to_residual(x, res)

    # -- training ----------------------------------------------------------
    def loss(self, params, batch):
        res, ctx = self._ctx("train", batch["tokens"])
        x = self._embed_inputs(params, batch, res)
        x, _, aux = tfm.backbone_apply(params["backbone"], x, ctx,
                                       plan=self.plan)
        return self._loss(params, x, res, batch, aux)

    # -- serving -----------------------------------------------------------
    def prefill(self, params, batch, max_len: int = 0):
        """Build the cache; ``max_len`` reserves decode capacity beyond
        the prompt (defaults to prompt length - no decode room)."""
        cap = self._check_capacity(batch["tokens"], max_len)
        res, ctx = self._ctx("prefill", batch["tokens"], cap)
        x = self._embed_inputs(params, batch, res)
        x, cache, _ = tfm.backbone_apply(params["backbone"], x, ctx,
                                         plan=self.plan)
        return self._logits(params, x, res, last=True)[0], cache

    def decode_step(self, params, tokens: torch.Tensor, cache):
        """One step of ``tokens`` (B, t) against ``cache``, which it
        consumes: the step writes its K/V and new recurrent states into
        the cache's tensors and returns them with the new lengths."""
        return self._decode(params, tokens, cache, self.plan, "backbone")

    def init_cache(self, batch: int, max_len: int):
        return tfm.init_cache(self.config, batch, max_len, plan=self.plan,
                              device=self.device, mesh=self.mesh)


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

    def _encode(self, params, batch):
        """(the encoder's output, its residual layout)."""
        frames = batch["frame_embeds"]
        b, t = frames.shape[:2]
        res = self.place.residual((b, t, self.config.d_model))
        x = self._project_block(params, "frame_proj", frames, res[0])
        ctx = tfm.BlockCtx(config=self.config, mode="train",
                           positions=torch.arange(t, device=self.device),
                           max_cache_len=0, place=self.place, res=res)
        x, _, _ = tfm.backbone_apply(params["encoder"],
                                     self._to_residual(x, res), ctx,
                                     plan=self.enc_plan)
        return x, res

    def encode(self, params, batch) -> torch.Tensor:
        """The encoder's output (on a mesh: the rank's block of it, laid
        out as ``"batch", "seq", "embed"`` resolve)."""
        return self._encode(params, batch)[0]

    def _decoder(self, params, batch, mode: str, max_len: int = 0):
        enc_out, enc_res = self._encode(params, batch)
        tokens = batch["tokens"]
        res, ctx = self._ctx(mode, tokens, max_len, enc_out=enc_out,
                             enc_res=enc_res)
        x = self._to_residual(self._embed_block(params, tokens, res[0]), res)
        x, cache, _ = tfm.backbone_apply(params["decoder"], x, ctx,
                                         plan=self.dec_plan)
        return x, cache, res

    def loss(self, params, batch):
        x, _, res = self._decoder(params, batch, "train")
        return self._loss(params, x, res, batch, 0.0)

    def prefill(self, params, batch, max_len: int = 0):
        """Encode ``frame_embeds``, then prefill the decoder with
        ``tokens``; the cache holds each layer's cross K/V."""
        cap = self._check_capacity(batch["tokens"], max_len)
        x, cache, res = self._decoder(params, batch, "prefill", cap)
        return self._logits(params, x, res, last=True)[0], cache

    def decode_step(self, params, tokens: torch.Tensor, cache):
        """As :meth:`LM.decode_step`: consumes ``cache``."""
        return self._decode(params, tokens, cache, self.dec_plan, "decoder")

    def init_cache(self, batch: int, max_len: int, src_len: int = 0):
        return tfm.init_cache(self.config, batch, max_len,
                              plan=self.dec_plan, device=self.device,
                              src_len=src_len or max_len, mesh=self.mesh)


def build_model(config: ModelConfig, mesh=None,
                device: DeviceLike = None):
    if config.family == "audio":
        return Seq2Seq(config, mesh, device)
    return LM(config, mesh, device)
