"""Dense MLP and Mixture-of-Experts blocks.

The port's counterpart of ``repro.models.mlp``, in plain torch.  The
dense MLP is gated (SwiGLU-style: act(x W_gate) ⊙ x W_up) or ungated
(act(x W_up)), then W_down, in the activations' type.

MoE uses the reference's sort-based token-permutation dispatch: tokens
are split into groups (``config.moe_groups`` where it divides the token
count, else one), each group's top-k assignments are sorted by expert
(stable), ranked within their expert (``searchsorted``), and written
into an (E, C, d) capacity buffer whose row C is a trash slot for the
assignments past capacity; the experts' products run batched over that
buffer, and each token's outputs are gathered back and summed.  The
groups run as one batched computation (the reference's ``vmap``).

Two details keep the reference's choices token for token:

  * top-k breaks ties toward the lower expert index (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none): a stable descending sort.  In
    bfloat16 the router's logits are rounded before the float32 softmax,
    so equal probabilities do occur.
  * the combine sums a token's k outputs in slot order in the
    activations' type (each token owns k consecutive slots), which
    reproduces the reference's ``segment_sum`` bit for bit in bfloat16
    and adds in the same order on every device, where an ``index_add_``
    on the card adds with atomics in whatever order they land.

On a mesh (``place``, ``repro_torch.models.common.Placement``) the dense
MLP computes its ``ffn`` slice where ``ffn`` is in place (the caller
adds the partial products over the axis).  The MoE layer follows the
reference's constraints: the tokens go to the ``moe_group`` layout, each
rank dispatches its own groups, takes its experts' slice of the
``(G, E, C, d)`` buffer and runs its experts on it (their weights'
other sharded dims gathered on use), the expert outputs are gathered
back over ``experts`` and combined group-locally, and the tokens return
to their batch layout.  The router and the combine run on every rank of
a group alike; the aux loss's means are taken over the global batch.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig, ParamSpec


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def mlp_specs(config: ModelConfig, d_ff: int | None = None) -> Dict[str, ParamSpec]:
    d, f = config.d_model, d_ff or config.d_ff
    s = {
        "w_up": ParamSpec((d, f), ("embed", "ffn"), scale=d ** -0.5),
        "w_down": ParamSpec((f, d), ("ffn", "embed"), scale=f ** -0.5),
    }
    if config.mlp_gated:
        s["w_gate"] = ParamSpec((d, f), ("embed", "ffn"), scale=d ** -0.5)
    return s


def mlp_apply(params, x: torch.Tensor, config: ModelConfig, place=None,
              specs=None, act: tuple = (), tp: tuple = ()) -> torch.Tensor:
    """The MLP of ``x``; on a mesh the rank's ``ffn`` slice's partial
    product where ``tp`` splits ``ffn``."""
    if place is not None:
        params = place.weights(params, specs, act, tp, inplace=("ffn",))
    up = x @ params["w_up"].to(x.dtype)
    if config.mlp_gated:
        gate = cm.activate(x @ params["w_gate"].to(x.dtype), config.act)
        h = gate * up
    else:
        h = cm.activate(up, config.act)
    return h @ params["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def moe_specs(config: ModelConfig) -> Dict[str, ParamSpec]:
    d, fe, E = config.d_model, config.d_expert, config.n_experts
    s = {
        "w_router": ParamSpec((d, E), (None, "experts"), scale=0.02),
        "w_up_e": ParamSpec((E, d, fe), ("experts", None, "expert_inner"),
                            scale=d ** -0.5),
        "w_gate_e": ParamSpec((E, d, fe), ("experts", None, "expert_inner"),
                              scale=d ** -0.5),
        "w_down_e": ParamSpec((E, fe, d), ("experts", "expert_inner", None),
                              scale=fe ** -0.5),
    }
    if config.n_shared_experts > 0:
        fs = config.n_shared_experts * fe
        s["shared"] = mlp_specs(config, d_ff=fs)
    if config.moe_style == "arctic":
        s["residual"] = mlp_specs(config, d_ff=config.dense_d_ff)
    return s


def _capacity(n_tokens: int, config: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * config.top_k / config.n_experts
                      * config.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8


def moe_groups(n_tokens: int, config: ModelConfig) -> int:
    """The dispatch's group count: ``moe_groups`` where it divides the
    tokens, else 1."""
    return config.moe_groups if n_tokens % config.moe_groups == 0 else 1


def top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest along the last dim and their indices, largest
    first, ties to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(xg: torch.Tensor, probs_g: torch.Tensor, config: ModelConfig,
             C: int):
    """Sort-based dispatch of every group at once.

    xg: (G, ntg, d); probs_g: (G, ntg, E) float32 router probabilities.
    Returns (buf (G, E, C, d), e_flat, rank_c, keep, gate_vals,
    expert_idx): each assignment's (G, ntg*k) expert, row (C = trash)
    and whether it fits, the renormalised top-k gates (G, ntg, k) and
    the experts chosen (G, ntg, k).
    """
    G, ntg, d = xg.shape
    E, K = config.n_experts, config.top_k
    dev = xg.device
    gate_vals, expert_idx = top_k(probs_g, K)                 # (G, ntg, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)             # renormalise
    e_flat = expert_idx.reshape(G, ntg * K)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank_sorted = torch.arange(ntg * K, device=dev) - first
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < C                                           # capacity drop
    rank_c = torch.clamp(rank, max=C)                         # row C: trash
    tok_idx = torch.arange(ntg, device=dev).repeat_interleave(K)
    g_idx = torch.arange(G, device=dev)[:, None]
    # every kept assignment has its own (expert, row); only the trash row
    # takes several writes, and it is cut off
    buf = torch.zeros((G, E, C + 1, d), dtype=xg.dtype, device=dev)
    buf[g_idx, e_flat, rank_c] = xg[:, tok_idx] * keep[..., None].to(xg.dtype)
    return buf[:, :, :C], e_flat, rank_c, keep, gate_vals, expert_idx


def combine(out: torch.Tensor, e_flat: torch.Tensor, rank_c: torch.Tensor,
            keep: torch.Tensor, gate_vals: torch.Tensor) -> torch.Tensor:
    """Expert outputs (G, E, C, d) back to token order (G, ntg, d): each
    token's k gated outputs summed in slot order in ``out``'s type."""
    G, _, C, d = out.shape
    K = gate_vals.shape[-1]
    g_idx = torch.arange(G, device=out.device)[:, None]
    gathered = out[g_idx, e_flat, torch.clamp(rank_c, max=C - 1)]
    w = (keep.float() * gate_vals.reshape(G, -1)).to(out.dtype)
    parts = (gathered * w[..., None]).reshape(G, -1, K, d)
    y = parts[:, :, 0]
    for j in range(1, K):
        y = y + parts[:, :, j]
    return y


def route(params, xf: torch.Tensor, config: ModelConfig):
    """The router and dispatch of ``xf`` (nt, d): (probs (nt, E) float32,
    then :func:`dispatch`'s outputs)."""
    nt, d = xf.shape
    G = moe_groups(nt, config)
    logits = (xf @ params["w_router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    return (probs,) + dispatch(xf.reshape(G, nt // G, d),
                               probs.reshape(G, nt // G, config.n_experts),
                               config, _capacity(nt // G, config))


def _dense(params, xf, config, place, specs, act):
    """A dense MLP inside the MoE layer, tensor parallel where its
    ``ffn`` is in place."""
    tp = place.split(specs["w_up"], "ffn", act)
    y = mlp_apply(params, cm.copy_to(xf, place.mesh, tp), config, place,
                  specs, act, tp)
    return cm.reduce_from(y, place.mesh, tp)


def moe_apply(params, x: torch.Tensor, config: ModelConfig, place=None,
              specs=None, act: tuple = ()):
    """x: (B, T, d). Returns (y, aux_loss): the routed experts' outputs
    (plus the shared experts' and, for ``arctic``, the residual dense
    FFN's) and the Switch-style load-balance loss.  On a mesh (``place``
    with the layer's ParamSpecs ``specs``), ``x`` is the rank's batch
    block over ``act`` of the whole batch, and every rank of a group
    returns the same; without one, a single rank's placement."""
    if place is None:
        place, specs = cm.Placement.single(config), moe_specs(config)
    b, t, d = x.shape
    E, K = config.n_experts, config.top_k
    mesh = place.mesh
    nt_l = b * t
    nt = nt_l * place.n(act)
    G = moe_groups(nt, config)
    ntg = nt // G
    xf = x.reshape(nt_l, d)
    router = place.weight(params["w_router"], specs["w_router"], act)
    probs = torch.softmax((xf @ router.to(xf.dtype)).float(), dim=-1)
    grp = place.layout((G, ntg, d), "moe_group", None, None)[0]

    def to_groups(a):
        a = cm.relayout(a, mesh, (act, ()), (grp, ()))
        return a.reshape(-1, ntg, a.shape[-1])

    buf, e_flat, rank_c, keep, gate_vals, expert_idx = dispatch(
        to_groups(xf), to_groups(probs), config, _capacity(ntg, config))

    # ---- expert FFN, batched over the (rank's) experts -------------------
    names = ("w_up_e", "w_gate_e", "w_down_e")
    ex = place.layout(buf.shape[:1] + (E,) + buf.shape[2:], "moe_group",
                      "experts", None, None)[1]
    split = ex if ex and not set(ex) & set(grp) else ()
    w = place.weights({k: params[k] for k in names},
                      {k: specs[k] for k in names}, grp, split,
                      inplace=("experts",))
    full, mine = (grp, (), (), ()), (grp, split, (), ())
    buf = cm.relayout(buf, mesh, full, mine)
    up = torch.einsum("gecd,edf->gecf", buf, w["w_up_e"].to(x.dtype))
    gate = cm.activate(torch.einsum("gecd,edf->gecf", buf,
                                    w["w_gate_e"].to(x.dtype)), config.act)
    out = torch.einsum("gecf,efd->gecd", gate * up,
                       w["w_down_e"].to(x.dtype)).to(x.dtype)
    out = cm.relayout(out, mesh, mine, full)

    y = combine(out, e_flat, rank_c, keep, gate_vals).reshape(-1, d)
    y = cm.relayout(y, mesh, (grp, ()), (act, ()))
    y = y.to(x.dtype)
    if config.n_shared_experts > 0:
        y = y + _dense(params["shared"], xf, config, place, specs["shared"],
                       act)
    if config.moe_style == "arctic":
        y = y + _dense(params["residual"], xf, config, place,
                       specs["residual"], act)

    # ---- load-balance aux loss (Switch-style), over the whole batch ------
    me = cm.reduce_from(probs.sum(dim=0), mesh, act) / nt   # mean router prob
    # a scatter-add of ones, not bincount: the same integers, and a
    # static shape that a meta tensor can carry
    flat = expert_idx.reshape(-1)
    counts = place.all_reduce(torch.zeros(
        E, dtype=torch.int64, device=flat.device).scatter_add_(
            0, flat, torch.ones_like(flat)), grp)
    ce = counts.float() / (nt * K)
    aux = E * torch.sum(me * ce)
    return y.reshape(b, t, d), aux
