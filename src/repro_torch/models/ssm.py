"""Linear-recurrence blocks: Mamba2 (SSD), xLSTM's mLSTM and sLSTM.

The port's counterpart of ``repro.models.ssm``, in plain torch.  One
chunked gated-linear-attention core (:func:`gla_chunked`) serves both
SSD and mLSTM: Mamba-2's SSD is scalar-decay GLA with ``q=C, k=B,
v=Δ·x, log_f=Δ·A``, and the mLSTM matrix memory is GLA plus a
normaliser row.  Within a chunk the work is dense products; across
chunks a Python loop carries the state (the reference's ``lax.scan``).

sLSTM has a true hidden-to-gate recurrence and no parallel form: a
Python loop over time, one cell a step.

Decode runs the same ``*_apply`` functions on one token with ``chunk=1``
and the carried state, as the reference does (not :func:`gla_decode`).
Every function here returns new state tensors and writes into none it
is given; the model's cache machinery
(:func:`repro_torch.models.transformer.backbone_apply`) copies a decode
step's new states into the cache it was given.

The numerics are the reference's: float32 inside the recurrences, and
the activations' type (bfloat16) op by op elsewhere, so that each step
rounds where the reference's does (:func:`conv1d_causal` sums its taps
in order in that type; ``F.conv1d`` would accumulate in float32).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig, ParamSpec

NEG_INF = -1e30


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` in ``like``'s type: a Python float meets a JAX array as a
    weak type, rounded to the array's type first."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Chunked gated linear attention (shared by SSD and mLSTM)
# ---------------------------------------------------------------------------

def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_f: torch.Tensor, *, chunk: int = 128,
                s0: Optional[torch.Tensor] = None):
    """Chunkwise-parallel scalar-gated linear attention.

    q, k: (B, T, H, N); v: (B, T, H, P); log_f: (B, T, H) (<= 0).
    Returns (out (B, T, H, P) in ``v``'s type, final state (B, H, N, P)
    float32).  Where ``chunk`` does not divide T (and T > chunk) the
    chunk is ``gcd(T, chunk)``.
    """
    b, t, h, n = q.shape
    p = v.shape[-1]
    chunk = min(chunk, t)
    if t % chunk:
        chunk = math.gcd(t, chunk)
    nc = t // chunk
    f32 = torch.float32

    qc = q.reshape(b, nc, chunk, h, n)
    kc = k.reshape(b, nc, chunk, h, n)
    vc = v.reshape(b, nc, chunk, h, p)
    cum = torch.cumsum(log_f.reshape(b, nc, chunk, h).to(f32), dim=2)
    total = cum[:, :, -1]                              # (b, nc, h)
    S = torch.zeros((b, h, n, p), dtype=f32, device=q.device) \
        if s0 is None else s0
    # the mask goes on the exponent: future entries have positive deltas
    # (cum decreases), whose exp overflows
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    outs = []
    for j in range(nc):
        qj, kj, vj = qc[:, j].to(f32), kc[:, j].to(f32), vc[:, j].to(f32)
        cumj, totj = cum[:, j], total[:, j]            # (b,c,h), (b,h)
        # inter-chunk: q decayed from the chunk's start reads the state
        inter = torch.einsum("bchn,bhnp->bchp",
                             qj * torch.exp(cumj)[..., None], S)
        # intra-chunk: masked decayed attention
        scores = torch.einsum("bchn,bshn->bhcs", qj, kj)
        ct = cumj.transpose(1, 2)                      # (b,h,c)
        delta = torch.where(mask, ct[..., :, None] - ct[..., None, :],
                            NEG_INF)
        intra = torch.einsum("bhcs,bshp->bchp", scores * torch.exp(delta),
                             vj)
        # the state decays to the chunk's end and takes the decayed kv
        k_dec = kj * torch.exp(totj[:, None, :] - cumj)[..., None]
        S = torch.exp(totj)[:, :, None, None] * S + torch.einsum(
            "bshn,bshp->bhnp", k_dec, vj)
        outs.append(inter + intra)
    out = torch.stack(outs, dim=1).reshape(b, t, h, p)
    return out.to(v.dtype), S


def gla_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_f: torch.Tensor, state: torch.Tensor):
    """Single-token GLA step. q/k: (B,H,N); v: (B,H,P); log_f: (B,H)."""
    f32 = torch.float32
    f = torch.exp(log_f.to(f32))[:, :, None, None]
    state = f * state + torch.einsum("bhn,bhp->bhnp", k.to(f32), v.to(f32))
    out = torch.einsum("bhn,bhnp->bhp", q.to(f32), state)
    return out.to(v.dtype), state


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (Mamba/xLSTM stem)
# ---------------------------------------------------------------------------

def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None,
                  state: Optional[torch.Tensor] = None):
    """x: (B,T,C); w: (W,C) depthwise; state: (B,W-1,C) carried for decode.

    The taps are multiplied and summed in order in ``x``'s type, as the
    reference's are.  Returns (y (B,T,C), new_state (B,W-1,C)).
    """
    width, t = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                  # (B, T+W-1, C)
    y = sum(xp[:, i:i + t, :] * w[i][None, None, :] for i in range(width))
    if b is not None:
        y = y + b[None, None, :]
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return y, new_state


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------

class SSMState(NamedTuple):
    """A Mamba2 or mLSTM block's decode state (stacked: a leading layer
    axis on each)."""
    conv: torch.Tensor     # (B, W-1, conv_channels), the activations' type
    ssd: torch.Tensor      # (B, H, N, P) float32


def mamba2_dims(config: ModelConfig):
    d_in = config.ssm_expand * config.d_model
    n = config.ssm_state
    p = 64                                   # head dim (Mamba-2 default)
    h = d_in // p
    return d_in, n, p, h


def mamba2_specs(config: ModelConfig) -> Dict[str, ParamSpec]:
    d = config.d_model
    d_in, n, p, h = mamba2_dims(config)
    conv_ch = d_in + 2 * n
    return {
        "w_in": ParamSpec((d, 2 * d_in + 2 * n + h), ("embed", "ffn"),
                          scale=d ** -0.5),
        "conv_w": ParamSpec((config.ssm_conv, conv_ch), (None, "conv"),
                            scale=0.5),
        "conv_b": ParamSpec((conv_ch,), ("conv",), "zeros"),
        "a_log": ParamSpec((h,), (None,), "zeros"),
        "dt_bias": ParamSpec((h,), (None,), "zeros"),
        "d_skip": ParamSpec((h,), (None,), "ones"),
        "norm_scale": ParamSpec((d_in,), ("ffn",), "ones"),
        "w_out": ParamSpec((d_in, d), ("ffn", "embed"), scale=d_in ** -0.5),
    }


def _mamba2_core(params, xbc_conv: torch.Tensor, dt_raw: torch.Tensor,
                 dims, *, chunk: int, s0):
    d_in, n, p, h = dims
    bsz, t = xbc_conv.shape[:2]
    xv, bmat, cmat = torch.split(xbc_conv, [d_in, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())   # (B,T,H)
    log_f = -dt * torch.exp(params["a_log"].float())
    xh = xv.reshape(bsz, t, h, p)
    v = xh * dt[..., None].to(xv.dtype)
    q = cmat[:, :, None, :].expand(bsz, t, h, n)
    k = bmat[:, :, None, :].expand(bsz, t, h, n)
    out, S = gla_chunked(q, k, v, log_f, chunk=chunk, s0=s0)
    out = out + xh * params["d_skip"].to(xv.dtype)[None, None, :, None]
    return out.reshape(bsz, t, d_in), S


def _rms_rows(out: torch.Tensor) -> torch.Tensor:
    """``out`` times the float32 reciprocal rms of its last dim, rounded
    to ``out``'s type first (the reference's gated norms)."""
    r = torch.rsqrt(out.float().square().mean(-1, keepdim=True) + 1e-5)
    return out * r.to(out.dtype)


def mamba2_apply(params, x: torch.Tensor, config: ModelConfig, *,
                 chunk: int = 128, state: Optional[SSMState] = None,
                 return_state: bool = False):
    """Training / prefill path (decode: one token, ``chunk=1``). x: (B,T,d)."""
    dims = mamba2_dims(config)
    d_in, n, _, h = dims
    proj = x @ params["w_in"].to(x.dtype)
    z, xbc, dt_raw = torch.split(proj, [d_in, d_in + 2 * n, h], dim=-1)
    xbc_c, conv_state = conv1d_causal(
        xbc, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype),
        state.conv if state is not None else None)
    xbc_c = cm.activate(xbc_c, "silu")
    out, S = _mamba2_core(params, xbc_c, dt_raw, dims, chunk=chunk,
                          s0=state.ssd if state is not None else None)
    # gated RMS norm then down-projection
    out = _rms_rows(out)
    out = out * params["norm_scale"].to(out.dtype) * cm.activate(z, "silu")
    y = out @ params["w_out"].to(x.dtype)
    if return_state:
        return y, SSMState(conv=conv_state, ssd=S)
    return y


def mamba2_decode(params, x: torch.Tensor, config: ModelConfig,
                  state: SSMState):
    """x: (B,1,d); O(1) state update."""
    return mamba2_apply(params, x, config, chunk=1, state=state,
                        return_state=True)


def mamba2_init_state(batch: int, config: ModelConfig, dtype,
                      device=None) -> SSMState:
    d_in, n, p, h = mamba2_dims(config)
    return SSMState(
        conv=torch.zeros((batch, config.ssm_conv - 1, d_in + 2 * n),
                         dtype=dtype, device=device),
        ssd=torch.zeros((batch, h, n, p), dtype=torch.float32,
                        device=device))


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------

def mlstm_dims(config: ModelConfig):
    d_in = 2 * config.d_model            # proj factor 2 (xLSTM paper)
    h = config.n_heads
    p = d_in // h
    return d_in, h, p


def mlstm_specs(config: ModelConfig) -> Dict[str, ParamSpec]:
    d = config.d_model
    d_in, h, p = mlstm_dims(config)
    return {
        "w_up": ParamSpec((d, 2 * d_in), ("embed", "ffn"),
                          scale=d ** -0.5),   # x_in, z
        "conv_w": ParamSpec((config.ssm_conv, d_in), (None, "conv"),
                            scale=0.5),
        "conv_b": ParamSpec((d_in,), ("conv",), "zeros"),
        "w_q": ParamSpec((d_in, d_in), ("ffn", None), scale=d_in ** -0.5),
        "w_k": ParamSpec((d_in, d_in), ("ffn", None), scale=d_in ** -0.5),
        "w_v": ParamSpec((d_in, d_in), ("ffn", None), scale=d_in ** -0.5),
        "w_if": ParamSpec((d_in, 2 * h), ("ffn", None), scale=0.02),
        "b_if": ParamSpec((2 * h,), (None,), "zeros"),
        "norm_scale": ParamSpec((d_in,), ("ffn",), "ones"),
        "w_down": ParamSpec((d_in, d), ("ffn", "embed"), scale=d_in ** -0.5),
    }


def mlstm_apply(params, x: torch.Tensor, config: ModelConfig, *,
                chunk: int = 128, state: Optional[SSMState] = None,
                return_state: bool = False):
    d_in, h, p = mlstm_dims(config)
    bsz, t = x.shape[:2]
    dt = x.dtype
    x_in, z = torch.chunk(x @ params["w_up"].to(dt), 2, dim=-1)
    x_c, conv_state = conv1d_causal(
        x_in, params["conv_w"].to(dt), params["conv_b"].to(dt),
        state.conv if state is not None else None)
    x_c = cm.activate(x_c, "silu")
    q = (x_c @ params["w_q"].to(dt)).reshape(bsz, t, h, p) \
        * _scalar(p ** -0.5, x)
    k = (x_c @ params["w_k"].to(dt)).reshape(bsz, t, h, p)
    v = (x_in @ params["w_v"].to(dt)).reshape(bsz, t, h, p)
    gates = x_c @ params["w_if"].to(dt) + params["b_if"].to(dt)
    i_raw, f_raw = torch.chunk(gates.float(), 2, dim=-1)        # (B,T,H)
    # log-sigmoid forget gate; sigmoid input gate folded into k
    log_f = F.logsigmoid(f_raw)
    k = k * torch.sigmoid(i_raw)[..., None].to(k.dtype)
    # normaliser: a ones column on v, divided out at the end (mLSTM n_t)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    out_aug, S = gla_chunked(q, k, v_aug, log_f, chunk=chunk,
                             s0=state.ssd if state is not None else None)
    num, den = out_aug[..., :p], out_aug[..., p:]
    out = num / torch.clamp(den.abs(), min=1.0)
    # per-head RMS norm, gate by silu(z), down-project
    out = _rms_rows(out).reshape(bsz, t, d_in) * params["norm_scale"].to(dt)
    out = out * cm.activate(z, "silu")
    y = out @ params["w_down"].to(dt)
    if return_state:
        return y, SSMState(conv=conv_state, ssd=S)
    return y


def mlstm_decode(params, x: torch.Tensor, config: ModelConfig,
                 state: SSMState):
    return mlstm_apply(params, x, config, chunk=1, state=state,
                       return_state=True)


def mlstm_init_state(batch: int, config: ModelConfig, dtype,
                     device=None) -> SSMState:
    d_in, h, p = mlstm_dims(config)
    return SSMState(
        conv=torch.zeros((batch, config.ssm_conv - 1, d_in), dtype=dtype,
                         device=device),
        ssd=torch.zeros((batch, h, p, p + 1), dtype=torch.float32,
                        device=device))


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): true recurrence, a loop over time
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    """An sLSTM block's decode state, float32 (B, H, hd) each."""
    h: torch.Tensor
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor   # stabiliser


def slstm_dims(config: ModelConfig):
    h = config.n_heads
    hd = config.d_model // h
    return h, hd


def slstm_specs(config: ModelConfig) -> Dict[str, ParamSpec]:
    d = config.d_model
    h, hd = slstm_dims(config)
    return {
        "w_gates": ParamSpec((d, 4, h, hd), ("embed", None, "heads", None),
                             scale=0.02),
        "r_gates": ParamSpec((4, h, hd, hd), (None, "heads", None, None),
                             scale=0.02),
        "b_gates": ParamSpec((4, h, hd), (None, "heads", None), "zeros"),
        "norm_scale": ParamSpec((d,), ("embed",), "ones"),
        "w_down": ParamSpec((d, d), ("embed", "embed"), scale=d ** -0.5),
    }


def _slstm_cell(r_gates: torch.Tensor, b_gates: torch.Tensor,
                wx_t: torch.Tensor, state: SLSTMState) -> SLSTMState:
    """One step. wx_t: (B,4,H,hd) input projections; ``r_gates`` and
    ``b_gates`` float32."""
    rh = torch.einsum("bhd,ghde->bghe", state.h, r_gates)
    g = wx_t.float() + rh + b_gates[None]
    z_t = torch.tanh(g[:, 0])
    i_t = g[:, 1]
    f_t = g[:, 2]
    o_t = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(f_t + state.m, i_t)          # stabiliser
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + state.m - m_new)
    c_new = f_p * state.c + i_p * z_t
    n_new = f_p * state.n + i_p
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return SLSTMState(h=h_new, c=c_new, n=n_new, m=m_new)


def slstm_apply(params, x: torch.Tensor, config: ModelConfig, *,
                state: Optional[SLSTMState] = None,
                return_state: bool = False):
    bsz, t, d = x.shape
    if state is None:
        state = slstm_init_state(bsz, config, x.device)
    wx = torch.einsum("btd,dghe->btghe", x, params["w_gates"].to(x.dtype))
    r_gates, b_gates = params["r_gates"].float(), params["b_gates"].float()
    hs = []
    for i in range(t):
        state = _slstm_cell(r_gates, b_gates, wx[:, i], state)
        hs.append(state.h)
    out = torch.stack(hs, dim=1).reshape(bsz, t, d).to(x.dtype)
    out = out * params["norm_scale"].to(x.dtype)
    y = out @ params["w_down"].to(x.dtype)
    if return_state:
        return y, state
    return y


def slstm_decode(params, x: torch.Tensor, config: ModelConfig,
                 state: SLSTMState):
    return slstm_apply(params, x, config, state=state, return_state=True)


def slstm_init_state(batch: int, config: ModelConfig,
                     device=None) -> SLSTMState:
    h, hd = slstm_dims(config)

    def zeros():
        return torch.zeros((batch, h, hd), dtype=torch.float32,
                           device=device)

    return SLSTMState(h=zeros(), c=zeros(), n=zeros(),
                      m=torch.full((batch, h, hd), NEG_INF,
                                   dtype=torch.float32, device=device))
