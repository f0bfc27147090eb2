"""GQA attention with RoPE, chunked (flash-style) softmax, and KV cache.

The port's counterpart of ``repro.models.attention``, in plain torch
(``torch.einsum``), with the reference's numerics:

  * ``attend_full``    — materialised scores; used for short sequences.
  * ``attend_chunked`` — streaming softmax over KV blocks (a loop over the
    blocks), never materialises the (T, T) score matrix.  The same math as
    FlashAttention, at the framework level: float32 logits, a running max,
    sum and accumulator, P rounded to the input's type before P·V.  No
    code picks the hand-written kernel (``repro_torch.kernels.
    flash_attention``) here, as none does in the reference;
    ``chip_smoke.py`` holds that kernel against this function at the
    LM path's shapes.
  * decode — new positions against a cache (:func:`attention_block` with
    a :class:`KVCache`).

On a mesh (``place`` given, ``repro_torch.models.common.Placement``) a
rank computes its own query heads where ``heads`` is in place, and its
own KV heads where ``kv_heads`` divide the axis; where they are
replicated, each local query head reads its global KV head
(``global_head // (n_heads // n_kv_heads)``, :func:`_kv_for_heads`).  The
caller ends ``wo``'s product with the all-reduce.  A KV cache whose
sequence dim is sharded (``shard_cache_seq``) is decoded by
:func:`_decode_seq_sharded`: every head over the rank's positions, the
partial softmaxes combined across the group (row max, sum of
exponentials, weighted values).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig, ParamSpec

NEG_INF = -1e30


def attention_specs(config: ModelConfig, d_in: Optional[int] = None):
    d = d_in or config.d_model
    hd = config.hd
    specs = {
        "wq": ParamSpec((d, config.n_heads, hd), ("embed", "heads", None),
                        scale=d ** -0.5),
        "wk": ParamSpec((d, config.n_kv_heads, hd), ("embed", "kv_heads", None),
                        scale=d ** -0.5),
        "wv": ParamSpec((d, config.n_kv_heads, hd), ("embed", "kv_heads", None),
                        scale=d ** -0.5),
        "wo": ParamSpec((config.n_heads, hd, d), ("heads", None, "embed"),
                        scale=(config.n_heads * hd) ** -0.5),
    }
    if config.use_qkv_bias:
        specs["bq"] = ParamSpec((config.n_heads, hd), ("heads", None), "zeros")
        specs["bk"] = ParamSpec((config.n_kv_heads, hd), ("kv_heads", None), "zeros")
        specs["bv"] = ParamSpec((config.n_kv_heads, hd), ("kv_heads", None), "zeros")
    return specs


def _project_qkv(params, x: torch.Tensor, config: ModelConfig):
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(x.dtype))
    k = torch.einsum("btd,dhk->bthk", x, params["wk"].to(x.dtype))
    v = torch.einsum("btd,dhk->bthk", x, params["wv"].to(x.dtype))
    if config.use_qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,T,H,hd) -> (B,T,Hkv,G,hd): GQA groups without repeating K/V."""
    b, t, h, hd = q.shape
    return q.reshape(b, t, n_kv, h // n_kv, hd)


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q: (B,Tq,H,hd); k/v: (B,Tk,Hkv,hd), Hkv | H. Returns (B,Tq,H,hd).

    Grouped einsums keep K/V at Hkv heads — no ``repeat``.
    """
    b, tq, h, hd = q.shape
    n_kv = k.shape[2]
    scale = hd ** -0.5
    qg = _group_q(q, n_kv)
    logits = torch.einsum("bqkgh,btkh->bkgqt", qg, k).float() * scale
    if causal:
        tk = k.shape[1]
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(tk, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqt,btkh->bqkgh", w, v)
    return out.reshape(b, tq, h, hd)


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_chunk: int, kv_chunk: int) -> torch.Tensor:
    """Streaming-softmax attention; O(q_chunk * kv_chunk) score memory.

    q: (B,T,H,hd); k/v: (B,T,Hkv,hd). Requires T % chunk == 0 (config picks
    divisors).  Every key block is visited, causal or not, as in the
    reference's scan; masked logits are ``-1e30``.
    """
    b, tq, h, hd = q.shape
    tk, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    nq, nk = tq // q_chunk, tk // kv_chunk
    scale = hd ** -0.5
    qb = q.reshape(b, nq, q_chunk, n_kv, g, hd)
    kb = k.reshape(b, nk, kv_chunk, n_kv, hd)
    vb = v.reshape(b, nk, kv_chunk, n_kv, hd)
    dev = q.device
    qpos = (torch.arange(nq, device=dev)[:, None] * q_chunk
            + torch.arange(q_chunk, device=dev)[None, :])      # (nq, qc)

    m = torch.full((b, nq, n_kv, g, q_chunk, 1), NEG_INF,
                   dtype=torch.float32, device=dev)
    l = torch.zeros((b, nq, n_kv, g, q_chunk, 1), dtype=torch.float32,
                    device=dev)
    acc = torch.zeros((b, nq, n_kv, g, q_chunk, hd), dtype=torch.float32,
                      device=dev)
    for j in range(nk):
        kj, vj = kb[:, j], vb[:, j]            # (b, kvc, kv, hd)
        s = torch.einsum("bnqkgh,btkh->bnkgqt", qb, kj).float() * scale
        if causal:
            kpos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = kpos[None, None, :] <= qpos[:, :, None]     # (nq,qc,kvc)
            s = torch.where(mask[None, :, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bnkgqt,btkh->bnkgqh", p.to(q.dtype), vj).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)       # (b,nq,kv,g,qc,hd)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, tq, h, hd)
    return out.to(q.dtype)


class KVCache(NamedTuple):
    """One attention layer's cache, or the layers' stacked (a leading
    layer axis on ``k`` and ``v``).  ``length`` — the tokens currently
    valid — is a Python int, one for every layer of a stack, so that a
    decode step reads nothing from the device to place its tokens."""
    k: torch.Tensor     # (B, max_len, Hkv, hd)
    v: torch.Tensor
    length: int


def init_kv_cache(batch: int, max_len: int, config: ModelConfig, dtype,
                  device=None) -> KVCache:
    shape = (batch, max_len, config.n_kv_heads, config.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=0,
    )


class _Heads(NamedTuple):
    """The heads a rank computes: query heads ``[h0, h0 + n)`` and KV
    heads ``[kv0, kv0 + n_kv)`` of the model's ``rep`` queries a KV
    head."""
    h0: int
    n: int
    kv0: int
    n_kv: int
    rep: int


def _heads(params, config: ModelConfig, place, tp) -> _Heads:
    n, n_kv = params["wq"].shape[1], params["wk"].shape[1]
    rank = place.index(tp) if place is not None else 0
    return _Heads(h0=rank * n if n != config.n_heads else 0, n=n,
                  kv0=rank * n_kv if n_kv != config.n_kv_heads else 0,
                  n_kv=n_kv, rep=config.n_heads // config.n_kv_heads)


def _kv_for_heads(k: torch.Tensor, heads: _Heads,
                  repeat: bool = False) -> torch.Tensor:
    """``k`` (B, T, heads.n_kv, hd) as the KV heads the rank's query heads
    read: itself where they group evenly (every local KV head serves
    ``rep`` consecutive local query heads), else one KV head a query
    head (also with ``repeat``: ``repeat_kv_math``)."""
    first = heads.h0 // heads.rep - heads.kv0
    if not repeat and heads.h0 % heads.rep == 0 \
            and heads.n % heads.rep == 0:
        count = heads.n // heads.rep
        return k if (first, count) == (0, k.shape[2]) \
            else k[:, :, first:first + count]
    idx = ((heads.h0 + torch.arange(heads.n, device=k.device)) // heads.rep
           - heads.kv0)
    return k.index_select(2, idx)


def _decode_seq_sharded(q, k, v, cache: KVCache, start: int, pos, config,
                        place, tp, seq_axes, heads: _Heads):
    """Decode against a cache whose positions are sharded over
    ``seq_axes``: the step's K/V go to the rank that holds their
    position; every query head attends over the rank's positions, and
    the partial softmaxes are combined over the group."""
    from repro_torch.runtime import mesh as rt
    mesh = place.mesh
    if tp:
        q = rt.all_gather(q, mesh, tp, 2)
    if heads.n_kv != config.n_kv_heads:
        k = rt.all_gather(k, mesh, tp, 2)
        v = rt.all_gather(v, mesh, tp, 2)
    s_loc = cache.k.shape[1]
    s0 = place.index(seq_axes) * s_loc
    for j in range(q.shape[1]):
        p = start + j - s0
        if 0 <= p < s_loc:
            cache.k[:, p] = k[:, j].to(cache.k.dtype)
            cache.v[:, p] = v[:, j].to(cache.v.dtype)
    qg = _group_q(q, config.n_kv_heads)
    logits = torch.einsum("bqkgh,btkh->bkgqt", qg,
                          cache.k.to(q.dtype)).float() * config.hd ** -0.5
    valid = (s0 + torch.arange(s_loc, device=q.device))[None, :] \
        <= pos[:, None]
    m = place.all_reduce(
        torch.where(valid, logits, NEG_INF).amax(-1, keepdim=True),
        seq_axes, "max")
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    l = place.all_reduce(p.sum(-1, keepdim=True), seq_axes)
    acc = place.all_reduce(
        torch.einsum("bkgqt,btkh->bkgqh", p, cache.v.float()), seq_axes)
    out = (acc / l).to(q.dtype)                        # (b, kv, g, q, hd)
    b, t = q.shape[:2]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, t, config.n_heads, config.hd)
    return out[:, :, heads.h0:heads.h0 + heads.n]


def attention_block(
    params, x: torch.Tensor, config: ModelConfig, *,
    positions: Optional[torch.Tensor] = None, causal: bool = True,
    cache: Optional[KVCache] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    place=None, specs=None, act: tuple = (), tp: tuple = (),
    seq_axes: tuple = (),
):
    """Full attention sub-block: project, rope, attend, out-project.

    Modes:
      * train/prefill (cache None): full-sequence causal attention; returns
        (out, (k, v)) so prefill can build the cache.  Sequences of at
        least ``flash_block_threshold`` tokens that both chunks divide
        take :func:`attend_chunked`, the others :func:`attend_full`.
      * decode (cache given): append ``t`` positions, attend over the
        cache; returns (out, new_cache).  The step **consumes the cache it
        is given**: it writes its K/V into ``cache.k``/``cache.v`` in place
        (the reference's ``dynamic_update_slice`` makes a new array), and
        the returned cache holds the same tensors with ``length + t``.
        Positions past the cache's capacity raise ``ValueError`` (the
        reference clamps the write to the last positions).
      * cross-attention (``cross_kv`` given): the encoder's K/V,
        precomputed; no rotation, no mask; returns (out, None).

    On a mesh, ``place`` with the block's ParamSpecs ``specs``, its
    activations' axes ``act`` and its tensor-parallel axes ``tp``: the
    rank's heads (the output is ``wo``'s partial product), and
    ``seq_axes``, the axes a decode cache's positions are sharded over.
    """
    b, t, _ = x.shape
    rot = int(config.hd * config.rotary_pct)
    if place is not None:
        params = place.weights(params, specs, act, tp,
                               inplace=("heads", "kv_heads"))
    heads = _heads(params, config, place, tp)

    if cross_kv is not None:
        q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(x.dtype))
        k, v = cross_kv
        out = attend_full(q, _kv_for_heads(k, heads),
                          _kv_for_heads(v, heads), causal=False)
        new_state = None
    elif cache is None:
        if positions is None:
            positions = torch.arange(t, device=x.device)
        q, k, v = _project_qkv(params, x, config)
        if rot > 0:
            cos, sin = cm.rope_angles(positions, rot, config.rope_theta)
            q = cm.apply_rope(q, cos, sin)
            k = cm.apply_rope(k, cos, sin)
        # repeat_kv_math: repeat K/V to full heads for the compute (the
        # reference's TP-sharding-friendly form); the cache keeps Hkv
        repeat = config.repeat_kv_math and config.n_kv_heads != config.n_heads
        kf = _kv_for_heads(k, heads, repeat)
        vf = _kv_for_heads(v, heads, repeat)
        if t >= config.flash_block_threshold and t % config.attn_chunk_q == 0 \
                and t % config.attn_chunk_kv == 0:
            out = attend_chunked(
                q, kf, vf, causal=causal,
                q_chunk=config.attn_chunk_q, kv_chunk=config.attn_chunk_kv,
            )
        else:
            out = attend_full(q, kf, vf, causal=causal)
        new_state = (k, v)
    else:
        # decode: t new tokens (usually 1) against the cache, in place
        start = cache.length
        capacity = cache.k.shape[1] * (place.n(seq_axes) if seq_axes else 1)
        if start + t > capacity:
            raise ValueError(f"decode past the cache: {start} + {t} > "
                             f"{capacity} positions")
        q, k, v = _project_qkv(params, x, config)
        pos = torch.arange(start, start + t, device=x.device)
        if rot > 0:
            cos, sin = cm.rope_angles(pos, rot, config.rope_theta)
            q = cm.apply_rope(q, cos, sin)
            k = cm.apply_rope(k, cos, sin)
        if seq_axes:
            out = _decode_seq_sharded(q, k, v, cache, start, pos, config,
                                      place, tp, seq_axes, heads)
            y = torch.einsum("bthk,hkd->btd", out, params["wo"].to(x.dtype))
            return y, KVCache(k=cache.k, v=cache.v, length=start + t)
        cache.k[:, start:start + t] = k.to(cache.k.dtype)
        cache.v[:, start:start + t] = v.to(cache.v.dtype)
        k_all = _kv_for_heads(cache.k, heads)
        v_all = _kv_for_heads(cache.v, heads)
        n_kv = k_all.shape[2]
        qg = _group_q(q, n_kv)
        scale = config.hd ** -0.5
        logits = torch.einsum(
            "bqkgh,btkh->bkgqt", qg, k_all.to(q.dtype)).float() * scale
        valid = (torch.arange(k_all.shape[1], device=x.device)[None, :]
                 <= pos[:, None])
        logits = torch.where(valid, logits, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bkgqt,btkh->bqkgh", w, v_all.to(q.dtype))
        out = out.reshape(b, t, heads.n, config.hd)
        new_state = KVCache(k=cache.k, v=cache.v, length=start + t)

    y = torch.einsum("bthk,hkd->btd", out, params["wo"].to(x.dtype))
    return y, new_state
