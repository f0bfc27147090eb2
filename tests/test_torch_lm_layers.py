"""The LM's layers against the JAX package's: ``apply_norm`` (the three
norm types), ``rope_angles``/``apply_rope`` (full and partial rotary),
``attend_full``, ``attend_chunked`` (chunks of 8/16), ``attention_block``
in its three modes with and without ``repeat_kv_math``, and the dense
MLP, gated and ungated.

The same numpy inputs (seeded) go to both packages.  Tolerances
(atol = rtol): float32 1e-4; bfloat16 2e-2, the reference's own
(``tests/test_models.py``).  The reference runs under ``jax.jit``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_cm  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models.common import ModelConfig as RefConfig  # noqa: E402

from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = sorted(TOL)

BASE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16)


def configs(dtype: str, **kw):
    """The same config in both packages, computing in ``dtype``."""
    ref = RefConfig(**BASE, **kw, dtype=JNP[dtype], param_dtype=jnp.float32)
    port = ModelConfig(**BASE, **kw, dtype=TORCH[dtype],
                       param_dtype=torch.float32)
    return ref, port


def arrays(dtype: str, *shapes, seed=0, scale=1.0):
    """Seeded float32 numpy arrays, each as a (jax, torch) pair of
    ``dtype`` (float32 -> bfloat16 rounds to nearest even on both sides)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        out.append((jnp.asarray(a, JNP[dtype]),
                    torch.from_numpy(a).to(TORCH[dtype])))
    return out


def close(ref, port, dtype: str):
    tol = TOL[dtype]
    got = port.float().numpy()
    want = np.asarray(ref, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def params_pair(specs, seed=1):
    """Random float32 parameters for a ParamSpec dict, in both packages."""
    names = sorted(specs)
    pairs = arrays("float32", *[specs[n].shape for n in names], seed=seed,
                   scale=0.3)
    return ({n: p[0] for n, p in zip(names, pairs)},
            {n: p[1] for n, p in zip(names, pairs)})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparametric"])
def test_apply_norm(norm, dtype):
    ref_c, c = configs(dtype, norm_type=norm)
    (x,) = arrays(dtype, (2, 9, 64), scale=3.0)
    rp, pp = params_pair(ref_cm.norm_params(ref_c, 64))
    got = cm.apply_norm(x[1], pp, c)
    assert got.dtype == TORCH[dtype]
    close(jax.jit(lambda x, p: ref_cm.apply_norm(x, p, ref_c))(x[0], rp),
          got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rotary_pct", [1.0, 0.25])
@pytest.mark.parametrize("batched", [False, True], ids=["T", "BT"])
def test_rope(rotary_pct, batched, dtype):
    (x,) = arrays(dtype, (2, 11, 4, 16))
    rot = int(16 * rotary_pct)
    pos = np.arange(11) + 5
    if batched:
        pos = np.stack([pos, pos * 3])
    ref_cs = ref_cm.rope_angles(jnp.asarray(pos), rot, 1e6)
    cs = cm.rope_angles(torch.as_tensor(pos), rot, 1e6)
    for a, b in zip(ref_cs, cs):
        close(a, b, "float32")
    close(jax.jit(ref_cm.apply_rope)(x[0], *ref_cs),
          cm.apply_rope(x[1], *cs), dtype)
    # the unrotated tail passes through unchanged
    assert torch.equal(cm.apply_rope(x[1], *cs)[..., rot:], x[1][..., rot:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 5)])
def test_attend_full(causal, q_offset, dtype):
    q, k, v = arrays(dtype, (2, 7, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16))
    fn = jax.jit(lambda q, k, v: ref_attn.attend_full(
        q, k, v, causal=causal, q_offset=q_offset))
    close(fn(q[0], k[0], v[0]),
          attn.attend_full(q[1], k[1], v[1], causal=causal,
                           q_offset=q_offset), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunks", [(8, 16), (16, 8), (32, 32)])
def test_attend_chunked(chunks, causal, dtype):
    q_chunk, kv_chunk = chunks
    q, k, v = arrays(dtype, (2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16))
    fn = jax.jit(lambda q, k, v: ref_attn.attend_chunked(
        q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk))
    got = attn.attend_chunked(q[1], k[1], v[1], causal=causal,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    assert got.dtype == TORCH[dtype]
    close(fn(q[0], k[0], v[0]), got, dtype)
    # the same function as the full softmax, at float32 (the chunks only
    # reorder the sums)
    if dtype == "float32":
        close(attn.attend_full(q[1], k[1], v[1], causal=causal), got,
              "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("repeat_kv_math", [False, True])
@pytest.mark.parametrize("qkv_bias,rotary_pct", [(False, 1.0),
                                                 (True, 0.25)])
def test_attention_block_modes(repeat_kv_math, qkv_bias, rotary_pct, dtype):
    """train/prefill (full and chunked) and decode against a prefill's
    cache, with and without ``repeat_kv_math`` (set through ``replace``:
    no config sets it)."""
    kw = dict(use_qkv_bias=qkv_bias, rotary_pct=rotary_pct,
              flash_block_threshold=16, attn_chunk_q=8, attn_chunk_kv=16)
    ref_c, c = configs(dtype, **kw)
    ref_c = ref_c.replace(repeat_kv_math=repeat_kv_math)
    c = c.replace(repeat_kv_math=repeat_kv_math)
    rp, pp = params_pair(ref_attn.attention_specs(ref_c))
    rp = {n: jnp.asarray(p, JNP[dtype]) for n, p in rp.items()}
    pp = {n: p.to(TORCH[dtype]) for n, p in pp.items()}
    for t in (12, 16):      # below the threshold: full; at it: chunked
        (x,) = arrays(dtype, (2, t, 64), seed=t)
        fn = jax.jit(lambda p, x: ref_attn.attention_block(p, x, ref_c))
        ref_y, (ref_k, ref_v) = fn(rp, x[0])
        y, (k, v) = attn.attention_block(pp, x[1], c)
        close(ref_y, y, dtype)
        close(ref_k, k, dtype)
        close(ref_v, v, dtype)
    # decode 2 + 1 positions against a cache of 20 holding the prefill's
    max_len = 20
    ref_cache = ref_attn.KVCache(
        k=jnp.pad(ref_k, ((0, 0), (0, max_len - t), (0, 0), (0, 0))),
        v=jnp.pad(ref_v, ((0, 0), (0, max_len - t), (0, 0), (0, 0))),
        length=jnp.int32(t))
    cache = attn.KVCache(
        k=torch.nn.functional.pad(k, (0, 0, 0, 0, 0, max_len - t)),
        v=torch.nn.functional.pad(v, (0, 0, 0, 0, 0, max_len - t)),
        length=t)
    step = jax.jit(lambda p, x, c: ref_attn.attention_block(p, x, ref_c,
                                                            cache=c))
    for n_new, seed in ((2, 30), (1, 31)):
        (x,) = arrays(dtype, (2, n_new, 64), seed=seed)
        ref_y, ref_cache = step(rp, x[0], ref_cache)
        y, cache = attn.attention_block(pp, x[1], c, cache=cache)
        close(ref_y, y, dtype)
        close(ref_cache.k, cache.k, dtype)
        close(ref_cache.v, cache.v, dtype)
        assert cache.length == int(ref_cache.length)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"),
                                       (True, "gelu"), (False, "silu")])
def test_dense_mlp(gated, act, dtype):
    ref_c, c = configs(dtype, mlp_gated=gated, act=act)
    rp, pp = params_pair(ref_mlp.mlp_specs(ref_c))
    (x,) = arrays(dtype, (2, 9, 64), scale=2.0)
    assert sorted(pp) == sorted(mlp.mlp_specs(c))
    close(jax.jit(lambda p, x: ref_mlp.mlp_apply(p, x, ref_c))(rp, x[0]),
          mlp.mlp_apply(pp, x[1], c), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activations_round_where_the_reference_does(act, dtype):
    """Written op by op, each step rounds to ``dtype`` as the reference's
    does: equal bits in both types."""
    (x,) = arrays(dtype, (4096,), scale=3.0)
    ref = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}[act]
    got = cm.activate(x[1], act)
    want = np.asarray(jax.jit(ref)(x[0]), np.float32)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        cm.activate(x[1], "relu")
