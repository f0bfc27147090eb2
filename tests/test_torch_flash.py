"""The port's flash attention against the JAX package's.

Inputs are made with numpy from a seed, in float32, and rounded to
bfloat16 on each side where a case asks for it (both round to nearest
even, so both packages see the same bits).  On the CPU the port's
``flash_attention`` runs its kernel's plain version; that is held against
the reference's Pallas kernel in interpret mode, at the tolerances of
``tests/test_kernels.py``: float32 1e-5, bfloat16 2e-2.  The CUDA kernel
itself is checked against the plain version in ``test_torch_cuda.py``,
whose tests skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import \
    flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    mha_ref as ref_mha  # noqa: E402

from repro_torch.interop import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_mha, mha_ref)
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

FLASH_CASES = [
    # (b, h, hkv, t, s, hd, causal, dtype, blocks): the six cases of
    # test_kernels.py, then T < S, and the head dims of zamba2 and xlstm
    (2, 4, 4, 128, 128, 64, True, "float32", (64, 64)),
    (2, 4, 2, 256, 256, 64, True, "float32", (64, 128)),
    (1, 8, 1, 192, 192, 32, True, "float32", (64, 64)),       # MQA
    (1, 8, 2, 130, 130, 32, True, "bfloat16", (64, 64)),      # ragged
    (2, 4, 4, 128, 128, 64, False, "float32", (64, 64)),
    (1, 2, 2, 512, 512, 128, True, "bfloat16", (128, 128)),
    (1, 4, 2, 64, 128, 32, True, "float32", (64, 64)),        # T < S
    (1, 2, 2, 64, 64, 80, True, "float32", (64, 64)),         # zamba2
    (1, 2, 2, 64, 64, 192, True, "float32", (64, 64)),        # xlstm
]


def _inputs(b, h, hkv, t, s, hd, dtype, seed=0):
    """(q, k, v) as numpy float32, jax and torch (CPU) arrays."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for shape in
              ((b, h, t, hd), (b, hkv, s, hd), (b, hkv, s, hd))]
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    tt = [tensor_from_numpy(a, dtype, device="cpu") for a in arrays]
    return jx, tt


def _close(port, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,hkv,t,s,hd,causal,dtype,blocks", FLASH_CASES)
def test_flash_attention_matches_the_reference(b, h, hkv, t, s, hd, causal,
                                               dtype, blocks):
    (jq, jk, jv), (q, k, v) = _inputs(b, h, hkv, t, s, hd, dtype)
    want = ref_flash(jq, jk, jv, causal=causal, block_q=blocks[0],
                     block_k=blocks[1])
    launches = flash_mha.launches
    got = flash_attention(q, k, v, causal=causal, block_q=blocks[0],
                          block_k=blocks[1])
    assert got.dtype == q.dtype and got.shape == (b, h, t, hd)
    _close(got, want, dtype)
    # on the CPU the plain version runs, and is not counted as a launch
    assert flash_mha.launches == launches


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,s", [(96, 96), (40, 72), (72, 40)])
def test_mha_ref_matches_the_reference(t, s, dtype, causal):
    (jq, jk, jv), (q, k, v) = _inputs(2, 6, 3, t, s, 16, dtype, seed=1)
    _close(mha_ref(q, k, v, causal=causal),
           ref_mha(jq, jk, jv, causal=causal), dtype)
    _close(flash_attention(q, k, v, causal=causal, backend="torch"),
           ref_flash(jq, jk, jv, causal=causal, backend="xla"), dtype)


def test_non_causal_ragged_keys_raise_in_both_packages():
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 2, 64, 130, 32, "float32")
    with pytest.raises(ValueError, match="S % block_k"):
        ref_flash(jq, jk, jv, causal=False, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="S % block_k"):
        flash_attention(q, k, v, causal=False, block_q=64, block_k=64)
    # the torch backend, like the reference's xla, takes any S
    _close(flash_attention(q, k, v, causal=False, backend="torch"),
           ref_mha(jq, jk, jv, causal=False), "float32")


def test_causal_queries_past_ragged_keys_raise_a_deliberate_deviation():
    """The reference pads K/V to a multiple of block_k with zero keys;
    under the causal mask the queries past S attend to them.  At T=200,
    S=130 its output is off mha_ref by > 0.1, so the port raises there."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 1, 200, 130, 32, "float32")
    wrong = np.asarray(ref_flash(jq, jk, jv, causal=True, block_q=64,
                                 block_k=64))
    exact = np.asarray(ref_mha(jq, jk, jv, causal=True))
    assert np.abs(wrong - exact).max() > 0.1
    # the queries before S are right; the ones past it are not
    np.testing.assert_allclose(wrong[:, :, :130], exact[:, :, :130],
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="T > S"):
        flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    # the kernel itself masks keys past S: its plain version is exact
    _close(flash_mha(q, k, v, causal=True), exact, "float32")
    # with S a multiple of block_k the reference pads nothing, and agrees
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 1, 200, 128, 32, "float32")
    _close(flash_attention(q, k, v, causal=True, block_q=64, block_k=64),
           ref_flash(jq, jk, jv, causal=True, block_q=64, block_k=64),
           "float32")


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("call,error", [
    # head dim not a multiple of 8 in [8, 256]
    (lambda: flash_mha(_t((1, 2, 8, 260)), _t((1, 2, 8, 260)),
                       _t((1, 2, 8, 260))), ValueError),
    (lambda: flash_mha(_t((1, 2, 8, 12)), _t((1, 2, 8, 12)),
                       _t((1, 2, 8, 12))), ValueError),
    # H not a multiple of Hkv
    (lambda: flash_mha(_t((1, 3, 8, 16)), _t((1, 2, 8, 16)),
                       _t((1, 2, 8, 16))), ValueError),
    # k and v of different shapes
    (lambda: flash_mha(_t((1, 2, 8, 16)), _t((1, 2, 8, 16)),
                       _t((1, 2, 9, 16))), ValueError),
    # element types the kernel does not take, or mixed
    (lambda: flash_mha(_t((1, 2, 8, 16), torch.float64),
                       _t((1, 2, 8, 16), torch.float64),
                       _t((1, 2, 8, 16), torch.float64)), TypeError),
    (lambda: flash_mha(_t((1, 2, 8, 16)), _t((1, 2, 8, 16), torch.bfloat16),
                       _t((1, 2, 8, 16))), TypeError),
    # not contiguous
    (lambda: flash_mha(_t((1, 8, 2, 16)).transpose(1, 2), _t((1, 2, 8, 16)),
                       _t((1, 2, 8, 16))), ValueError),
    # no kernel for this device
    (lambda: flash_mha(_t((1, 2, 8, 16)).to("meta"),
                       _t((1, 2, 8, 16)).to("meta"),
                       _t((1, 2, 8, 16)).to("meta")), ValueError),
    (lambda: flash_mha(_t((1, 2, 8, 16)), _t((1, 2, 8, 16)).to("meta"),
                       _t((1, 2, 8, 16))), ValueError),
    (lambda: flash_attention(_t((1, 2, 8, 16)), _t((1, 2, 8, 16)),
                             _t((1, 2, 8, 16)), backend="pallas"),
     ValueError),
    (lambda: flash_attention(_t((1, 2, 8, 16)), _t((1, 2, 8, 16)),
                             _t((1, 2, 8, 16)), block_k=0), ValueError),
], ids=["hd260", "hd12", "h_not_multiple", "kv_shapes", "float64",
        "mixed_dtype", "strided", "meta", "mixed_device", "backend",
        "block"])
def test_flash_rejects_what_the_kernel_does_not_take(call, error):
    with pytest.raises(error):
        call()


def test_misaligned_views_are_refused_before_a_launch():
    """The kernel reads 16-byte vectors; a contiguous view at an odd offset
    into a buffer is refused before any launch (the CPU's plain version
    takes it, so the check is called directly here)."""
    buf = _t((2 * 8 * 16 + 1,))
    q = buf[1:].view(1, 2, 8, 16)
    k = _t((1, 2, 8, 16))
    assert q.is_contiguous() and q.data_ptr() % 16
    flash.check_aligned(k, k, k)
    for args in ((q, k, k), (k, q, k), (k, k, q)):
        with pytest.raises(ValueError, match="16-byte"):
            flash.check_aligned(*args)
    torch.testing.assert_close(flash_mha(q, k, k), mha_ref(q, k, k),
                               atol=0, rtol=0)


def test_entry_point_takes_strided_inputs():
    (_, _, _), (q, k, v) = _inputs(1, 4, 2, 32, 32, 16, "float32")
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qs.is_contiguous()
    torch.testing.assert_close(flash_attention(qs, k, v, block_k=32),
                               mha_ref(q, k, v), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_from_numpy_gives_the_reference_bits(dtype):
    rng = np.random.default_rng(3)
    a = np.concatenate([
        rng.standard_normal(4096, dtype=np.float32) * 100,
        # halfway between two bfloat16 values: ties go to even
        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 2 ** -130,
                  3.0e38, -np.inf, np.inf, 0.0, -0.0], np.float32)])
    t = tensor_from_numpy(a, dtype, device="cpu")
    assert t.dtype == getattr(torch, dtype)
    ref = np.asarray(jnp.asarray(a, JNP[dtype]))
    bits = np.int16 if dtype == "bfloat16" else np.int32
    np.testing.assert_array_equal(t.view(getattr(torch, bits.__name__))
                                  .numpy(), ref.view(bits))


def test_tensor_from_numpy_rejects_other_inputs():
    with pytest.raises(TypeError):
        tensor_from_numpy(np.zeros(3, np.float64), device="cpu")
    with pytest.raises(TypeError):
        tensor_from_numpy(torch.zeros(3), device="cpu")
    with pytest.raises(ValueError):
        tensor_from_numpy(np.zeros(3, np.float32), "float16", device="cpu")


# ---------------------------------------------------------------------------
# float16: the kernel takes it, computes in float32 and returns float16, as
# the reference does (ROADMAP Queue C)
# ---------------------------------------------------------------------------

# chip_smoke.py's FLASH_TOL[torch.float16]: (atol, rtol, rms_rel)
F16_TOL = (1e-3, 2e-3, 1e-4)


def _close_f16(port, ref):
    """Every element within atol + rtol |ref| and rms(port - ref) within
    rms_rel rms(ref), in float32: both sides compute in float32 and round
    once to float16 (one unit in the last place is 2**-10 |ref| at most,
    inside rtol |ref|)."""
    atol, rtol, rms_rel = F16_TOL
    got = port.float().numpy()
    want = np.asarray(ref, np.float32)
    diff = np.abs(got - want)
    assert (diff <= atol + rtol * np.abs(want)).all(), diff.max()
    assert np.sqrt(np.mean(diff ** 2)) <= rms_rel * np.sqrt(
        np.mean(want ** 2))


def _f16_inputs(b, h, hkv, t, s, hd, seed=0):
    """(q, k, v) as jax and torch (CPU) float16 arrays with the same bits
    (numpy rounds to float16 once for both)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32).astype(np.float16)
              for shape in ((b, h, t, hd), (b, hkv, s, hd), (b, hkv, s, hd))]
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def test_float16_queue_c_input_matches_the_reference():
    """q = k = v = ones((1, 1, 1, 8)) in float16 with blocks of 1: the
    reference returns ones in float16; so does the default entry point,
    which raised TypeError before float16 was taken."""
    ones = np.ones((1, 1, 1, 8), np.float16)
    want = ref_flash(*[jnp.asarray(ones)] * 3, block_q=1, block_k=1)
    got = flash_attention(*[torch.from_numpy(ones)] * 3, block_q=1,
                          block_k=1)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,h,hkv,t,s,hd,causal,blocks", [
    (1, 8, 2, 130, 130, 32, True, (64, 64)),      # ragged
    (1, 2, 2, 512, 512, 128, True, (128, 128)),
    (2, 4, 4, 128, 128, 64, False, (64, 64)),
    (1, 8, 1, 192, 192, 32, True, (64, 64)),      # MQA
    (1, 2, 2, 64, 64, 80, True, (64, 64)),        # zamba2's head dim
])
def test_float16_matches_the_reference(b, h, hkv, t, s, hd, causal, blocks):
    (jq, jk, jv), (q, k, v) = _f16_inputs(b, h, hkv, t, s, hd, seed=6)
    want = ref_flash(jq, jk, jv, causal=causal, block_q=blocks[0],
                     block_k=blocks[1])
    launches = flash_mha.launches
    got = flash_attention(q, k, v, causal=causal, block_q=blocks[0],
                          block_k=blocks[1])
    assert got.dtype == torch.float16 and got.shape == (b, h, t, hd)
    _close_f16(got, want)
    _close_f16(got, ref_mha(jq, jk, jv, causal=causal))
    assert flash_mha.launches == launches
