"""The port's fused RMSNorm against the JAX package's.

Inputs are made with numpy from a seed, in float32, and rounded to
bfloat16 on each side where a case asks for it.  On the CPU the port's
``fused_rmsnorm`` runs its kernel's plain version; that is held against
the reference's Pallas kernel in interpret mode, at the tolerances of
``tests/test_kernels.py``: float32 1e-6, bfloat16 1e-2.  The CUDA kernel
itself is checked against the plain version in ``test_torch_cuda.py``,
whose tests skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_rmsnorm.ops import \
    fused_rmsnorm as ref_rmsnorm  # noqa: E402
from repro.kernels.fused_rmsnorm.ref import \
    rmsnorm_ref as ref_rmsnorm_ref  # noqa: E402

from repro_torch.interop import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import (fused_rmsnorm,  # noqa: E402
                                               rmsnorm_ref, rmsnorm_rows)

TOL = {"float32": 1e-6, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

RMS_CASES = [
    # (shape, dtype): the five cases of test_kernels.py, and a batch
    ((64, 512), "float32"),
    ((33, 768), "bfloat16"),     # the reference pads these rows
    ((7, 128), "float32"),
    ((256, 2048), "bfloat16"),
    ((1, 8192), "float32"),      # wide row
    ((2, 5, 256), "float32"),    # leading dims flattened to rows
]


def _inputs(shape, x_dtype, w_dtype, seed=0):
    """(x, w) as jax and torch (CPU) arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal(shape[-1:], dtype=np.float32)
    jx = (jnp.asarray(x, JNP[x_dtype]), jnp.asarray(w, JNP[w_dtype]))
    tt = (tensor_from_numpy(x, x_dtype, device="cpu"),
          tensor_from_numpy(w, w_dtype, device="cpu"))
    return jx, tt


def _close(port, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,dtype", RMS_CASES)
def test_fused_rmsnorm_matches_the_reference(shape, dtype):
    (jx, jw), (x, w) = _inputs(shape, dtype, dtype)
    launches = rmsnorm_rows.launches
    got = fused_rmsnorm(x, w)
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, ref_rmsnorm(jx, jw), dtype)
    # on the CPU the plain version runs, and is not counted as a launch
    assert rmsnorm_rows.launches == launches


@pytest.mark.parametrize("eps", [1e-5, 1e-2])
def test_bf16_x_with_f32_w(eps):
    (jx, jw), (x, w) = _inputs((48, 384), "bfloat16", "float32", seed=1)
    got = fused_rmsnorm(x, w, eps=eps)
    assert got.dtype == torch.bfloat16
    _close(got, ref_rmsnorm(jx, jw, eps=eps), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_backend_matches_xla(dtype):
    (jx, jw), (x, w) = _inputs((3, 17, 96), dtype, dtype, seed=2)
    _close(fused_rmsnorm(x, w, backend="torch"),
           ref_rmsnorm(jx, jw, backend="xla"), dtype)


@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32"), ("float32", "bfloat16")])
def test_rmsnorm_ref_matches_the_reference(x_dtype, w_dtype):
    (jx, jw), (x, w) = _inputs((40, 200), x_dtype, w_dtype, seed=3)
    _close(rmsnorm_ref(x, w, 1e-5), ref_rmsnorm_ref(jx, jw, 1e-5), x_dtype)


def test_output_rows_have_unit_rms():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 5, 256), dtype=np.float32))
    out = fused_rmsnorm(x, torch.ones(256))
    rms = out.pow(2).mean(-1).sqrt()
    torch.testing.assert_close(rms, torch.ones_like(rms), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("call,error", [
    (lambda: rmsnorm_rows(torch.zeros(4, 8, dtype=torch.float64),
                          torch.ones(8)), TypeError),
    (lambda: rmsnorm_rows(torch.zeros(4, 8), torch.ones(8, dtype=torch.int32)),
     TypeError),
    (lambda: rmsnorm_rows(torch.zeros(4, 8), torch.ones(7)), ValueError),
    (lambda: rmsnorm_rows(torch.zeros(2, 4, 8), torch.ones(8)), ValueError),
    (lambda: rmsnorm_rows(torch.zeros(8, 4).t(), torch.ones(8)), ValueError),
    (lambda: rmsnorm_rows(torch.zeros(4, 8), torch.ones(8).to("meta")),
     ValueError),
    (lambda: fused_rmsnorm(torch.zeros(4, 8), torch.ones(8),
                           backend="pallas"), ValueError),
], ids=["float64", "int_w", "w_shape", "x_3d", "strided", "mixed_device",
        "backend"])
def test_rmsnorm_rejects_what_the_kernel_does_not_take(call, error):
    with pytest.raises(error):
        call()


# ---------------------------------------------------------------------------
# float16: the kernel takes it, computes in float32 and returns float16, as
# the reference does (ROADMAP Queue C)
# ---------------------------------------------------------------------------

# chip_smoke.py's RMS_TOL[torch.float16]: (atol, rtol, rms_rel)
F16_TOL = (1e-3, 2e-3, 1e-4)


def _close_f16(port, ref):
    """Every element within atol + rtol |ref| and rms(port - ref) within
    rms_rel rms(ref), in float32: both sides compute in float32 and round
    once to float16, so they differ by at most one unit in the last place
    (2**-10 |ref| < rtol |ref|) where the two float32 results straddle a
    rounding boundary."""
    atol, rtol, rms_rel = F16_TOL
    got = port.float().numpy()
    want = np.asarray(ref, np.float32)
    diff = np.abs(got - want)
    assert (diff <= atol + rtol * np.abs(want)).all(), diff.max()
    assert np.sqrt(np.mean(diff ** 2)) <= rms_rel * np.sqrt(
        np.mean(want ** 2))


def test_float16_queue_c_input_matches_the_reference():
    """x = [[1, ..., 8]] in float16, w = ones(8) in float32: the reference
    returns float16 [0.198 0.396 ... 1.584]; so does the default entry
    point, which raised TypeError before float16 was taken."""
    x = np.arange(1, 9, dtype=np.float16)[None]
    w = np.ones(8, np.float32)
    want = ref_rmsnorm(jnp.asarray(x), jnp.asarray(w))
    got = fused_rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    _close_f16(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w_dtype", ["float16", "float32"])
@pytest.mark.parametrize("shape", [(64, 512), (33, 768), (2, 5, 256),
                                   (1, 8192)])
def test_float16_matches_the_reference(shape, w_dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape, dtype=np.float32).astype(np.float16)
    w = rng.standard_normal(shape[-1:], dtype=np.float32).astype(w_dtype)
    launches = rmsnorm_rows.launches
    got = fused_rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float16 and got.shape == shape
    _close_f16(got, ref_rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    assert rmsnorm_rows.launches == launches
