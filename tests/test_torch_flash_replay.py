"""The 16-bit flash kernel's arithmetic, replayed on the CPU, against
the JAX package's flash attention.

``flash_mha_tiled_replay`` repeats in torch what the port's bfloat16 and
float16 CUDA kernel computes: 128-query tiles walking their key tiles in order, rows
and columns past T, S and hd read as zeros, scores scaled into base 2 and
masked to -1e30, float32 m, l and accumulator, and P split into two
bfloat16 halves before P V.  It is held against the reference's Pallas
kernel (interpret mode) and its exact ``mha_ref`` at ``chip_smoke.py``'s
bfloat16 ``FLASH_TOL``: |a - b| <= 4e-3 + 1e-2 |b| everywhere and
rms(a - b) <= 5e-4 rms(b).  A control shows why P is split: rounded to
one bfloat16, P misses the rms limit.  Inputs are made with numpy from a
seed and rounded to bfloat16 on each side (both round to nearest even).
The float16 instance is held the same way to ``FLASH_TOL``'s float16
limits (1e-3, 2e-3, 1e-4), with its own control.
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
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402

# chip_smoke.py's FLASH_TOL[torch.bfloat16]: (atol, rtol, rms_rel)
ATOL, RTOL, RMS_REL = 4e-3, 1e-2, 5e-4
# and FLASH_TOL[torch.float16]
F16_TOL = (1e-3, 2e-3, 1e-4)

REPLAY_CASES = [
    # (b, h, hkv, t, s, hd, causal): ragged T and S on both sides of 128,
    # T != S causal (T > S with S a multiple of 128, and T < S), GQA and
    # MQA, every head-dim bucket with hd not a multiple of 16 (8, 24, 80)
    (1, 2, 1, 127, 129, 8, True),
    (1, 4, 2, 129, 127, 24, False),
    (1, 4, 2, 130, 130, 80, True),
    (1, 4, 1, 200, 128, 128, True),
    (1, 2, 2, 100, 260, 128, True),
    (1, 2, 1, 129, 129, 192, True),
    (1, 2, 2, 127, 127, 256, False),
    (2, 4, 4, 128, 256, 64, True),
]


def _inputs(b, h, hkv, t, s, hd, seed=0):
    """(q, k, v) as jax and torch (CPU) bfloat16 arrays."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for shape in
              ((b, h, t, hd), (b, hkv, s, hd), (b, hkv, s, hd))]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    tt = [tensor_from_numpy(a, "bfloat16", device="cpu") for a in arrays]
    return jx, tt


def _errors(got, want, atol=ATOL, rtol=RTOL):
    """How far the worst element lies past atol + rtol |want| (<= 0 when
    every element is inside), and rms(got - want) / rms(want)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    diff = np.abs(got - want)
    excess = float((diff - atol - rtol * np.abs(want)).max())
    rel_rms = float(np.sqrt(np.mean(diff ** 2) / np.mean(want ** 2)))
    return excess, rel_rms


def _replay(q, k, v, causal, **kw):
    return flash.flash_mha_tiled_replay(
        q, k, v, causal=causal, block_k=flash.key_tile(q.shape[3]), **kw)


@pytest.mark.parametrize("b,h,hkv,t,s,hd,causal", REPLAY_CASES)
def test_replay_matches_the_reference_at_flash_tol(b, h, hkv, t, s, hd,
                                                   causal):
    (jq, jk, jv), (q, k, v) = _inputs(b, h, hkv, t, s, hd)
    got = _replay(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, t, hd)
    # the reference's ops pad K/V to a multiple of block_k with zero keys
    # (wrong where the causal mask does not hide them, refused when not
    # causal): a ragged S is taken as one key block, so nothing is padded
    want = ref_flash(jq, jk, jv, causal=causal, block_q=128,
                     block_k=128 if s % 128 == 0 else s)
    excess, rel_rms = _errors(got, want)
    assert excess <= 0 and rel_rms <= RMS_REL, (excess, rel_rms)
    excess, rel_rms = _errors(got, ref_mha(jq, jk, jv, causal=causal))
    assert excess <= 0 and rel_rms <= RMS_REL, (excess, rel_rms)


def test_replay_without_the_p_split_misses_the_rms_limit():
    """The control: P rounded to one bfloat16 before P V (as SDPA does)
    stays inside the elementwise limits but misses rms <= 5e-4 by ~4x at
    S = 512, while the split P passes both."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 1, 512, 512, 64, seed=1)
    want = ref_flash(jq, jk, jv, causal=True, block_q=128, block_k=128)
    excess, rel_rms = _errors(_replay(q, k, v, True, split_p=False), want)
    assert rel_rms > RMS_REL, rel_rms
    excess, rel_rms = _errors(_replay(q, k, v, True), want)
    assert excess <= 0 and rel_rms <= RMS_REL, (excess, rel_rms)


def _f16_inputs(b, h, hkv, t, s, hd, seed=0):
    """(q, k, v) as jax and torch (CPU) float16 arrays with the same bits."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32).astype(np.float16)
              for shape in ((b, h, t, hd), (b, hkv, s, hd), (b, hkv, s, hd))]
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("b,h,hkv,t,s,hd,causal", REPLAY_CASES)
def test_float16_replay_matches_the_reference_at_flash_tol(b, h, hkv, t, s,
                                                           hd, causal):
    """The float16 instance of the kernel: P split into float16 halves."""
    atol, rtol, rms_rel = F16_TOL
    (jq, jk, jv), (q, k, v) = _f16_inputs(b, h, hkv, t, s, hd)
    got = _replay(q, k, v, causal)
    assert got.dtype == torch.float16 and got.shape == (b, h, t, hd)
    want = ref_flash(jq, jk, jv, causal=causal, block_q=128,
                     block_k=128 if s % 128 == 0 else s)
    for ref in (want, ref_mha(jq, jk, jv, causal=causal)):
        excess, rel_rms = _errors(got, ref, atol, rtol)
        assert excess <= 0 and rel_rms <= rms_rel, (excess, rel_rms)


def test_float16_replay_without_the_p_split_misses_the_rms_limit():
    """The control in float16: P rounded to one float16 before P V stays
    inside the elementwise limits but misses rms <= 1e-4 (~2.6e-4 at
    S = 512), while the split P passes both (~7e-6)."""
    atol, rtol, rms_rel = F16_TOL
    (jq, jk, jv), (q, k, v) = _f16_inputs(1, 2, 1, 512, 512, 64, seed=1)
    want = ref_flash(jq, jk, jv, causal=True, block_q=128, block_k=128)
    excess, rel_rms = _errors(_replay(q, k, v, True, split_p=False), want,
                              atol, rtol)
    assert excess <= 0 and rel_rms > rms_rel, (excess, rel_rms)
    excess, rel_rms = _errors(_replay(q, k, v, True), want, atol, rtol)
    assert excess <= 0 and rel_rms <= rms_rel, (excess, rel_rms)
