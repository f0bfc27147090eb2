"""The port's ``models/ssm.py`` and the ``ssm``/``hybrid`` models against
the JAX package's, with the reference's weights carried across.

* xlstm-125m and zamba2-2.7b's smoke configs through
  ``test_torch_lm_models``' checks: prefill logits and the recurrent
  states, 4 decode steps, the loss (float32 at 1e-4 against the
  reference under ``jax.jit``, bfloat16 at 2e-2 against it op by op),
  and a decode from the reference's prefill cache;
* ``gla_chunked`` where the chunk divides T, where it does not (the
  reference's ``gcd`` chunk) and from a carried state; ``gla_decode``;
* ``conv1d_causal`` in bfloat16, bit for bit against the reference op by
  op (its taps summed in order in bfloat16), with and without a state;
* Mamba2, mLSTM and sLSTM apply (prefill) and decode with their states,
  in float32 and bfloat16;
* the O(1) decode state (the reference's
  ``test_long_context_decode_state_is_o1``), on ``meta`` tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as ref_ssm  # noqa: E402

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from test_torch_lm_models import (TOL, check_against_the_reference,  # noqa: E402
                                  check_decode_from_the_reference_cache,
                                  pair, reference_run)

SSM = ("xlstm-125m", "zamba2-2.7b")


@pytest.fixture(scope="module")
def run_of():
    runs = {}

    def get(name, dtype):
        if (name, dtype) not in runs:
            runs[name, dtype] = reference_run(name, dtype)
        return runs[name, dtype]

    return get


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", SSM)
def test_ssm_models_match_the_reference(run_of, name, dtype):
    check_against_the_reference(run_of(name, dtype), dtype)


@pytest.mark.parametrize("name", SSM)
def test_decode_from_the_reference_prefill_cache(run_of, name):
    check_decode_from_the_reference_cache(run_of(name, "float32"), name)


def close(want, got, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def gla_inputs(t: int, seed: int = 0, b: int = 2, h: int = 3, n: int = 4,
               p: int = 5):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, t, h, n)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, t, h, p)).astype(np.float32)
    log_f = -np.abs(rng.standard_normal((b, t, h))).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return q, k, v, log_f, s0


@pytest.mark.parametrize("t,chunk", [(12, 4), (12, 8), (37, 128), (37, 8),
                                     (16, 16)])
@pytest.mark.parametrize("carried", [False, True], ids=["s0", "carried"])
def test_gla_chunked_matches_the_reference(t, chunk, carried):
    """(12, 8) and (37, 8) run the reference's gcd chunk (4 and 1)."""
    q, k, v, log_f, s0 = gla_inputs(t)
    s0 = s0 if carried else None
    want, want_s = jax.jit(lambda *a: ref_ssm.gla_chunked(
        *a[:4], chunk=chunk, s0=a[4]))(q, k, v, log_f, s0)
    got, got_s = ssm.gla_chunked(
        *map(torch.from_numpy, (q, k, v, log_f)), chunk=chunk,
        s0=None if s0 is None else torch.from_numpy(s0))
    close(want, got, 1e-4)
    close(want_s, got_s, 1e-4)


def test_gla_decode_matches_the_reference_and_a_chunk_of_one():
    q, k, v, log_f, s0 = gla_inputs(1, seed=1)
    want, want_s = jax.jit(ref_ssm.gla_decode)(
        q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], s0)
    args = [torch.from_numpy(a) for a in (q, k, v, log_f, s0)]
    got, got_s = ssm.gla_decode(*(a[:, 0] for a in args[:4]), args[4])
    close(want, got, 1e-4)
    close(want_s, got_s, 1e-4)
    one, one_s = ssm.gla_chunked(*args[:4], chunk=1, s0=args[4])
    close(got.numpy(), one[:, 0], 1e-5)
    close(got_s.numpy(), one_s, 1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_causal_bf16_is_the_reference_bit_for_bit(with_state):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    bf = jnp.bfloat16
    with jax.disable_jit():
        want, want_s = ref_ssm.conv1d_causal(
            jnp.asarray(x, bf), jnp.asarray(w, bf), jnp.asarray(b, bf),
            None if state is None else jnp.asarray(state, bf))
    t = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    got, got_s = ssm.conv1d_causal(t(x), t(w), t(b),
                                   None if state is None else t(state))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(got_s.float().numpy(),
                                  np.asarray(want_s, np.float32))
    # the port's order matters: one float32 accumulation rounds otherwise
    fused = torch.nn.functional.conv1d(
        torch.cat([t(state) if with_state else torch.zeros(
            (2, 3, 24), dtype=torch.bfloat16), t(x)], 1).transpose(1, 2)
        .float(), t(w).float().T[:, None, :], t(b).float(),
        groups=24).transpose(1, 2).bfloat16()
    assert not torch.equal(fused, got)


BLOCKS = {
    "mamba2": ("zamba2-2.7b", ref_ssm.mamba2_specs, ref_ssm.mamba2_apply,
               ref_ssm.mamba2_decode, ssm.mamba2_apply, ssm.mamba2_decode),
    "mlstm": ("xlstm-125m", ref_ssm.mlstm_specs, ref_ssm.mlstm_apply,
              ref_ssm.mlstm_decode, ssm.mlstm_apply, ssm.mlstm_decode),
    "slstm": ("xlstm-125m", ref_ssm.slstm_specs, ref_ssm.slstm_apply,
              ref_ssm.slstm_decode, ssm.slstm_apply, ssm.slstm_decode),
}


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_apply_and_decode_with_states(block, dtype):
    """A 7-token prefill returning its state, then 2 decode steps on it:
    outputs and every state tensor against the reference run op by op
    (float32 at 1e-4, bfloat16 at 2e-2).  The block's parameters are
    drawn away from their init (biases, ``a_log`` and ``d_skip``
    included)."""
    name, ref_specs, ref_apply, ref_decode, apply, decode = BLOCKS[block]
    ref_config, config = pair(name, dtype)
    rng = np.random.default_rng(6)
    tree = cm.tree_map(
        lambda s: (rng.standard_normal(s.shape) * min(s.scale, 0.5)).astype(
            np.float32), ref_specs(ref_config),
        lambda x: hasattr(x, "logical_axes"))
    is_array = lambda x: isinstance(x, np.ndarray)  # noqa: E731
    ref_params = cm.tree_map(jnp.asarray, tree, is_array)
    params = cm.tree_map(torch.from_numpy, tree, is_array)
    x = rng.standard_normal((2, 9, config.d_model)).astype(np.float32)
    kw = {} if block == "slstm" else {"chunk": 4}
    with jax.disable_jit(dtype == "bfloat16"):
        xr = jnp.asarray(x).astype(ref_config.dtype)
        y, state = ref_apply(ref_params, xr[:, :7], ref_config,
                             return_state=True, **kw)
        want = [(y, state)]
        for i in (7, 8):
            y, state = ref_decode(ref_params, xr[:, i:i + 1], ref_config,
                                  state)
            want.append((y, state))
    xt = torch.from_numpy(x).to(config.dtype)
    y, state = apply(params, xt[:, :7], config, return_state=True, **kw)
    got = [(y, state)]
    for i in (7, 8):
        y, state = decode(params, xt[:, i:i + 1], config, state)
        got.append((y, state))
    tol = TOL[dtype]
    for (wy, ws), (gy, gs) in zip(want, got):
        assert type(gs).__name__ == type(ws).__name__
        assert gy.dtype == config.dtype
        close(wy, gy, tol)
        for field, a, b in zip(gs._fields, ws, gs):
            assert b.dtype == (config.dtype if field == "conv"
                               else torch.float32), field
            close(a, b, tol)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-2.7b"])
def test_decode_state_is_o1(name, smoke):
    """An ``ssm`` cache does not grow with the cache's length; a
    ``hybrid`` cache grows only in its shared attention block's K/V."""
    config = ARCHS[name].smoke_config() if smoke else ARCHS[name].config
    model = build_model(config, device="meta")

    def tensors(cache):
        return [(path, t) for path, t in cm.tree_leaves_with_path(
            cache, torch.is_tensor) if torch.is_tensor(t)]

    def size(cache, attention: bool):
        return sum(t.numel() for path, t in tensors(cache)
                   if path.startswith("shared") == attention)

    small, large = model.init_cache(1, 128), model.init_cache(1, 1 << 19)
    assert all(t.device.type == "meta" for _, t in tensors(large))
    assert 0 < size(small, False) == size(large, False)
    if config.family == "ssm":
        assert size(large, True) == 0
    else:
        assert size(large, True) == size(small, True) << 12 > 0
    assert get_arch(name).config.supports_long_context
