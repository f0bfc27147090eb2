"""The port's Mixture-of-Experts layer and ``moe`` models against the JAX
package's, with the reference's weights carried across.

* deepseek-moe-16b and arctic-480b's smoke configs through
  ``test_torch_lm_models``' checks: prefill logits and cache, 4 decode
  steps, the loss with its aux term (float32 at 1e-4 against the
  reference under ``jax.jit``, bfloat16 at 2e-2 against it op by op),
  and a decode from the reference's prefill cache;
* ``moe_apply`` with drops forced (``capacity_factor=0.5``): the dropped
  assignments are the reference's, assignment for assignment, and the
  outputs and aux loss agree; in both styles and both types;
* grouped dispatch: G = 1 against G = 2 with no drops (the reference's
  ``test_moe_groups_equivalence``), and the group count and capacity at
  the full configs' prompt and decode shapes;
* the aux loss with drops (the reference's ``test_moe_capacity_drops_and
  _aux``: Switch aux >= 1 at balance);
* ties: zero router weights make every probability equal, and the
  lowest expert indices must be chosen, as ``jax.lax.top_k`` chooses;
* the combine: bit for bit the reference's ``segment_sum`` in bfloat16;
* the loss and its gradient on ``meta`` tensors (the dry-run's device):
  the aux loss counts the assignments with a static-shape scatter-add,
  where ``torch.bincount`` has no ``meta`` kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from test_torch_lm_models import (TOL, check_against_the_reference,  # noqa: E402
                                  check_decode_from_the_reference_cache,
                                  pair, reference_run)

MOE = ("deepseek-moe-16b", "arctic-480b")
CPU = "cpu"


@pytest.fixture(scope="module")
def run_of():
    runs = {}

    def get(name, dtype):
        if (name, dtype) not in runs:
            runs[name, dtype] = reference_run(name, dtype)
        return runs[name, dtype]

    return get


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", MOE)
def test_moe_models_match_the_reference(run_of, name, dtype):
    check_against_the_reference(run_of(name, dtype), dtype)


@pytest.mark.parametrize("name", MOE)
def test_decode_from_the_reference_prefill_cache(run_of, name):
    check_decode_from_the_reference_cache(run_of(name, "float32"), name)


def moe_layer(name: str, dtype: str, seed: int = 0, **overrides):
    """One MoE layer of ``name``'s smoke config: the configs, seeded
    float32 numpy weights, and both packages' copies of them."""
    ref_config, config = pair(name, dtype, **overrides)
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        return (rng.standard_normal(spec.shape) * spec.scale).astype(
            np.float32)

    tree = cm.tree_map(draw, mlp.moe_specs(config), cm.is_spec)
    is_array = lambda x: isinstance(x, np.ndarray)  # noqa: E731
    ref_params = cm.tree_map(lambda a: jnp.asarray(a).astype(
        ref_config.param_dtype), tree, is_array)
    params = cm.tree_map(lambda a: torch.from_numpy(a).to(
        config.param_dtype), tree, is_array)
    return ref_config, config, ref_params, params


def tokens_in(config, b: int, t: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, t, config.d_model)).astype(np.float32)


def ref_keep(ref_params, x: np.ndarray, ref_config):
    """The reference's ``keep`` (G, ntg*k), through its own router and
    vmapped ``_dispatch_group``."""
    b, t, d = x.shape
    nt = b * t
    G = ref_config.moe_groups if nt % ref_config.moe_groups == 0 else 1
    xf = jnp.asarray(x).astype(ref_config.dtype).reshape(nt, d)
    logits = (xf @ ref_params["w_router"].astype(xf.dtype)).astype(
        jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1).reshape(G, nt // G, -1)
    C = ref_mlp._capacity(nt // G, ref_config)
    _, _, keep, _, _ = jax.vmap(lambda xi, pi: ref_mlp._dispatch_group(
        xi, pi, ref_config, C))(xf.reshape(G, nt // G, d), probs)
    return np.asarray(keep)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_with_drops_matches_the_reference(name, dtype):
    ref_config, config, ref_params, params = moe_layer(
        name, dtype, capacity_factor=0.5)
    x = tokens_in(config, 2, 64)
    apply = ref_mlp.moe_apply if dtype == "bfloat16" else jax.jit(
        lambda p, x: ref_mlp.moe_apply(p, x, ref_config))
    with jax.disable_jit(dtype == "bfloat16"):
        xr = jnp.asarray(x).astype(ref_config.dtype)
        want, want_aux = (apply(ref_params, xr, ref_config)
                          if dtype == "bfloat16" else apply(ref_params, xr))
        keep_want = ref_keep(ref_params, x, ref_config)
    xt = torch.from_numpy(x).to(config.dtype)
    got, aux = mlp.moe_apply(params, xt, config)
    keep = mlp.route(params, xt.reshape(-1, config.d_model), config)[4]
    assert keep.shape == keep_want.shape == (2, 64 * config.top_k)
    assert 0 < int((~keep).sum()) and \
        np.array_equal(keep.numpy(), keep_want)      # drops, token for token
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    assert abs(float(aux) - float(want_aux)) <= tol * (1 + float(want_aux))


def test_moe_groups_equivalence():
    """G = 1 against G = 2 with generous capacity (no drops): the port's
    losses agree with each other and with the reference's."""
    ref_base, base = pair("deepseek-moe-16b", "float32", capacity_factor=8.0)
    tokens = np.random.default_rng(3).integers(
        0, base.vocab_size, (2, 12)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(np.roll(tokens, -1, axis=1))}
    ref_batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ref_model = ref_build(ref_base.replace(moe_groups=1))
    ref_params = ref_model.init(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32),
                                  ref_params)
    from repro_torch import interop
    losses = {}
    for groups in (1, 2):
        config = base.replace(moe_groups=groups)
        model = build_model(config, device=CPU)
        params = model.load_params(interop.lm_params_from_numpy(
            tree, config, device=CPU))
        losses[groups] = float(model.loss(params, batch)[0])
        assert mlp.moe_groups(2 * 12, config) == groups
    want = float(jax.jit(ref_model.loss)(ref_params, ref_batch)[0])
    np.testing.assert_allclose(losses[1], losses[2], rtol=2e-5)
    np.testing.assert_allclose(losses[1], want, rtol=1e-5)


def test_aux_loss_with_drops():
    """capacity_factor=0.5 forces drops: the loss is finite and the
    Switch aux is at least 1 at balance, as the reference's is, and
    equals the reference's."""
    ref_config, config = pair("deepseek-moe-16b", "float32",
                              capacity_factor=0.5)
    ref_model = ref_build(ref_config)
    ref_params = ref_model.init(jax.random.PRNGKey(2))
    tree = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32),
                                  ref_params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, config.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.integers(0, config.vocab_size, (2, 64)).astype(np.int32)
    from repro_torch import interop
    model = build_model(config, device=CPU)
    params = model.load_params(interop.lm_params_from_numpy(
        tree, config, device=CPU))
    loss, metrics = model.loss(params, {"tokens": torch.as_tensor(tokens),
                                        "labels": torch.as_tensor(labels)})
    _, want = jax.jit(ref_model.loss)(ref_params, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    assert np.isfinite(float(loss))
    assert float(metrics["aux"]) >= 1.0 - 1e-3
    np.testing.assert_allclose(float(metrics["aux"]), float(want["aux"]),
                               rtol=1e-5)


@pytest.mark.parametrize("name", MOE)
def test_moe_loss_and_gradient_run_on_meta(name):
    config = get_arch(name).smoke_config()
    model = build_model(config, device="meta")
    leaves = [t.requires_grad_(True) for _, t in
              cm.tree_leaves_with_path(model.params(), torch.is_tensor)]
    tokens = torch.empty((2, 16), dtype=torch.int32, device="meta")
    loss, metrics = model.loss(model.params(), {"tokens": tokens,
                                                "labels": tokens})
    grads = torch.autograd.grad(loss, leaves)
    assert loss.device.type == "meta" and metrics["aux"].shape == ()
    assert [g.shape for g in grads] == [t.shape for t in leaves]


def test_top_k_breaks_ties_toward_the_lower_index():
    """Probabilities from a set of four values (ties in every row): the
    port's indices and values are ``jax.lax.top_k``'s, bit for bit."""
    rng = np.random.default_rng(5)
    probs = rng.choice(np.float32([0.1, 0.2, 0.25, 0.3]), (200, 64))
    for k in (1, 2, 6, 64):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = mlp.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("name", MOE)
def test_zero_router_chooses_the_lowest_experts(name):
    """Zero router weights: every probability 1/E, so the top-k are
    experts 0..k-1 (their capacity fills in token order and the rest
    drop); the layer's output equals the reference's."""
    ref_config, config, ref_params, params = moe_layer(name, "float32")
    ref_params["w_router"] = jnp.zeros_like(ref_params["w_router"])
    params["w_router"] = torch.zeros_like(params["w_router"])
    x = tokens_in(config, 2, 12, seed=4)
    xt = torch.from_numpy(x)
    _, _, e_flat, rank_c, keep, gate_vals, expert_idx = mlp.route(
        params, xt.reshape(-1, config.d_model), config)
    K = config.top_k
    assert (expert_idx == torch.arange(K)).all()
    assert torch.allclose(gate_vals, torch.full_like(gate_vals, 1 / K))
    np.testing.assert_array_equal(keep.numpy(),
                                  ref_keep(ref_params, x, ref_config))
    want, _ = jax.jit(lambda p, x: ref_mlp.moe_apply(p, x, ref_config))(
        ref_params, jnp.asarray(x))
    got, _ = mlp.moe_apply(params, xt, config)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_combine_is_the_reference_segment_sum_bit_for_bit():
    """bfloat16, the reference op by op: a token's k gated outputs summed
    in slot order equal its ``segment_sum``, bit for bit."""
    rng = np.random.default_rng(0)
    G, E, C, d, ntg, K = 2, 8, 8, 16, 12, 4
    out = rng.standard_normal((G, E, C, d)).astype(np.float32)
    e = rng.integers(0, E, (G, ntg * K))
    r = rng.integers(0, C + 1, (G, ntg * K))              # C: dropped
    keep = r < C
    gates = rng.random((G, ntg, K)).astype(np.float32)
    tok = jnp.asarray(np.repeat(np.arange(ntg), K))
    with jax.disable_jit():
        want = jax.vmap(lambda o, de, dr, ke, g: ref_mlp._combine_group(
            o, (de, dr), ke, g, tok, ntg))(
            jnp.asarray(out, jnp.bfloat16), jnp.asarray(e), jnp.asarray(r),
            jnp.asarray(keep), jnp.asarray(gates))
    args = [torch.from_numpy(a) for a in (e, r, keep, gates)]
    got = mlp.combine(torch.from_numpy(out).bfloat16(), *args)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("name,tokens,groups,capacity", [
    ("deepseek-moe-16b", 4096, 32, 16),   # the 4096-token prefill
    ("deepseek-moe-16b", 1024, 32, 8),
    ("deepseek-moe-16b", 37, 1, 8),       # the 37-token prompt
    ("deepseek-moe-16b", 1, 1, 8),        # every decode step
    ("arctic-480b", 1024, 32, 8),
    ("arctic-480b", 1, 1, 8),
])
def test_groups_and_capacity_at_full_width(name, tokens, groups, capacity):
    config, ref_config = get_arch(name).config, ref_get_arch(name).config
    G = mlp.moe_groups(tokens, config)
    assert G == groups
    assert mlp._capacity(tokens // G, config) == capacity == \
        ref_mlp._capacity(tokens // G, ref_config)
