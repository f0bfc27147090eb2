"""The port's AdamW, its schedule and the roofline's model counts against
the JAX package's (``repro.optim``, ``repro.roofline.analysis``).

The schedule is computed as the reference computes it (float32 tensors
from an int32 step) and is equal bit for bit.  ``apply_updates`` runs
the reference's formula op by op in its order, but the two packages do
not round each operation alike: XLA contracts some products and sums
into fused multiply-adds (``b1 * m + (1 - b1) * g`` once m is not 0,
checked against a float64 replay), and ATen divides a CPU tensor by a
one-element one as a product with its reciprocal; with clipping on, the
clip scale also carries ``global_norm``'s float32 sum, which the two
packages add in other orders (rtol 1e-6 on the norm), into every
coordinate.  So parameters and moments are held at rtol 1e-6 and atol
1e-6 of the leaf's largest |value| (a few units in the last place; a
moment's coordinate near 0 is a difference of two such roundings).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.roofline import analysis as ref_roofline  # noqa: E402

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import (OptConfig, apply_updates,  # noqa: E402
                               global_norm, init_opt_state, learning_rate)
from repro_torch.roofline import count_params, model_flops  # noqa: E402

MOMENTS = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STEPS = 4


def tree(rng, scale=1.0):
    """A small tree of float32 leaves (nested dict and list)."""
    return {"w": (rng.standard_normal((33, 17)) * scale).astype(np.float32),
            "blocks": [{"b": (rng.standard_normal(100) * scale).astype(
                np.float32)}, {"a": (rng.standard_normal((4, 5, 6))
                                     * scale).astype(np.float32)}]}


def to_ref(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def to_port(t):
    return jax.tree_util.tree_map(torch.tensor, t)


def flat(t):
    return [np.asarray(jnp.asarray(x).astype(jnp.float32))
            if not isinstance(x, torch.Tensor) else x.float().numpy()
            for x in jax.tree_util.tree_leaves(t)]


@pytest.mark.parametrize("cfg", [
    dict(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10, decay_steps=100),
    dict(), dict(warmup_steps=0, decay_steps=1)])
def test_learning_rate_is_the_reference_bit_for_bit(cfg):
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 101, 200, 1234, 9999, 20000):
        want = np.float32(ref_adamw.learning_rate(
            jnp.int32(s), ref_adamw.OptConfig(**cfg)))
        got = learning_rate(torch.tensor(s, dtype=torch.int32),
                            OptConfig(**cfg))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.numpy() == want, s


def test_lr_schedule_shape():
    """``test_train_runtime.py::test_lr_schedule_shape`` on the port."""
    cfg = OptConfig(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10,
                    decay_steps=100)
    lrs = [float(learning_rate(torch.tensor(s, dtype=torch.int32), cfg))
           for s in (0, 5, 10, 50, 100, 200)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] < 1e-3
    assert lrs[4] == pytest.approx(1e-4, rel=1e-3)
    assert lrs[5] == pytest.approx(1e-4, rel=1e-3)


@pytest.mark.parametrize("clip", ["off", "on"])
@pytest.mark.parametrize("moments", sorted(MOMENTS))
def test_adamw_matches_the_reference(moments, clip):
    """``STEPS`` updates of the same leaves with the same gradients:
    parameters, both moments, ``step``, ``lr`` and ``grad_norm``."""
    ref_dt, port_dt = MOMENTS[moments]
    clip_norm = 1.0 if clip == "on" else 1e9
    kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=20,
              clip_norm=clip_norm)
    ref_cfg = ref_adamw.OptConfig(moment_dtype=ref_dt, **kw)
    cfg = OptConfig(moment_dtype=port_dt, **kw)
    rng = np.random.default_rng(0)
    start = tree(rng)
    ref_p, p = to_ref(start), to_port(start)
    ref_s, s = ref_adamw.init_opt_state(ref_p, ref_cfg), \
        init_opt_state(p, cfg)
    for _ in range(STEPS):
        g = tree(rng, scale=3.0)
        ref_p, ref_s, want = ref_adamw.apply_updates(ref_p, to_ref(g), ref_s,
                                                     ref_cfg)
        p, s, got = apply_updates(p, to_port(g), s, cfg)
        assert float(got["lr"]) == float(want["lr"])
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-6)
        assert clip == "on" or float(want["grad_norm"]) < clip_norm
        for want_t, got_t in ((ref_p, p), (ref_s["m"], s["m"]),
                              (ref_s["v"], s["v"])):
            for a, b in zip(flat(want_t), flat(got_t)):
                np.testing.assert_allclose(
                    b, a, rtol=1e-6, atol=1e-6 * np.abs(a).max())
    assert int(s["step"]) == int(ref_s["step"]) == STEPS
    assert s["step"].dtype == torch.int32
    assert all(t.dtype == port_dt
               for t in jax.tree_util.tree_leaves(s["m"]) +
               jax.tree_util.tree_leaves(s["v"]))


def test_apply_updates_leaves_its_inputs_as_they_were():
    rng = np.random.default_rng(1)
    p, g = to_port(tree(rng)), to_port(tree(rng))
    s = init_opt_state(p, OptConfig())
    copies = [t.clone() for t in jax.tree_util.tree_leaves((p, g, s))]
    new_p, new_s, _ = apply_updates(p, g, s, OptConfig())
    for a, b in zip(copies, jax.tree_util.tree_leaves((p, g, s))):
        assert torch.equal(a, b)
    assert all(a is not b for a, b in zip(jax.tree_util.tree_leaves(new_p),
                                          jax.tree_util.tree_leaves(p)))
    assert int(new_s["step"]) == 1 and int(s["step"]) == 0


def test_adamw_moment_dtype_compression():
    """``test_train_runtime.py::test_adamw_moment_dtype_compression`` on
    the port."""
    params = {"w": torch.ones((8, 8))}
    grads = {"w": torch.full((8, 8), 0.1)}
    cfg = OptConfig(moment_dtype=torch.bfloat16)
    st = init_opt_state(params, cfg)
    assert st["m"]["w"].dtype == torch.bfloat16
    p2, st2, _ = apply_updates(params, grads, st, cfg)
    assert st2["v"]["w"].dtype == torch.bfloat16
    assert not torch.equal(p2["w"], params["w"])


def test_global_norm_sums_in_the_trees_order():
    """Leaves in the tree's order (dict keys sorted): a float32 sum whose
    order shows, against the reference's."""
    # 2**24 + 1 rounds back to 2**24: four 1s after it are lost, before it
    # they are not
    t = {k: np.ones(1, np.float32) for k in "bcde"}
    t["a"] = np.full(1, 4096.0, np.float32)
    got = global_norm(to_port(t))
    want = ref_adamw.global_norm(to_ref(t))
    assert float(got) == float(want) == 4096.0
    in_insertion_order = sum(torch.tensor(t[k]).square().sum()
                             for k in "bcdea")
    assert float(torch.sqrt(in_insertion_order)) > 4096.0
    rng = np.random.default_rng(2)
    t = tree(rng)
    np.testing.assert_allclose(float(global_norm(to_port(t))),
                               float(ref_adamw.global_norm(to_ref(t))),
                               rtol=1e-6)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_count_params_and_model_flops_match_the_reference(name):
    ref_model = ref_build(ref_get_arch(name).config)
    model = build_model(get_arch(name).config, device="cpu")
    for active in (False, True):
        assert count_params(model, active) == \
            ref_roofline.count_params(ref_model, active)
    for kind, seq, batch in (("train", 4096, 256), ("prefill", 32768, 32),
                             ("decode", 32768, 128)):
        assert model_flops(model, kind, seq, batch) == \
            ref_roofline.model_flops(ref_model, kind, seq, batch)


def test_olmo_counts():
    """olmo-1b's counts as the train path's bound reads them."""
    model = build_model(get_arch("olmo-1b").config, device="cpu")
    assert count_params(model) == 1_073_741_824
    assert sum(p.numel() for p in model.parameters()) == 1_177_026_560
    assert model_flops(model, "train", 2048, 8) == 6 * 1_073_741_824 * 16384
