"""The port's train step against the JAX package's ``make_train_step``
(the ten archs' float32 steps: ``tests/test_torch_train_archs.py``, which
imports its helpers from here).

Both packages start from one state made with numpy (parameters drawn by
the reference's specs, zero moments, step 0): the reference takes it
through ``jnp.asarray``, the port through
``interop.train_state_from_numpy`` (JAX's RNG does not carry over to
torch); both take the same batches, made with numpy.

Tolerances, and why each is needed:

* float32 compute, every one of the ten archs' smoke configs, against
  the reference under ``jax.jit``: the gradients of the first step within
  ``GRAD_TOL`` = 1e-4 of each leaf's largest |g| (the forward's float32
  tolerance in ``test_torch_lm_models.py``; both sum in float32 in other
  orders), the first step's ``grad_norm`` at rtol 1e-4 (the recurrent
  archs' differ by 1.5e-5), the loss of both steps at rtol 1e-5; after two steps every parameter leaf at the
  reference's own ``test_grad_accum_matches_full_batch`` limits (atol
  2e-3, rtol 1e-2): AdamW's first update is m/sqrt(v) = g/|g|, so a
  coordinate whose float32 gradient is a sum that cancels to near zero
  can move by up to lr = 1e-3 either way in one package and the other.
  Those moved coordinates make the second step's gradients differ by
  more than the first's, so its ``grad_norm`` is held at rtol 5e-3
  (xlstm-125m's differs by 1.6e-3).
* bfloat16 compute (olmo-1b's smoke config) against the reference run op
  by op (``jax.disable_jit``), as the forward is held: the port's
  backward formulas round in bfloat16 at other places than JAX's
  derivative rules (a quotient's derivative is -g·x·y⁻² there,
  -g·x/(y·y) in torch), and the embedding's gradient sums a token's rows
  in float32 where the reference's scatter-add sums them in bfloat16
  (``models/model.py``), so the gradients agree to ~1% of each leaf's
  largest |g|: held at 2e-2 of it (the forward's bfloat16 tolerance);
  the loss at rtol 2e-2; the parameters after one step at atol 2e-3,
  rtol 1e-2, as above.
"""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.optim.adamw import OptConfig as RefOptConfig  # noqa: E402
from repro.optim.adamw import apply_updates as ref_apply  # noqa: E402
from repro.train.step import TrainState as RefTrainState  # noqa: E402
from repro.train.step import make_train_step as ref_make  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import (TrainState, make_eval_step,  # noqa: E402
                               make_train_step)
from repro_torch.train.step import _value_and_grad  # noqa: E402

CPU = "cpu"
B, T = 4, 16
FRAMES = 6
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PARAM_ATOL, PARAM_RTOL = 2e-3, 1e-2


def configs(name: str, dtype: str = "float32", **overrides):
    """The smoke config of ``name`` in both packages, computing in
    ``dtype`` (parameters float32 in both cases)."""
    ref, port = ref_get_arch(name).smoke_config(), \
        get_arch(name).smoke_config()
    if dtype == "float32":
        ref, port = ref.replace(dtype=jnp.float32), \
            port.replace(dtype=torch.float32)
    return ref.replace(**overrides), port.replace(**overrides)


def numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), tree)


def batches(config, n: int, seed: int = 0, b: int = B):
    """``n`` numpy batches: tokens, labels and the frontend's stub."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {k: rng.integers(0, config.vocab_size, (b, T)).astype(
            np.int32) for k in ("tokens", "labels")}
        if config.frontend == "patch_stub":
            batch["patch_embeds"] = rng.standard_normal(
                (b, config.n_frontend_tokens, config.d_model)).astype(
                    np.float32)
        if config.frontend == "audio_stub":
            batch["frame_embeds"] = rng.standard_normal(
                (b, FRAMES, config.d_model)).astype(np.float32)
        out.append(batch)
    return out


def ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def numpy_state(ref_config, seed: int = 1):
    """A seeded initial state in the reference's layout as numpy arrays:
    parameters drawn by their specs (ones and zeros where the specs say),
    zero moments, step 0."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        return (rng.standard_normal(spec.shape) * spec.scale).astype(
            np.float32)

    specs = ref_build(ref_config).param_specs()
    params = jax.tree_util.tree_map(
        draw, specs, is_leaf=lambda x: hasattr(x, "logical_axes"))
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    return params, {"m": zeros, "v": zeros, "step": np.int32(0)}


def start(name, dtype="float32", seed=1, **overrides):
    """(ref config, port config, ref state, port state): one numpy state
    taken by the reference (``jnp.asarray``) and by the port
    (``interop.train_state_from_numpy``)."""
    ref_config, config = configs(name, dtype, **overrides)
    host = numpy_state(ref_config, seed)
    state = RefTrainState(*jax.tree_util.tree_map(jnp.asarray, host))
    port = interop.train_state_from_numpy(host, config, OptConfig(**OPT),
                                          device=CPU)
    return ref_config, config, state, port


def leaves(tree):
    return cm.tree_leaves_with_path(
        tree, lambda x: isinstance(x, (np.ndarray, torch.Tensor)))


def close_leaves(want, got, atol, rtol=0.0, scaled=False):
    """Every leaf of the numpy tree ``want`` against the port's tree, the
    same paths; with ``scaled`` the tolerance is ``atol`` times the
    leaf's largest |value|."""
    want, got = leaves(want), leaves(got)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        tol = atol * max(float(np.abs(a).max()), 1e-30) if scaled else atol
        np.testing.assert_allclose(b.float().numpy(), a, atol=tol, rtol=rtol,
                                   err_msg=path)


def grad_leaves(params):
    """Leaves that require grad of ``params`` (same storage), and the
    tree of them."""
    made = []

    def leaf(t):
        made.append(t.detach().requires_grad_(True))
        return made[-1]

    return made, cm.tree_map(leaf, params, torch.is_tensor)


class CountOps(TorchDispatchMode):
    """Counts the aten ops run under it, by op."""

    def __enter__(self):
        self.counts = Counter()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def moe_keeps(model, params, batch):
    """The port's ``keep`` of every MoE layer in one loss forward, with the
    layer's router weight and input."""
    seen = []
    apply = mlp.moe_apply

    def recording(p, h, config, *placed):
        keep = mlp.route(p, h.reshape(-1, config.d_model), config)[4]
        seen.append((p["w_router"].detach().numpy(),
                     h.detach().float().numpy(), keep.numpy()))
        return apply(p, h, config, *placed)

    mlp.moe_apply = recording
    try:
        with torch.no_grad():
            model.loss(params, batch)
    finally:
        mlp.moe_apply = apply
    return seen


def check_drops(ref_config, model, state, batch):
    """The MoE dispatch's drops token for token: each layer's ``keep``
    against the reference's dispatch of the same input."""
    seen = moe_keeps(model, state.params, port_batch(batch))
    assert len(seen) == ref_config.n_layers - ref_config.first_k_dense
    for w_router, h, keep in seen:
        b, t, d = h.shape
        nt = b * t
        G = ref_config.moe_groups if nt % ref_config.moe_groups == 0 else 1
        xf = jnp.asarray(h).reshape(nt, d)
        probs = jax.nn.softmax(xf @ jnp.asarray(w_router), axis=-1)
        C = ref_mlp._capacity(nt // G, ref_config)
        _, _, want, _, _ = jax.vmap(lambda xi, pi: ref_mlp._dispatch_group(
            xi, pi, ref_config, C))(xf.reshape(G, nt // G, d),
                                    probs.reshape(G, nt // G, -1))
        assert np.array_equal(keep, np.asarray(want))


def test_bf16_step_matches_the_reference_op_by_op():
    """olmo-1b's smoke config in its own bfloat16 compute against the
    reference run op by op: the gradients, the loss, and the parameters
    and moments after the step."""
    ref_config, config, state, port = start("olmo-1b", "bfloat16")
    model = build_model(config, device=CPU)
    batch = batches(config, 1)[0]
    ref_model = ref_build(ref_config)
    with jax.disable_jit():      # the reference's step, op by op
        (ref_loss, _), ref_grads = jax.value_and_grad(
            ref_model.loss, has_aux=True)(state.params, ref_batch(batch))
        params, opt, want = ref_apply(state.params, ref_grads, state.opt,
                                      RefOptConfig(**OPT))
        state = RefTrainState(params, opt)
    loss, _, grads = _value_and_grad(model, port.params, port_batch(batch))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-2)
    close_leaves(numpy_tree(ref_grads), grads, GRAD_TOL["bfloat16"],
                 scaled=True)
    port, got = make_train_step(model, OptConfig(**OPT))(
        port, port_batch(batch))
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=2e-2)
    close_leaves(numpy_tree(state.params), port.params, PARAM_ATOL,
                 PARAM_RTOL)


@pytest.mark.parametrize("name", ["olmo-1b", "deepseek-moe-16b",
                                  "xlstm-125m", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_remat_modes_give_equal_steps(name):
    """``full``, ``dots`` and ``none`` give the same step bit for bit (a
    prefix layer, MoE, the recurrent blocks, a shared block, an
    encoder-decoder)."""
    _, config, _, port = start(name)
    batch = port_batch(batches(config, 1)[0])
    outs = {remat: make_train_step(build_model(
        config.replace(remat=remat), device=CPU), OptConfig(**OPT))(
            port, batch) for remat in ("none", "dots", "full")}
    for remat in ("dots", "full"):
        state, metrics = outs[remat]
        for (path, a), (_, b) in zip(leaves(tuple(outs["none"][0])),
                                     leaves(tuple(state))):
            assert torch.equal(a, b), (remat, path)
        for key, value in outs["none"][1].items():
            assert torch.equal(value, metrics[key]), (remat, key)


def test_remat_modes_do_what_they_say():
    """Each remat mode does what it says (olmo-1b): the rematted forwards
    keep fewer tensors for the backward than ``none``, and in the
    backward ``full`` runs the forward's 2-D products again where
    ``dots`` runs none of them again (it kept them) but runs the other
    ops again."""
    _, config, _, port = start("olmo-1b")
    batch = port_batch(batches(config, 1)[0])
    saved, backward = {}, {}
    for remat in ("none", "dots", "full"):
        c = config.replace(remat=remat)
        model = build_model(c, device=CPU)
        count = [0]

        def pack(t):
            count[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            leaves_, tree = grad_leaves(port.params)
            loss, _ = model.loss(tree, batch)
        saved[remat] = count[0]
        with CountOps() as ops:
            torch.autograd.grad(loss, leaves_)
        backward[remat] = ops.counts
    assert saved["full"] < saved["none"] and saved["dots"] < saved["none"]
    mm = torch.ops.aten.mm.default
    assert backward["dots"][mm] == backward["none"][mm] \
        < backward["full"][mm]
    assert sum(backward["dots"].values()) > sum(backward["none"].values())


def test_grad_accum_matches_full_batch_and_the_reference():
    """``grad_accum=2`` against ``grad_accum=1`` at the reference's own
    limits (``test_train_runtime.py::test_grad_accum_matches_full_batch``),
    and against the reference's ``grad_accum=2`` as the float32 steps
    above are held."""
    _, config, state, port = start("olmo-1b")
    ref_config = configs("olmo-1b")[0]
    batch = batches(config, 1)[0]
    model = build_model(config, device=CPU)
    s1, m1 = make_train_step(model, OptConfig(**OPT), 1)(
        port, port_batch(batch))
    s2, m2 = make_train_step(model, OptConfig(**OPT), 2)(
        port, port_batch(batch))
    assert set(m2) == {"lr", "grad_norm", "loss"}      # metrics = {} there
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-3)
    for (_, a), (_, b) in zip(leaves(s1.params), leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3,
                                   rtol=1e-2)
    ref_state, want = jax.jit(ref_make(ref_build(ref_config),
                                       RefOptConfig(**OPT), 2))(
        state, ref_batch(batch))
    np.testing.assert_allclose(float(m2["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-5)
    close_leaves(numpy_tree(ref_state.params), s2.params, PARAM_ATOL,
                 PARAM_RTOL)


def test_step_takes_a_new_state_and_numpy_leaves():
    """The step leaves the state it is given as it was (bit for bit, the
    same tensors), writes no ``.grad``, and takes a state and a batch of
    numpy arrays (a restored checkpoint, the pipeline's arrays) as it
    takes tensors."""
    _, config, state, port = start("olmo-1b")
    model = build_model(config, device=CPU)
    model.load_params(port.params)
    before = [(p, t.clone()) for p, t in leaves(tuple(port))]
    batch = batches(config, 1)[0]
    step = make_train_step(model, OptConfig(**OPT))
    new, metrics = step(port, port_batch(batch))
    for (path, t), (_, now) in zip(before, leaves(tuple(port))):
        assert torch.equal(t, now), path
    assert all(p.grad is None and not p.requires_grad
               for p in model.parameters())
    assert all(not t.requires_grad for _, t in leaves(tuple(new)))
    again, metrics2 = step(numpy_tree(tuple(state)), batch)
    assert isinstance(again, TrainState)
    for (path, a), (_, b) in zip(leaves(tuple(new)), leaves(tuple(again))):
        assert torch.equal(a, b), path
    assert again.opt["step"].dtype == torch.int32
    assert float(metrics["loss"]) == float(metrics2["loss"])


def test_eval_step_is_the_loss():
    _, config, state, port = start("deepseek-moe-16b")
    model = build_model(config, device=CPU)
    batch = port_batch(batches(config, 1)[0])
    out = make_eval_step(model)(port.params, batch)
    assert set(out) == {"loss", "ce", "aux"} and not out["loss"].requires_grad
    loss, metrics = model.loss(port.params, batch)
    assert float(out["loss"]) == float(loss) and float(out["aux"]) > 0
    ref_config = configs("deepseek-moe-16b")[0]
    from repro.train.step import make_eval_step as ref_eval
    want = jax.jit(ref_eval(ref_build(ref_config)))(
        state.params, ref_batch(batches(config, 1)[0]))
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(out[key]), float(want[key]),
                                   rtol=1e-5)


def test_the_aux_loss_keeps_its_graph():
    """The MoE aux loss reaches the router's gradient: the router's
    gradient of ``loss`` differs from that of ``ce`` alone by the aux
    term's."""
    _, config, _, port = start("deepseek-moe-16b")
    model = build_model(config, device=CPU)
    batch = port_batch(batches(config, 1)[0])
    w = port.params["backbone"]["unit"][0]["moe"]["w_router"].detach() \
        .requires_grad_(True)
    params = cm.tree_map_with_path(
        lambda p, t: w if p == "backbone.unit.0.moe.w_router" else t,
        port.params, torch.is_tensor)
    total, metrics = model.loss(params, batch)
    g_total, = torch.autograd.grad(total, w, retain_graph=True)
    g_ce, = torch.autograd.grad(metrics["ce"], w, retain_graph=True)
    g_aux, = torch.autograd.grad(metrics["aux"], w)
    assert float(g_aux.abs().max()) > 0
    torch.testing.assert_close(g_total, g_ce + 0.01 * g_aux, atol=1e-6,
                               rtol=1e-5)
