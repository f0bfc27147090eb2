"""The LMs against the JAX package's, with the reference's weights
carried across (``interop.lm_params_from_numpy``).

For every arch's smoke config (llava with ``patch_embeds``, seamless
with ``frame_embeds``): the prefill's last-position logits and its whole
cache (K/V and lengths, recurrent states, cross K/V, the shared block's
caches), 4 decode steps from it, and the ``loss`` forward (with the MoE
aux loss); in float32 (``dtype = param_dtype = float32``) against the
reference under ``jax.jit`` at atol = rtol = 1e-4 with the greedy tokens
equal, and in the configs' own bfloat16 at the reference's 2e-2
(``tests/test_models.py``) against the reference run op by op
(``jax.disable_jit``): XLA's fusions under ``jit`` round bfloat16
differently from the reference's own ops (up to 0.039 on yi-6b's smoke
logits, past 2e-2), where the port's ops round as the reference's do.
Also a vocabulary of 500 (the padded rows' mask), a decode that starts
from the reference's prefill cache (``interop.lm_cache_from_numpy``),
and what a decode does to its cache.  ``tests/test_torch_lm_moe.py`` and
``tests/test_torch_lm_ssm.py`` run the same checks on the ``moe``,
``ssm`` and ``hybrid`` archs (the reference's first op-by-op run of an
arch compiles its ops, ~30 s, so the archs are spread over the files).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.model import LM, Seq2Seq, build_model  # noqa: E402
from repro_torch.models.ssm import SLSTMState, SSMState  # noqa: E402
from repro_torch.runtime import Mesh  # noqa: E402

DECODERS = ("olmo-1b", "stablelm-1.6b", "mistral-nemo-12b", "yi-6b",
            "llava-next-34b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, T, T0 = 2, 12, 8          # batch, tokens, prompt (then 4 decode steps)
CPU = "cpu"


def pair(name: str, dtype: str, **overrides):
    """The smoke config of ``name`` in both packages, computing in
    ``dtype`` (float32: the parameters too)."""
    ref, port = ref_get_arch(name).smoke_config(), get_arch(name).smoke_config()
    if dtype == "float32":
        ref = ref.replace(dtype=jnp.float32, param_dtype=jnp.float32)
        port = port.replace(dtype=torch.float32, param_dtype=torch.float32)
    return ref.replace(**overrides), port.replace(**overrides)


def numpy_tree(tree):
    """Float leaves as float32 numpy arrays (exact for bfloat16), the
    others (a cache's lengths) as they are."""
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        if jnp.issubdtype(p.dtype, jnp.floating) else np.asarray(p), tree)


FRAMES = 6                   # the encoder-decoder's frames


def inputs(config, seed=0):
    """Tokens, labels and the frontend's embeddings (``patch_embeds`` or
    ``frame_embeds``, else None) from a numpy seed."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, config.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, config.vocab_size, (B, T)).astype(np.int32)
    extra = None
    if config.frontend == "patch_stub":
        extra = {"patch_embeds": rng.standard_normal(
            (B, config.n_frontend_tokens, config.d_model)).astype(np.float32)}
    if config.frontend == "audio_stub":
        extra = {"frame_embeds": rng.standard_normal(
            (B, FRAMES, config.d_model)).astype(np.float32)}
    return tokens, labels, extra


def batches(tokens, labels, extra, n):
    ref = {"tokens": jnp.asarray(tokens[:, :n]),
           "labels": jnp.asarray(labels[:, :n])}
    port = {"tokens": torch.as_tensor(tokens[:, :n]),
            "labels": torch.as_tensor(labels[:, :n])}
    for key, value in (extra or {}).items():
        ref[key] = jnp.asarray(value)
        port[key] = torch.as_tensor(value)
    return ref, port


def reference_run(name, dtype, seed=1, **overrides):
    """The reference's prefill (logits, cache as numpy), decode logits and
    loss, and its parameters as numpy."""
    ref_config, config = pair(name, dtype, **overrides)
    model = ref_build(ref_config)
    params = model.init(jax.random.PRNGKey(seed))
    tokens, labels, extra = inputs(ref_config)
    pre, _ = batches(tokens, labels, extra, T0)
    full, _ = batches(tokens, labels, extra, T)
    prefill = model.prefill
    decode = model.decode_step
    loss = model.loss
    if dtype == "float32":
        prefill = jax.jit(prefill, static_argnames=("max_len",))
        decode, loss = jax.jit(decode), jax.jit(loss)
    with jax.disable_jit(dtype != "float32"):
        logits, cache = prefill(params, pre, max_len=T)
        out = {"prefill": np.asarray(logits, np.float32),
               "cache": numpy_tree(cache), "decode": []}
        for i in range(T0, T):
            logits, cache = decode(params, jnp.asarray(tokens[:, i:i + 1]),
                                   cache)
            out["decode"].append(np.asarray(logits, np.float32))
        total, metrics = loss(params, full)
    out.update(loss=float(total), ce=float(metrics["ce"]),
               aux=float(metrics["aux"]), params=numpy_tree(params),
               config=config, tokens=tokens, labels=labels, extra=extra)
    return out


@pytest.fixture(scope="module")
def run_of():
    """The reference's run of each (config, dtype), made once a module."""
    runs = {}

    def get(name, dtype):
        if (name, dtype) not in runs:
            runs[name, dtype] = reference_run(name, dtype)
        return runs[name, dtype]

    return get


def close(want, got: torch.Tensor, dtype: str):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)


def port_model(ref):
    model = build_model(ref["config"], device=CPU)
    params = model.load_params(interop.lm_params_from_numpy(
        ref["params"], ref["config"], device=CPU))
    return model, params


def cache_leaves(cache):
    """(path, leaf) of a cache: tensors (or numpy arrays) and lengths."""
    return cm.tree_leaves_with_path(
        cache, lambda x: isinstance(x, (torch.Tensor, np.ndarray, int)))


def close_caches(want, got, dtype: str) -> None:
    """Every leaf of the reference's numpy cache against the port's: the
    same paths, floats within ``TOL[dtype]``, each stacked length equal
    to the port's one int."""
    want, got = cache_leaves(want), cache_leaves(got)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        if isinstance(b, int):
            assert path.endswith("length") and (a == b).all(), path
        else:
            assert a.shape == tuple(b.shape), path
            close(a, b, dtype)


def check_against_the_reference(ref, dtype: str) -> None:
    """The port with ``ref``'s weights against ``ref``'s run: prefill
    logits and cache, 4 decode steps, the loss and its aux term."""
    model, params = port_model(ref)
    _, pre = batches(ref["tokens"], ref["labels"], ref["extra"], T0)
    _, full = batches(ref["tokens"], ref["labels"], ref["extra"], T)
    logits, cache = model.prefill(params, pre, max_len=T)
    assert logits.dtype == ref["config"].dtype
    close(ref["prefill"], logits, dtype)
    close_caches(ref["cache"], cache, dtype)
    tokens = ref["tokens"]
    for i, want in zip(range(T0, T), ref["decode"]):
        logits, cache = model.decode_step(
            params, torch.as_tensor(tokens[:, i:i + 1]), cache)
        close(want, logits, dtype)
        if dtype == "float32":
            assert (logits.argmax(-1).numpy() == want.argmax(-1)).all()
    total, metrics = model.loss(params, full)
    tol = TOL[dtype]
    assert abs(float(metrics["ce"]) - ref["ce"]) <= tol + tol * abs(ref["ce"])
    assert abs(float(total) - ref["loss"]) <= tol + tol * abs(ref["loss"])
    assert abs(float(metrics["aux"]) - ref["aux"]) <= tol + tol * ref["aux"]
    assert (ref["aux"] > 0) == (ref["config"].family == "moe")


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", DECODERS + ("seamless-m4t-large-v2",))
def test_prefill_decode_and_loss_match_the_reference(run_of, name, dtype):
    check_against_the_reference(run_of(name, dtype), dtype)


def test_padded_vocab_rows_are_masked():
    ref = reference_run("mistral-nemo-12b", "float32", vocab_size=500)
    assert ref["config"].padded_vocab == 512
    model, params = port_model(ref)
    _, pre = batches(ref["tokens"], ref["labels"], ref["extra"], T0)
    logits, _ = model.prefill(params, pre, max_len=T)
    assert (logits[..., 500:] == -1e30).all()
    assert (ref["prefill"][..., 500:] == -1e30).all()
    close(ref["prefill"], logits, "float32")
    _, full = batches(ref["tokens"], ref["labels"], ref["extra"], T)
    total, _ = model.loss(params, full)
    assert abs(float(total) - ref["loss"]) <= 1e-4 + 1e-4 * ref["loss"]


def check_decode_from_the_reference_cache(ref, name: str) -> None:
    """A decode step from ``ref``'s prefill cache carried across
    (``interop.lm_cache_from_numpy``), against the reference's step."""
    model, params = port_model(ref)
    cache = interop.lm_cache_from_numpy(ref["cache"], ref["config"],
                                        device=CPU)
    close_caches(ref["cache"], cache, "float32")
    # ref["cache"] is the reference prefill's cache: decode one step on
    ref_model = ref_build(pair(name, "float32")[0])
    ref_params = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    ref_cache = jax.tree_util.tree_map(jnp.asarray, ref["cache"])
    token = np.full((B, 1), 7, np.int32)
    want, ref_cache = jax.jit(ref_model.decode_step)(
        ref_params, jnp.asarray(token), ref_cache)
    got, cache = model.decode_step(params, torch.as_tensor(token), cache)
    close(np.asarray(want, np.float32), got, "float32")
    close_caches(numpy_tree(ref_cache), cache, "float32")


@pytest.mark.parametrize("name", ["yi-6b", "seamless-m4t-large-v2"])
def test_decode_from_the_reference_prefill_cache(run_of, name):
    check_decode_from_the_reference_cache(run_of(name, "float32"), name)


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_arch("olmo-1b").smoke_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(get_arch("olmo-1b").smoke_config(),
           mesh=Mesh(np.array([[0]]), ("data", "model")))
    mesh = Mesh(np.array([[0]]), ("data", "model"), device=CPU)
    assert LM(get_arch("olmo-1b").smoke_config(), mesh=mesh).device == \
        torch.device(CPU)


def test_a_decode_step_consumes_its_cache():
    """The step writes into the cache it is given (in place) and returns
    the same tensors with the new length; decoding past the capacity
    raises (the reference clamps its write to the last positions)."""
    config = get_arch("yi-6b").smoke_config().replace(
        dtype=torch.float32)
    model = build_model(config, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, config.vocab_size, (B, 5),
                           generator=torch.Generator().manual_seed(1))
    _, cache = model.prefill(params, {"tokens": tokens}, max_len=6)
    given = cache["unit"][0]
    before = given.k.clone()
    _, out = model.decode_step(params, tokens[:, :1], cache)
    got = out["unit"][0]
    assert got.k is given.k and got.v is given.v
    assert given.length == 5 and got.length == 6
    assert not torch.equal(given.k[:, :, 5], before[:, :, 5])
    assert torch.equal(given.k[:, :, :5], before[:, :, :5])
    with pytest.raises(ValueError, match="past the cache"):
        model.decode_step(params, tokens[:, :1], out)


@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_a_decode_step_updates_its_states_in_place(name):
    """Recurrent states (``SSMState``, ``SLSTMState``), the shared block's
    caches and the decoder's cross K/V: the step copies its new states
    into the tensors of the cache it is given and returns those same
    tensors (cross K/V unchanged), as it writes K/V."""
    config = get_arch(name).smoke_config()
    model = build_model(config, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    gen_ = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, config.vocab_size, (B, 5), generator=gen_)
    batch = {"tokens": tokens}
    if config.frontend == "audio_stub":
        batch["frame_embeds"] = torch.randn((B, 4, config.d_model),
                                            generator=gen_)
    _, cache = model.prefill(params, batch, max_len=6)
    given = cache_leaves(cache)
    before = {p: t.clone() for p, t in given if isinstance(t, torch.Tensor)}
    _, out = model.decode_step(params, tokens[:, :1], cache)
    kinds = {type(c) for c in cache["unit"]}
    assert kinds == {"xlstm-125m": {SSMState, SLSTMState},
                     "zamba2-2.7b": {SSMState},
                     "seamless-m4t-large-v2": {dict}}[name]
    assert isinstance(model, Seq2Seq) == (name == "seamless-m4t-large-v2")
    changed = set()
    for (path, a), (_, b) in zip(given, cache_leaves(out)):
        if isinstance(a, int):
            assert path.endswith("length") and (a, b) == (5, 6), path
            continue
        assert b is a, path
        if not torch.equal(a, before[path]):
            changed.add(path.split(".")[-1])
    assert changed == {"xlstm-125m": {"conv", "ssd", "h", "c", "n", "m"},
                       "zamba2-2.7b": {"conv", "ssd", "k", "v"},
                       "seamless-m4t-large-v2": {"k", "v"}}[name]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_build_model_builds_every_arch(name):
    """All ten archs at full size on the CPU, parameters on ``meta``
    (nothing drawn): the reference's class and every leaf of the specs."""
    config = ARCHS[name].config
    model = build_model(config, device=CPU)
    assert type(model).__name__ == type(ref_build(
        ref_get_arch(name).config)).__name__
    specs = dict(cm.tree_leaves_with_path(model.param_specs(), cm.is_spec))
    state = model.state_dict()
    assert sorted(state) == sorted(specs)
    for path, t in state.items():
        assert t.device.type == "meta" and tuple(t.shape) == \
            specs[path].shape and t.dtype == config.param_dtype, path


def test_state_dict_keys_are_the_reference_paths(run_of):
    ref = run_of("stablelm-1.6b", "float32")
    model, params = port_model(ref)
    paths = [p for p, _ in cm.tree_leaves_with_path(
        ref["params"], lambda x: isinstance(x, np.ndarray))]
    state = model.state_dict()
    assert sorted(state) == sorted(paths)
    for path, leaf in cm.tree_leaves_with_path(
            ref["params"], lambda x: isinstance(x, np.ndarray)):
        np.testing.assert_array_equal(state[path].numpy(), leaf)
    assert state["backbone.unit.0.attn.wq"].shape[0] == \
        ref["config"].n_layers


def test_params_from_numpy_check_the_tree(run_of):
    ref = run_of("olmo-1b", "float32")
    config = ref["config"]
    tree = ref["params"]
    good = interop.lm_params_from_numpy(tree, config, device=CPU)
    assert all(t.dtype == torch.float32 for _, t in
               cm.tree_leaves_with_path(good, torch.is_tensor))
    bf16 = interop.lm_params_from_numpy(
        tree, config.replace(param_dtype=torch.bfloat16), device=CPU)
    wq = tree["backbone"]["unit"][0]["attn"]["wq"]
    assert torch.equal(bf16["backbone"]["unit"][0]["attn"]["wq"],
                       torch.from_numpy(wq.copy()).to(torch.bfloat16))
    missing = {"embed": {}, "backbone": tree["backbone"]}
    extra = {**tree, "more": {"w": np.zeros(2, np.float32)}}
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["embed"]["tok_embed"] = np.zeros((3, 3), np.float32)
    for broken, what in ((missing, "missing"), (extra, "extra"),
                         (bad, "misshapen")):
        with pytest.raises(ValueError, match=what):
            interop.lm_params_from_numpy(broken, config, device=CPU)
    as_f64 = jax.tree_util.tree_map(lambda a: a.astype(np.float64), tree)
    with pytest.raises(TypeError):
        interop.lm_params_from_numpy(as_f64, config, device=CPU)


def test_init_draws_each_leaf_in_its_type():
    config = ARCHS["mistral-nemo-12b"].smoke_config().replace(
        param_dtype=torch.bfloat16, n_layers=3)
    model = build_model(config, device=CPU)
    assert all(p.device.type == "meta" for p in model.parameters())
    params = model.init(torch.Generator().manual_seed(0))
    again = build_model(config, device=CPU).init(
        torch.Generator().manual_seed(0))
    specs = model.param_specs()
    for (path, spec), (_, t), (_, u) in zip(
            cm.tree_leaves_with_path(specs, cm.is_spec),
            cm.tree_leaves_with_path(params, torch.is_tensor),
            cm.tree_leaves_with_path(again, torch.is_tensor)):
        assert tuple(t.shape) == spec.shape and t.dtype == torch.bfloat16
        assert torch.equal(t, u), path          # seeded: reproducible
        if spec.init == "ones":
            assert (t == 1).all()
        elif spec.init == "normal":
            std = float(t.float().std())
            assert 0.8 * spec.scale < std < 1.2 * spec.scale, path
    # a stacked leaf is drawn one layer at a time: its layers differ
    wq = params["backbone"]["unit"][0]["attn"]["wq"]
    assert not torch.equal(wq[0], wq[1])


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_backbone_with_a_prefix_and_a_shared_block(mode):
    """An unrolled prefix and a shared block around a two-block unit of
    attention blocks (a plan of no arch) against the reference's
    backbone, float32."""
    ref_config, config = pair("yi-6b", "float32")
    plan = ref_tfm.LayerPlan(("attn_mlp",), ("attn_mlp", "attn_mlp"), 2,
                             "attn_mlp")
    port_plan = tfm.LayerPlan(*plan)
    specs = ref_tfm.backbone_specs(ref_config, plan)
    leaves, treedef = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: hasattr(x, "logical_axes"))
    rng = np.random.default_rng(3)
    arrays = [(rng.standard_normal(s.shape) * 0.2).astype(np.float32)
              for s in leaves]
    ref_params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in arrays])
    params = cm.tree_map(torch.from_numpy, jax.tree_util.tree_unflatten(
        treedef, arrays), lambda x: isinstance(x, np.ndarray))
    x = rng.standard_normal((B, T0, 64)).astype(np.float32)
    ref_ctx = ref_tfm.BlockCtx(config=ref_config, mesh=None, mode="prefill",
                               positions=jnp.arange(T0), max_cache_len=T)
    port_ctx = tfm.BlockCtx(config=config, mode="prefill",
                            positions=torch.arange(T0), max_cache_len=T)
    want, ref_cache, _ = jax.jit(lambda p, x: ref_tfm.backbone_apply(
        p, x, ref_ctx, plan=plan))(ref_params, jnp.asarray(x))
    got, cache, _ = tfm.backbone_apply(params, torch.from_numpy(x), port_ctx,
                                       plan=port_plan)
    if mode == "decode":
        y = rng.standard_normal((B, 1, 64)).astype(np.float32)
        ref_ctx = ref_ctx._replace(mode="decode", positions=None)
        port_ctx = port_ctx._replace(mode="decode", positions=None)
        want, ref_cache, _ = jax.jit(lambda p, x, c: ref_tfm.backbone_apply(
            p, x, ref_ctx, c, plan=plan))(ref_params, jnp.asarray(y),
                                          ref_cache)
        got, cache, _ = tfm.backbone_apply(params, torch.from_numpy(y),
                                           port_ctx, cache, plan=port_plan)
    close(np.asarray(want), got, "float32")
    for key in ("prefix", "unit"):
        for a, b in zip(ref_cache[key], cache[key]):
            assert isinstance(b, KVCache)
            close(np.asarray(a.k), b.k, "float32")
            close(np.asarray(a.v), b.v, "float32")
            assert (np.asarray(a.length) == b.length).all()
    close(np.asarray(ref_cache["shared"].k), cache["shared"].k, "float32")
    assert cache["shared"].length == int(np.asarray(
        ref_cache["shared"].length)[0])


def test_decode_from_an_empty_cache_matches_the_reference(run_of):
    """``init_cache`` (zeros, length 0), then 3 decode steps."""
    ref = run_of("olmo-1b", "float32")
    model, params = port_model(ref)
    ref_model = ref_build(pair("olmo-1b", "float32")[0])
    ref_params = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    ref_cache = ref_model.init_cache(B, 5)
    cache = model.init_cache(B, 5)
    assert cache["unit"][0].k.shape == ref_cache["unit"][0].k.shape
    assert cache["unit"][0].length == 0
    step = jax.jit(ref_model.decode_step)
    for i in range(3):
        token = ref["tokens"][:, i:i + 1]
        want, ref_cache = step(ref_params, jnp.asarray(token), ref_cache)
        got, cache = model.decode_step(params, torch.as_tensor(token), cache)
        close(np.asarray(want, np.float32), got, "float32")
    assert cache["unit"][0].length == 3
