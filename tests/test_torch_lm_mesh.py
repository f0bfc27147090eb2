"""The LM on a mesh of 4 gloo ranks against the JAX package's.

One ``torch.multiprocessing`` spawn of 4 gloo ranks on the CPU (one
process a rank, a FileStore under the test's temporary directory, its
own timeout) runs every case below on ``(2, 2)`` and ``(1, 4)``
``(data, model)`` meshes, each rank writing what it saw; each case is a
test here.  For one smoke config of each family under its training
profile, its serving profile and, for olmo-1b, ``tp_sp`` (and ``fsdp``
on a batch of 2, which leaves ``model`` to tensor parallelism), in
float32, from one numpy state: the loss, the grad norm, the parameters
after one step (AdamW's ``eps`` at 1e-4, see ``OPT``), the prefill's
logits and 4 decode steps' logits, against the reference run without a
mesh (under ``jax.jit``) at 1e-4; each rank's parameters,
moments and cache tensors have exactly their block's shapes.  Also: the
MoE drops token for token (the mesh's ``keep`` equals the mesh-less
port's, which ``check_drops`` holds against the reference's);
``train_loop(mesh=...)`` resumed from its checkpoint ends bit for bit
where the straight run does; a checkpoint written on the mesh restores
in the reference and in the mesh-less port, and one written without a
mesh restores on it; a save on the mesh holds one gathered leaf at a
time, and only the mesh's first rank copies the leaves to the host.  A subprocess runs the reference on a 4-device host
mesh (``make_host_mesh(2)``) for the dense, moe and audio cases and pins
that its mesh and the port's agree.
"""
import datetime
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.runtime import mesh as rt  # noqa: E402
from repro_torch.runtime.mesh import AbstractMesh, Mesh  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.step import (TrainState,  # noqa: E402
                                    train_state_shardings)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT_S = 240
REFERENCE_TIMEOUT_S = 240
TOL = 1e-4
T, T0, FRAMES = 16, 8, 6       # tokens, prompt (then 4 decode steps)
# eps 1e-4: AdamW's first update is g / (|g| + eps), which with the
# default 1e-8 moves a coordinate whose float32 gradient cancels to ~1e-8
# by up to the whole lr either way (tests/test_torch_train_step.py)
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10, eps=1e-4)
LOOP = dict(steps=4, batch=4, seq=16, checkpoint_every=2, log_every=0,
            opt=OptConfig(warmup_steps=1, decay_steps=4))

# (id, arch, profile, mesh shape, batch)
CASES = [
    ("olmo-fsdp", "olmo-1b", "fsdp", (2, 2), 4),
    ("olmo-fsdp-b2", "olmo-1b", "fsdp", (2, 2), 2),
    ("olmo-tp", "olmo-1b", "tp", (1, 4), 4),
    ("olmo-tp_sp", "olmo-1b", "tp_sp", (2, 2), 4),
    ("llava-fsdp", "llava-next-34b", "fsdp", (1, 4), 4),
    ("llava-ep", "llava-next-34b", "ep", (2, 2), 4),
    ("deepseek-ep", "deepseek-moe-16b", "ep", (2, 2), 4),
    ("arctic-ep_fsdp", "arctic-480b", "ep_fsdp", (2, 2), 4),
    ("xlstm-fsdp", "xlstm-125m", "fsdp", (2, 2), 4),
    ("xlstm-tp", "xlstm-125m", "tp", (1, 4), 4),
    ("zamba2-fsdp", "zamba2-2.7b", "fsdp", (1, 4), 4),
    ("zamba2-tp", "zamba2-2.7b", "tp", (2, 2), 4),
    ("seamless-fsdp", "seamless-m4t-large-v2", "fsdp", (2, 2), 4),
    ("seamless-tp", "seamless-m4t-large-v2", "tp", (1, 4), 4),
]
BY_ID = {c[0]: c for c in CASES}
# the cases the reference also runs on its 4-device host mesh
REF_MESH_CASES = ("olmo-fsdp", "deepseek-ep", "seamless-fsdp")
MOE_CASES = ("deepseek-ep", "arctic-ep_fsdp")


def port_config(arch: str, profile: str):
    return get_arch(arch).smoke_config().replace(
        dtype=torch.float32, param_dtype=torch.float32,
        sharding_profile=profile)


def make_inputs(config, b: int, seed: int = 0) -> dict:
    """A training batch (with a loss mask that differs between the
    shards), a prompt of ``T0`` tokens and 4 decode tokens, numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, config.vocab_size, (b, T)).astype(
        np.int32),
        "labels": rng.integers(0, config.vocab_size, (b, T)).astype(np.int32),
        "loss_mask": (rng.random((b, T)) < 0.7).astype(np.float32)}
    if config.frontend == "patch_stub":
        out["patch_embeds"] = rng.standard_normal(
            (b, config.n_frontend_tokens, config.d_model)).astype(np.float32)
    if config.frontend == "audio_stub":
        out["frame_embeds"] = rng.standard_normal(
            (b, FRAMES, config.d_model)).astype(np.float32)
    return out


def prompt_batch(inputs: dict) -> dict:
    out = {k: v for k, v in inputs.items() if k not in ("labels",
                                                        "loss_mask")}
    out["tokens"] = inputs["tokens"][:, :T0]
    return out


def _save(path, out: dict) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


def _load(path) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def _tree(flat: dict, prefix: str, like):
    """The tree of ``like``'s structure from ``flat``'s ``prefix|path``
    arrays."""
    return cm.tree_map_with_path(lambda p, _: flat[f"{prefix}|{p}"], like,
                                 lambda x: hasattr(x, "shape"))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _whole(tree, shardings, mesh) -> dict:
    sh = dict(cm.tree_leaves_with_path(
        shardings, lambda x: isinstance(x, cm.Sharding)))
    return {p: cm.relayout(t.detach(), mesh, sh[p].layout(t.dim()),
                           ((),) * t.dim()).numpy()
            for p, t in cm.tree_leaves_with_path(tree, torch.is_tensor)}


def _blocks_ok(tree, shardings, specs) -> bool:
    sh = dict(cm.tree_leaves_with_path(
        shardings, lambda x: isinstance(x, cm.Sharding)))
    spec = dict(cm.tree_leaves_with_path(specs, cm.is_spec))
    return all(tuple(t.shape) == sh[p].shard_shape(spec[p].shape)
               for p, t in cm.tree_leaves_with_path(tree, torch.is_tensor))


def _cache_blocks_ok(model, cache, batch: int, max_len: int) -> bool:
    whole = tfm.init_cache(model.config, batch, max_len,
                           getattr(model, "dec_plan", None) or model.plan,
                           "meta", FRAMES)
    shardings = tfm.resolve_cache_shardings(
        tfm.cache_shardings(model.config, model.mesh,
                            getattr(model, "dec_plan", None) or model.plan),
        whole)
    sh = dict(cm.tree_leaves_with_path(
        shardings, lambda x: isinstance(x, cm.Sharding)))
    have = {p: t for p, t in cm.tree_leaves_with_path(
        cache, lambda x: isinstance(x, (torch.Tensor, int)))
        if isinstance(t, torch.Tensor)}
    return all(tuple(have[p].shape) == sh[p].shard_shape(t.shape)
               for p, t in cm.tree_leaves_with_path(
                   whole, lambda x: isinstance(x, (torch.Tensor, int)))
               if isinstance(t, torch.Tensor))


def _torch_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _record_keeps(model, seen: list, n_tokens: int):
    """Wrap ``mlp.dispatch`` to record each MoE layer's ``keep``, whole
    over the mesh's groups (``n_tokens``: the whole batch's)."""
    dispatch = mlp.dispatch

    def recording(xg, probs_g, config, C):
        out = dispatch(xg, probs_g, config, C)
        groups = mlp.moe_groups(n_tokens, config)
        grp = model.place.layout((groups, xg.shape[1]), "moe_group", None)[0]
        # the recording's own gather is not the step's collective
        counted = {k: list(v) for k, v in rt.COLLECTIVES.items()}
        keep = cm.relayout(out[3].to(torch.uint8), model.mesh, (grp, ()),
                           ((), ()))
        rt.COLLECTIVES.clear()
        rt.COLLECTIVES.update(counted)
        seen.append(keep.numpy().astype(bool))
        return out

    return dispatch, recording


def run_case(case, arrays: dict, results: dict) -> None:
    cid, arch, profile, shape, b = case
    config = port_config(arch, profile)
    mesh = Mesh(np.arange(WORLD).reshape(shape), ("data", "model"),
                device="cpu")
    inputs = {k[len(f"{arch}|{b}|in|"):]: v for k, v in arrays.items()
              if k.startswith(f"{arch}|{b}|in|")}
    model = build_model(config, mesh)
    specs = model.param_specs()
    params0 = _tree(arrays, f"{arch}|{b}|params", specs)
    zeros = cm.tree_map(np.zeros_like, params0, lambda x: hasattr(x, "shape"))
    state = interop.train_state_from_numpy(
        (params0, {"m": zeros, "v": zeros, "step": np.int32(0)}), config,
        OptConfig(**OPT), mesh=mesh)
    results[f"{cid}|blocks"] = (
        _blocks_ok(state.params, model.shardings, specs)
        and _blocks_ok(state.opt["m"], model.shardings, specs)
        and _blocks_ok(state.opt["v"], model.shardings, specs))
    batch = _torch_batch(inputs)
    seen = []
    if config.n_experts:
        dispatch, recording = _record_keeps(model, seen, b * T)
        mlp.dispatch = recording
    rt.reset_collective_stats()
    try:
        new, metrics = make_train_step(model, OptConfig(**OPT))(state, batch)
    finally:
        if config.n_experts:
            mlp.dispatch = dispatch
    for kind, stats in rt.collective_stats().items():
        for key, value in stats.items():
            results[f"{cid}|collectives|{kind}|{key}"] = value
    for i, keep in enumerate(seen):
        results[f"{cid}|keep{i}"] = keep
    results[f"{cid}|loss"] = float(metrics["loss"])
    results[f"{cid}|grad_norm"] = float(metrics["grad_norm"])
    for path, a in _whole(new.params, model.shardings, mesh).items():
        results[f"{cid}|param|{path}"] = a
    results[f"{cid}|blocks"] &= _blocks_ok(new.opt["v"], model.shardings,
                                          specs)
    params = model.load_params(
        cm.tree_map(torch.as_tensor, params0, lambda x: hasattr(x, "shape")))
    vp = config.padded_vocab
    with torch.no_grad():
        logits, cache = model.prefill(
            params, _torch_batch(prompt_batch(inputs)), max_len=T)
        results[f"{cid}|cache_blocks"] = _cache_blocks_ok(model, cache, b, T)
        results[f"{cid}|prefill"] = model.whole(
            logits, (b, 1, vp), "batch", None, "vocab").numpy()
        for i in range(4):
            tok = torch.as_tensor(inputs["tokens"][:, T0 + i:T0 + i + 1])
            logits, cache = model.decode_step(params, tok, cache)
            results[f"{cid}|decode{i}"] = model.whole(
                logits, (b, 1, vp), "batch", None, "vocab").numpy()
        results[f"{cid}|cache_blocks"] &= _cache_blocks_ok(model, cache, b,
                                                           T)


def run_loop(out_dir: str, results: dict) -> None:
    """``train_loop`` on a (2, 2) mesh: straight, and stopped then resumed
    from its checkpoint; and a mesh-less checkpoint restored on it."""
    from repro_torch.launch.train import train_loop
    config = get_arch("olmo-1b").smoke_config().replace(
        sharding_profile="fsdp")
    mesh = Mesh(np.arange(WORLD).reshape(2, 2), ("data", "model"),
                device="cpu")
    straight = train_loop(config, ckpt_dir=f"{out_dir}/straight", mesh=mesh,
                          **LOOP)["state"]
    train_loop(config, ckpt_dir=f"{out_dir}/resumed", mesh=mesh,
               **dict(LOOP, steps=2))
    resumed = train_loop(config, ckpt_dir=f"{out_dir}/resumed", mesh=mesh,
                         **LOOP)
    results["loop|steps_run"] = resumed["steps_run"]
    sh = train_state_shardings(build_model(config, mesh))
    for name, state in (("straight", straight), ("resumed",
                                                 resumed["state"])):
        for key, tree in (("params", state.params), ("m", state.opt["m"])):
            for path, a in _whole(tree, sh.params, mesh).items():
                results[f"loop|{name}|{key}|{path}"] = a
    restored, step = CheckpointManager(f"{out_dir}/meshless").restore(
        straight, device="cpu", shardings=sh)
    results["loop|meshless_step"] = step
    for key, tree in (("params", restored.params), ("v", restored.opt["v"])):
        for path, a in _whole(tree, sh.params, mesh).items():
            results[f"loop|meshless|{key}|{path}"] = a


def run_save(out_dir: str, results: dict) -> None:
    """A checkpoint save of a train state on a (2, 2) mesh with the
    gathers and the host copies watched: the most gathered leaves (and
    their bytes) alive at once on the rank, and the host copies it
    made."""
    import weakref
    from repro_torch.checkpoint import manager
    config = port_config("olmo-1b", "fsdp")
    mesh = Mesh(np.arange(WORLD).reshape(2, 2), ("data", "model"),
                device="cpu")
    state = interop.train_state_from_numpy(_numpy_state(config), config,
                                           OptConfig(**OPT), mesh=mesh)
    live, peak, copies = {}, [0, 0], [0]
    gather, to_host = manager._gather_leaf, manager._to_host

    def watched_gather(leaf, sharding):
        out = gather(leaf, sharding)
        live[id(out)] = out.numel() * out.element_size()
        weakref.finalize(out, live.pop, id(out), None)
        peak[0] = max(peak[0], len(live))
        peak[1] = max(peak[1], sum(live.values()))
        return out

    def counted_to_host(leaf):
        copies[0] += 1
        return to_host(leaf)

    manager._gather_leaf, manager._to_host = watched_gather, counted_to_host
    try:
        CheckpointManager(f"{out_dir}/save", async_save=False).save(
            1, state, shardings=train_state_shardings(
                build_model(config, mesh)))
    finally:
        manager._gather_leaf, manager._to_host = gather, to_host
    specs = build_model(config, device="meta").param_specs()
    results["save|live_leaves_max"] = peak[0]
    results["save|live_bytes_max"] = peak[1]
    results["save|largest_leaf_bytes"] = max(
        int(np.prod(s.shape)) * 4 for _, s in cm.tree_leaves_with_path(
            specs, cm.is_spec))
    results["save|host_copies"] = copies[0]
    results["save|leaves"] = len(cm.tree_leaves_with_path(
        state, torch.is_tensor))


def run_extras(results: dict) -> None:
    """The collectives and ``constrain`` on a (2, 2) mesh, including an
    axis order that is not the mesh's; ``init`` on a mesh against
    without; remat on a mesh; a decode past a sharded cache's capacity;
    a cache carried onto the mesh by ``interop.lm_cache_from_numpy``."""
    from repro_torch.runtime import mesh as rt
    mesh = Mesh(np.arange(WORLD).reshape(2, 2), ("data", "model"),
                device="cpu")
    rank = dist.get_rank()
    x = torch.arange(6.0).reshape(2, 3) + 10 * rank
    for axes in (("model",), ("data", "model"), ("model", "data")):
        name = ",".join(axes)
        results[f"x|all_reduce|{name}"] = rt.all_reduce(x, mesh, axes)
        results[f"x|all_gather|{name}"] = rt.all_gather(x, mesh, axes, 1)
        results[f"x|reduce_scatter|{name}"] = rt.reduce_scatter(
            torch.arange(8.0) + rank, mesh, axes, 0)
    config = port_config("olmo-1b", "tp")
    whole = torch.arange(4 * 3 * 8.0).reshape(4, 3, 8)
    block = cm.constrain(whole, mesh, config, "batch", None, "vocab")
    results["x|constrain_block"] = block
    results["x|constrain_back"] = cm.constrain(
        block, mesh, config, None, None, None,
        layout=(("data",), (), ("model",)))
    for arch, profile in (("olmo-1b", "tp"), ("deepseek-moe-16b", "ep")):
        config = port_config(arch, profile)
        model = build_model(config, mesh)
        got = _whole(model.init(torch.Generator().manual_seed(3)),
                     model.shardings, mesh)
        want = build_model(config, device="cpu").init(
            torch.Generator().manual_seed(3))
        results[f"x|init_equal|{arch}"] = all(
            np.array_equal(got[p], t.numpy())
            for p, t in cm.tree_leaves_with_path(want, torch.is_tensor))
    outs = {}
    for remat in ("none", "full"):
        config = port_config("olmo-1b", "fsdp").replace(remat=remat)
        model = build_model(config, mesh)
        state = interop.train_state_from_numpy(
            _numpy_state(config), config, OptConfig(**OPT), mesh=mesh)
        batch = _torch_batch(make_inputs(config, 4))
        outs[remat] = _whole(make_train_step(model, OptConfig(**OPT))(
            state, batch)[0].params, model.shardings, mesh)
    results["x|remat_bit_for_bit"] = all(
        np.array_equal(outs["none"][p], outs["full"][p]) for p in outs["none"])
    config = port_config("llava-next-34b", "ep")
    model = build_model(config, mesh)
    params = model.init(torch.Generator().manual_seed(4))
    inputs = make_inputs(config, 4)
    prompt = _torch_batch(prompt_batch(inputs))
    with torch.no_grad():
        _, cache = model.prefill(params, prompt, max_len=T0)
        try:
            model.decode_step(params, prompt["tokens"][:, :1], cache)
            results["x|past_capacity_raises"] = False
        except ValueError:
            results["x|past_capacity_raises"] = True
        plain = build_model(config, device="cpu")
        _, plain_cache = plain.prefill(plain.init(
            torch.Generator().manual_seed(4)), prompt, max_len=T)
        _, cache = model.prefill(params, prompt, max_len=T)
    carried = interop.lm_cache_from_numpy(
        cm.tree_map(lambda t: t.float().numpy() if torch.is_tensor(t)
                    else np.full((model.plan.n_repeat,), t),
                    plain_cache, lambda x: isinstance(x, (torch.Tensor,
                                                          int))),
        config, mesh=mesh)
    results["x|kv_heads_and_positions_sharded"] = _kv_in_place(mesh)
    got = dict(cm.tree_leaves_with_path(cache, torch.is_tensor))
    results["x|cache_carried"] = all(
        torch.allclose(t, got[p], atol=1e-5, rtol=1e-5)
        if torch.is_tensor(t) else t == got[p]
        for p, t in cm.tree_leaves_with_path(carried, torch.is_tensor))


def _kv_in_place(mesh) -> bool:
    """nemo's smoke config with 2 KV heads under ``tp``: its KV heads are
    computed in place, its cache's positions sharded (the smoke configs
    of the ``shard_cache_seq`` archs have one KV head); a prefill and 4
    decode steps within 1e-4 of no mesh."""
    config = port_config("mistral-nemo-12b", "tp").replace(n_kv_heads=2)
    model, plain = build_model(config, mesh), build_model(config,
                                                          device="cpu")
    params = model.init(torch.Generator().manual_seed(5))
    plain_params = plain.init(torch.Generator().manual_seed(5))
    tokens = torch.as_tensor(make_inputs(config, 4)["tokens"])
    shape = (4, 1, config.padded_vocab)
    with torch.no_grad():
        got, cache = model.prefill(params, {"tokens": tokens[:, :T0]},
                                   max_len=T)
        want, plain_cache = plain.prefill(plain_params,
                                          {"tokens": tokens[:, :T0]},
                                          max_len=T)
        close = [torch.allclose(model.whole(got, shape, "batch", None,
                                            "vocab"), want, atol=TOL,
                                rtol=TOL)]
        for i in range(T0, T0 + 4):
            got, cache = model.decode_step(params, tokens[:, i:i + 1], cache)
            want, plain_cache = plain.decode_step(
                plain_params, tokens[:, i:i + 1], plain_cache)
            close.append(torch.allclose(model.whole(
                got, shape, "batch", None, "vocab"), want, atol=TOL,
                rtol=TOL))
    return all(close)


def _numpy_state(config):
    params = _tree_of(numpy_params(config),
                      build_model(config, device="meta").param_specs())
    zeros = cm.tree_map(np.zeros_like, params, lambda x: hasattr(x, "shape"))
    return params, {"m": zeros, "v": zeros, "step": np.int32(0)}


def _tree_of(flat: dict, specs):
    return cm.tree_map_with_path(lambda p, _: flat[p], specs, cm.is_spec)


def _rank_main(rank: int, world: int, store: str, job: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    try:
        arrays = _load(job["inputs"])
        results = {}
        for case in CASES:
            run_case(case, arrays, results)
        run_loop(job["out"], results)
        run_save(job["out"], results)
        run_extras(results)
        _save(os.path.join(job["out"], f"rank{rank}.npz"), results)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference, without a mesh and on a 4-device mesh (subprocesses)
# ---------------------------------------------------------------------------

def ref_config_of(arch: str, profile: str = "tp"):
    import jax.numpy as jnp
    from repro.configs import get_arch as ref_get_arch
    return ref_get_arch(arch).smoke_config().replace(
        dtype=jnp.float32, param_dtype=jnp.float32, sharding_profile=profile)


def numpy_params(config, seed: int = 1):
    """path -> parameter, drawn by the specs with numpy in the trees'
    leaf order (the port's specs are the reference's,
    ``test_torch_lm_configs``)."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        return (rng.standard_normal(spec.shape) * spec.scale).astype(
            np.float32)

    made = {p: draw(s) for p, s in cm.tree_leaves_with_path(
        build_model(config, device="meta").param_specs(), cm.is_spec)}
    return made


def reference_run(config, params, inputs: dict, mesh=None) -> dict:
    """The reference's step (loss, grad norm, parameters after it),
    prefill and 4 decode steps of ``config``; on a ``mesh`` the loss in
    place of the step."""
    import jax
    import jax.numpy as jnp
    from repro.models import common as ref_cm
    from repro.models.model import build_model as ref_build
    from repro.optim.adamw import OptConfig as RefOptConfig
    from repro.train.step import TrainState, make_train_step as ref_make
    model = ref_build(config, mesh)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    if mesh is not None:
        p = jax.device_put(p, ref_cm.shardings_for(model.param_specs(),
                                                   config, mesh))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, p)
    state = TrainState(p, {"m": zeros, "v": zeros, "step": jnp.int32(0)})
    batch = {k: jnp.asarray(v) for k, v in inputs.items()}
    if mesh is not None:
        out = {"loss": float(jax.jit(model.loss)(p, batch)[0])}
    else:
        new, metrics = jax.jit(ref_make(model, RefOptConfig(**OPT)))(state,
                                                                     batch)
        out = {"loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"])}
        for path, a in jax.tree_util.tree_leaves_with_path(new.params):
            out[f"param|{_key(path)}"] = np.asarray(a, np.float32)
    prefill = jax.jit(model.prefill, static_argnames=("max_len",))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(p, {k: jnp.asarray(v) for k, v in
                                prompt_batch(inputs).items()}, max_len=T)
    out["prefill"] = np.asarray(logits, np.float32)
    for i in range(4):
        tok = jnp.asarray(inputs["tokens"][:, T0 + i:T0 + i + 1])
        logits, cache = decode(p, tok, cache)
        out[f"decode{i}"] = np.asarray(logits, np.float32)
    return out


def _key(path) -> str:
    """A JAX key path as the port's dotted path."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def reference_main(inputs_file: str, out_file: str, runs: str) -> None:
    """The reference's runs named in ``runs`` (``id,id``: a case id runs
    on a 4-device host mesh, ``make_host_mesh(2)``, an ``arch|batch``
    without a mesh), in a subprocess; saved as ``<run>|<key>``."""
    import jax
    from repro.launch.mesh import make_host_mesh
    from repro.models.model import build_model as ref_build
    arrays = _load(inputs_file)
    out = {}
    for run in runs.split(","):
        if run in BY_ID:
            _, arch, profile, _, b = BY_ID[run]
            mesh = make_host_mesh(2)
            assert len(jax.devices()) == WORLD
        else:
            arch, b = run.split("|")
            profile, mesh = "tp", None
        config = ref_config_of(arch, profile)
        prefix = f"{arch}|{b}|"
        inputs = {k[len(prefix) + 3:]: v for k, v in arrays.items()
                  if k.startswith(prefix + "in|")}
        params = jax.tree_util.tree_map_with_path(
            lambda path, _: arrays[f"{prefix}params|{_key(path)}"],
            ref_build(config).param_specs(),
            is_leaf=lambda x: hasattr(x, "logical_axes"))
        for key, value in reference_run(config, params, inputs,
                                        mesh).items():
            out[f"{run}|{key}"] = value
    _save(out_file, out)


_REFERENCE = """
import sys
sys.path.insert(0, {tests!r})
import test_torch_lm_mesh as t
t.reference_main({inputs!r}, {out_file!r}, {runs!r})
"""


# ---------------------------------------------------------------------------
# the fixture: inputs, the spawn, the references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's results (``ranks``), the reference's runs
    (``reference``), the mesh-less port's MoE drops (``drops``) and the
    directory (``tmp``).  The ranks, three reference processes (the mesh
    runs, and the mesh-less runs split in two) and this process (the
    drops) run side by side."""
    from repro_torch.launch.train import train_loop
    tmp = tmp_path_factory.mktemp("lm_mesh")
    arrays, plain = {}, []
    for _, arch, _, _, b in CASES:
        if f"{arch}|{b}" in plain:
            continue
        plain.append(f"{arch}|{b}")
        config = port_config(arch, "tp")
        for path, a in numpy_params(config).items():
            arrays[f"{arch}|{b}|params|{path}"] = a
        for k, v in make_inputs(config, b).items():
            arrays[f"{arch}|{b}|in|{k}"] = v
    inputs = str(tmp / "inputs.npz")
    _save(inputs, arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    jobs = [",".join(REF_MESH_CASES), ",".join(plain[::2]),
            ",".join(plain[1::2])]
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE.format(
            tests=str(ROOT / "tests"), inputs=inputs,
            out_file=str(tmp / f"reference{i}.npz"), runs=job)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, job in enumerate(jobs)]
    ctx = None
    try:
        # a checkpoint written without a mesh, for the ranks to restore
        train_loop(get_arch("olmo-1b").smoke_config(), ckpt_dir=str(
            tmp / "meshless"), device="cpu", **dict(LOOP, steps=2))
        ctx = mp.start_processes(
            _rank_main, args=(WORLD, str(tmp / "store"),
                              {"inputs": inputs, "out": str(tmp)}),
            nprocs=WORLD, join=False, start_method="spawn")
        drops = {cid: mesh_less_drops(cid, arrays) for cid in MOE_CASES}
        _join(ctx, SPAWN_TIMEOUT_S)
        errors = [p.communicate(timeout=REFERENCE_TIMEOUT_S)[1]
                  for p in refs]
    finally:
        for p in refs:
            if p.poll() is None:
                p.kill()
        for p in (ctx.processes if ctx is not None else ()):
            if p.is_alive():
                p.kill()
            p.join(10)
    for p, err in zip(refs, errors):
        assert p.returncode == 0, err[-3000:]
    reference = {}
    for i in range(len(jobs)):
        reference.update(_load(tmp / f"reference{i}.npz"))
    ranks = [_load(tmp / f"rank{r}.npz") for r in range(WORLD)]
    return types.SimpleNamespace(ranks=ranks, reference=reference,
                                 drops=drops, tmp=tmp)


def mesh_less_drops(cid: str, arrays: dict):
    """The mesh-less port's ``keep`` of each MoE layer of ``cid``'s step,
    after ``check_drops`` held them against the reference's dispatch."""
    from test_torch_train_step import check_drops, moe_keeps
    _, arch, profile, _, b = BY_ID[cid]
    config = port_config(arch, profile)
    model = build_model(config, device="cpu")
    params = model.load_params(_tree(
        {k: torch.as_tensor(v) for k, v in arrays.items()},
        f"{arch}|{b}|params", model.param_specs()))
    inputs = {k[len(f"{arch}|{b}|in|"):]: v for k, v in arrays.items()
              if k.startswith(f"{arch}|{b}|in|")}
    batch = inputs
    check_drops(ref_config_of(arch), model,
                types.SimpleNamespace(params=params), batch)
    return [keep for _, _, keep in moe_keeps(model, params,
                                             _torch_batch(batch))]


def _join(ctx, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{WORLD} ranks still running after "
                               f"{timeout_s} s")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _want(reference: dict, cid: str) -> dict:
    _, arch, _, _, b = BY_ID[cid]
    prefix = f"{arch}|{b}|"
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_step_matches_the_reference(runs, cid):
    """Loss, grad norm and every parameter after one step on the mesh
    against the reference without one."""
    got, want = runs.ranks[0], _want(runs.reference, cid)
    _close(got[f"{cid}|loss"], want["loss"])
    _close(got[f"{cid}|grad_norm"], want["grad_norm"])
    paths = sorted(k[6:] for k in want if k.startswith("param|"))
    assert paths == sorted(k[len(cid) + 7:] for k in got
                           if k.startswith(f"{cid}|param|"))
    for path in paths:
        np.testing.assert_allclose(got[f"{cid}|param|{path}"],
                                   want[f"param|{path}"], atol=TOL,
                                   rtol=TOL, err_msg=path)


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_prefill_and_decode_match_the_reference(runs, cid):
    got, want = runs.ranks[0], _want(runs.reference, cid)
    for key in ("prefill",) + tuple(f"decode{i}" for i in range(4)):
        _close(got[f"{cid}|{key}"], want[key])


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_each_rank_holds_its_blocks_and_the_same_results(runs, cid):
    """Every rank's parameters, moments and caches have their block's
    shapes, and every rank gathers the same results."""
    ranks = runs.ranks
    for r in ranks:
        assert bool(r[f"{cid}|blocks"]) and bool(r[f"{cid}|cache_blocks"])
        for key in (f"{cid}|loss", f"{cid}|prefill", f"{cid}|decode3"):
            assert np.array_equal(r[key], ranks[0][key])


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_the_priced_rank_records_the_live_collectives(runs, cid):
    """Rank 0's collectives in one train step (calls and input bytes by
    kind, ``runtime.mesh.collective_stats``) equal those that rank 0 of
    an ``AbstractMesh`` of the same shape records for the same step on
    ``meta`` tensors (``AbstractMesh.at(0)``).  The priced rank takes
    NCCL's path; gloo, which has no reduce-scatter, runs each as an
    all-reduce of the same input and takes its block, so its
    reduce-scatters count as all-reduces here."""
    _, arch, profile, shape, b = BY_ID[cid]
    config = port_config(arch, profile)
    rank = AbstractMesh(shape, ("data", "model")).at(0)
    model = build_model(config, rank)
    params = model.params()
    state = TrainState(params, init_opt_state(params, OptConfig(**OPT)))
    batch = {k: torch.empty(v.shape, dtype=torch.as_tensor(v).dtype,
                            device="meta")
             for k, v in make_inputs(config, b).items()}
    make_train_step(model, OptConfig(**OPT))(state, batch)
    priced = {}
    for r in rank.records:
        kind = "all_reduce" if r.kind == "reduce_scatter" else r.kind
        entry = priced.setdefault(kind, {"calls": 0, "bytes": 0})
        entry["calls"] += 1
        entry["bytes"] += r.in_bytes
    prefix = f"{cid}|collectives|"
    live = {}
    for key, value in runs.ranks[0].items():
        if key.startswith(prefix):
            kind, what = key[len(prefix):].split("|")
            live.setdefault(kind, {})[what] = int(value)
    assert live and priced == live


@pytest.mark.parametrize("cid", MOE_CASES)
def test_moe_drops_token_for_token(runs, cid):
    """Each MoE layer's ``keep`` on the mesh equals the mesh-less port's,
    which ``check_drops`` held against the reference's dispatch."""
    got = runs.ranks[0]
    keeps = [got[k] for k in sorted(
        (k for k in got if k.startswith(f"{cid}|keep")),
        key=lambda k: int(k.rsplit("keep", 1)[1]))]
    want = runs.drops[cid]
    assert len(keeps) == len(want) > 0
    for a, b in zip(keeps, want):
        assert np.array_equal(a, b)


def test_train_loop_resumes_bit_for_bit_on_the_mesh(runs):
    got = runs.ranks[0]
    assert int(got["loop|steps_run"]) == 2
    straight = sorted(k for k in got if k.startswith("loop|straight|"))
    assert straight
    for key in straight:
        assert np.array_equal(got[key], got[key.replace("straight",
                                                        "resumed")]), key


def test_the_collectives_and_constrain_on_a_2x2_mesh(runs):
    """Each rank's all-reduce, all-gather (dim 1) and reduce-scatter
    (dim 0) over ``model``, ``(data, model)`` and ``(model, data)`` (the
    group's ranks in shard order, the first axis major), and
    ``constrain`` there and back."""
    devices = np.arange(WORLD).reshape(2, 2)
    for rank, got in enumerate(runs.ranks):
        d, m = np.argwhere(devices == rank)[0]
        x = lambda r: np.arange(6.0).reshape(2, 3) + 10 * r   # noqa: E731
        groups = {"model": devices[d, :], "data,model": devices.reshape(-1),
                  "model,data": devices.T.reshape(-1)}
        for name, ranks in groups.items():
            assert np.array_equal(got[f"x|all_reduce|{name}"],
                                  sum(x(r) for r in ranks))
            assert np.array_equal(got[f"x|all_gather|{name}"],
                                  np.concatenate([x(r) for r in ranks], 1))
            k = list(ranks).index(rank)
            n = 8 // len(ranks)
            total = sum(np.arange(8.0) + r for r in ranks)
            assert np.array_equal(got[f"x|reduce_scatter|{name}"],
                                  total[k * n:(k + 1) * n])
        whole = np.arange(4 * 3 * 8.0).reshape(4, 3, 8)
        assert np.array_equal(got["x|constrain_block"],
                              whole[2 * d:2 * d + 2, :, 4 * m:4 * m + 4])
        assert np.array_equal(got["x|constrain_back"], whole)


@pytest.mark.parametrize("key", ["init_equal|olmo-1b",
                                 "init_equal|deepseek-moe-16b",
                                 "remat_bit_for_bit", "past_capacity_raises",
                                 "cache_carried",
                                 "kv_heads_and_positions_sharded"])
def test_mesh_extras(runs, key):
    """``init`` keeps each rank's block of the mesh-less draws; remat
    ``full`` changes no bit of a step on the mesh; a decode past a
    sequence-sharded cache's capacity raises; ``lm_cache_from_numpy(
    mesh=)`` gives the blocks the mesh's own prefill holds; KV heads in
    place with the cache's positions sharded (``_kv_in_place``)."""
    for got in runs.ranks:
        assert bool(got[f"x|{key}"])


def test_a_mesh_save_holds_one_gathered_leaf_at_a_time(runs):
    """A save on the mesh gathers one leaf at a time, so no rank holds
    more than one whole leaf at once; only the mesh's first rank copies
    the leaves to the host (all of them), the others none."""
    for rank, got in enumerate(runs.ranks):
        assert int(got["save|live_leaves_max"]) == 1
        assert 0 < int(got["save|live_bytes_max"]) \
            <= int(got["save|largest_leaf_bytes"])
        assert int(got["save|host_copies"]) == (
            int(got["save|leaves"]) if rank == 0 else 0)


def _like_state():
    """olmo-1b's smoke train state as numpy zeros (a restore's
    structure)."""
    from repro_torch.train import TrainState
    specs = build_model(get_arch("olmo-1b").smoke_config(),
                        device="meta").param_specs()
    zeros = cm.tree_map(lambda s: np.zeros(s.shape, np.float32), specs,
                        cm.is_spec)
    return TrainState(params=zeros, opt={"m": zeros, "v": zeros,
                                         "step": np.int32(0)})


def test_a_mesh_checkpoint_restores_in_both_packages(runs):
    """The straight run's last checkpoint (written on the mesh) restored
    by the reference and by the mesh-less port: every leaf bit for bit
    what the ranks held."""
    import jax
    from repro.checkpoint.manager import restore_checkpoint as ref_restore
    from repro_torch.checkpoint.manager import restore_checkpoint
    got, tmp = runs.ranks[0], runs.tmp
    like = _like_state()
    port, step = restore_checkpoint(str(tmp / "straight"), like)
    ref, ref_step = ref_restore(str(tmp / "straight"), jax.tree_util.tree_map(
        np.asarray, like))
    assert step == ref_step == LOOP["steps"] - 1
    for path, a in cm.tree_leaves_with_path(
            port.params, lambda x: isinstance(x, np.ndarray)):
        want = got[f"loop|straight|params|{path}"]
        assert np.array_equal(np.asarray(a, np.float32), want), path
    for path, a in cm.tree_leaves_with_path(
            ref.params, lambda x: hasattr(x, "shape")):
        want = got[f"loop|straight|params|{path}"]
        assert np.array_equal(np.asarray(a, np.float32), want), path


def test_a_meshless_checkpoint_restores_on_the_mesh(runs):
    from repro_torch.checkpoint.manager import restore_checkpoint
    got, tmp = runs.ranks[0], runs.tmp
    like = _like_state()
    state, step = restore_checkpoint(str(tmp / "meshless"), like)
    assert int(got["loop|meshless_step"]) == step == 1
    for key, tree in (("params", state.params), ("v", state.opt["v"])):
        for path, a in cm.tree_leaves_with_path(
                tree, lambda x: isinstance(x, np.ndarray)):
            assert np.array_equal(
                got[f"loop|meshless|{key}|{path}"], a), path


@pytest.mark.parametrize("cid", REF_MESH_CASES)
def test_the_reference_mesh_and_the_port_mesh_agree(runs, cid):
    for key in ("loss", "prefill", "decode0", "decode3"):
        _close(runs.ranks[0][f"{cid}|{key}"],
               runs.reference[f"{cid}|{key}"])
