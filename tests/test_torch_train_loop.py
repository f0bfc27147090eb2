"""The port's training loop (``launch/train.py``), its checkpoints and
its recovery, against the JAX package's.

The ports of ``test_train_runtime.py``'s loop tests (the loss falls;
``run_with_recovery`` with injected faults and ``train_loop``'s resume
are bit for bit; keep-k), the batches of ``build_batch_fn`` against the
reference's, a training state checkpointed by either package restored
in the other (a ``NamedTuple``'s leaves named by field, bit for bit), and
the reference's ``train_loop`` continued by the port's from its
checkpoint, within the float32 step's tolerances
(``tests/test_torch_train_step.py``).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as ref_manager  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.optim.adamw import OptConfig as RefOptConfig  # noqa: E402
from repro.train.step import TrainState as RefTrainState  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.train import build_batch_fn, train_loop  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.runtime import FaultInjector, run_with_recovery  # noqa: E402
from repro_torch.train import (TrainState, init_train_state,  # noqa: E402
                               make_train_step)

from test_torch_train_step import (PARAM_ATOL, PARAM_RTOL,  # noqa: E402
                                   close_leaves, configs, leaves,
                                   numpy_state, numpy_tree)

CPU = "cpu"
LOOP_OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=20)


def olmo():
    return get_arch("olmo-1b").smoke_config()


def same_params(a, b) -> None:
    for (path, x), (_, y) in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(x, y), path


def test_training_reduces_loss():
    out = train_loop(olmo(), steps=30, batch=4, seq=32, log_every=0,
                     opt=OptConfig(peak_lr=3e-3, warmup_steps=3,
                                   decay_steps=30), device=CPU)
    assert out["steps_run"] == 30 and len(out["step_times"]) == 30
    assert out["last_loss"] < out["first_loss"] - 0.5


def test_crash_recovery_bitexact(tmp_path):
    """Train with injected faults == train uninterrupted (data is
    seekable, checkpoints are atomic, so recovery must be exact)."""
    config = olmo()
    opt = OptConfig(**LOOP_OPT)
    ref = train_loop(config, steps=20, batch=2, seq=16, log_every=0,
                     opt=opt, device=CPU)
    model = build_model(config, device=CPU)
    step = make_train_step(model, opt)
    batch_at = build_batch_fn(config, 2, 16, device=CPU)
    init = init_train_state(model, torch.Generator().manual_seed(0), opt)
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    events = []

    def one(state, k):
        return step(state, batch_at(k))[0]

    final, stats = run_with_recovery(
        one, init, 20, mgr, checkpoint_every=5,
        fault_injector=FaultInjector(fail_at=(7, 13)),
        on_event=lambda ev, k: events.append((ev, k)))
    assert stats["restarts"] == 2 and events == [("restart", 7),
                                                  ("restart", 13)]
    same_params(ref["state"], final)


def test_train_loop_resume_from_checkpoint(tmp_path):
    config = olmo()
    opt = OptConfig(**LOOP_OPT)
    d = str(tmp_path / "ck")
    ref = train_loop(config, steps=12, batch=2, seq=16, log_every=0,
                     opt=opt, device=CPU)
    train_loop(config, steps=6, batch=2, seq=16, ckpt_dir=d,
               checkpoint_every=3, log_every=0, opt=opt, device=CPU)
    seen = []
    b = train_loop(config, steps=12, batch=2, seq=16, ckpt_dir=d,
                   checkpoint_every=3, log_every=0, opt=opt, device=CPU,
                   on_step=lambda k, s, m: seen.append(k))
    assert b["steps_run"] == 6 and seen == list(range(6, 12))
    assert torch.equal(ref["state"].opt["m"]["embed"]["tok_embed"],
                       b["state"].opt["m"]["embed"]["tok_embed"])
    same_params(ref["state"], b["state"])
    for (path, x), (_, y) in zip(leaves(tuple(ref["state"])),
                                 leaves(tuple(b["state"]))):
        assert x.shape == y.shape and x.dtype == y.dtype, path
    assert b["state"].opt["step"].shape == () and \
        int(b["state"].opt["step"]) == 12


def test_checkpoint_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for k in range(5):
        mgr.save(k, {"x": torch.full((3,), k)})
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    assert mgr.latest_step() == 4


@pytest.mark.parametrize("name", ["olmo-1b", "llava-next-34b",
                                  "seamless-m4t-large-v2"])
def test_batches_are_the_references(name):
    """Tokens and labels from the pipeline, the frontends' stubs from
    ``default_rng([7 | 11, seed, step])``: the reference's arrays."""
    config = get_arch(name).smoke_config()
    ref_config = configs(name, "bfloat16")[0]
    ours = build_batch_fn(config, 3, 16, seed=5, device=CPU)
    theirs = ref_train.build_batch_fn(ref_config, 3, 16, seed=5)
    for k in (0, 4):
        a, b = ours(k), theirs(k)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == {"tokens": torch.int32,
                                    "labels": torch.int32}.get(
                                        key, torch.float32)
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
    assert ("patch_embeds" in a) == (name == "llava-next-34b")
    assert ("frame_embeds" in a) == (name == "seamless-m4t-large-v2")


def state_pair(name="olmo-1b"):
    """One training state in both packages' types (the reference's
    ``TrainState`` of jnp arrays, the port's of tensors), with a moved
    step and moments."""
    ref_config, config = configs(name)
    params, opt = numpy_state(ref_config, seed=3)
    rng = np.random.default_rng(4)
    opt = {"m": jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        opt["m"]), "v": jax.tree_util.tree_map(
        lambda a: rng.random(a.shape).astype(np.float32), opt["v"]),
        "step": np.int32(7)}
    ref = RefTrainState(*jax.tree_util.tree_map(jnp.asarray, (params, opt)))
    port = interop.train_state_from_numpy((params, opt), config,
                                          OptConfig(), device=CPU)
    return ref, port


def manifest_names(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return [leaf["name"] for leaf in json.load(f)["leaves"]]


def test_reference_train_state_restores_in_the_port(tmp_path):
    """A ``TrainState`` checkpointed by the reference: the same leaf
    names (by field: ``params__...``, ``opt__m__...``, ``opt__step``) and
    every leaf bit for bit in the port's ``TrainState``."""
    ref, port = state_pair()
    ref_manager.save_checkpoint(str(tmp_path), 7, ref)
    names = manifest_names(str(tmp_path), 7)
    assert names[0].startswith("params__")
    assert "opt__step" in names and all(
        n.split("__")[0] in ("params", "opt") for n in names)
    save_checkpoint(str(tmp_path / "port"), 7, port)
    assert manifest_names(str(tmp_path / "port"), 7) == names
    got, step = restore_checkpoint(str(tmp_path), port, device=CPU)
    assert step == 7 and isinstance(got, TrainState)
    assert got.opt["step"].dtype == torch.int32
    want = numpy_tree(tuple(ref))
    for (path, a), (_, b) in zip(leaves(want), leaves(tuple(got))):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)
    assert len(leaves(tuple(got))) == len(names)


def test_port_train_state_restores_in_the_reference(tmp_path):
    ref, port = state_pair("deepseek-moe-16b")
    save_checkpoint(str(tmp_path), 3, port)
    ref_manager.save_checkpoint(str(tmp_path / "ref"), 3, ref)
    assert manifest_names(str(tmp_path), 3) == \
        manifest_names(str(tmp_path / "ref"), 3)
    got, step = ref_manager.restore_checkpoint(str(tmp_path), ref)
    assert step == 3 and isinstance(got, RefTrainState)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                     np.asarray(b))


def test_port_continues_the_references_train_loop(tmp_path):
    """The reference's ``train_loop`` checkpoints after step 3; the
    port's ``train_loop`` resumes from that directory to step 6 and ends
    within the float32 step's tolerances of the reference's run to 6."""
    name = "olmo-1b"
    ref_config, config = configs(name)
    d = str(tmp_path / "ck")
    ref_train.train_loop(ref_config, steps=3, batch=2, seq=16, ckpt_dir=d,
                         checkpoint_every=3, log_every=0,
                         opt=RefOptConfig(**LOOP_OPT))
    want = ref_train.train_loop(ref_config, steps=6, batch=2, seq=16,
                                log_every=0, opt=RefOptConfig(**LOOP_OPT))
    got = train_loop(config, steps=6, batch=2, seq=16, ckpt_dir=d,
                     checkpoint_every=3, log_every=0,
                     opt=OptConfig(**LOOP_OPT), device=CPU)
    assert got["steps_run"] == 3
    np.testing.assert_allclose(got["last_loss"], want["last_loss"],
                               rtol=1e-4)
    close_leaves(numpy_tree(want["state"].params), got["state"].params,
                 PARAM_ATOL, PARAM_RTOL)
    assert int(got["state"].opt["step"]) == 6


def test_no_card_and_no_device_raises(monkeypatch, capsys):
    """No CPU fallback: without a card and a named device the loop
    raises, and so does a host mesh; ``--tp`` above 1 on one rank (no
    ``torchrun``) trains without a mesh, as the reference does on one
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(olmo(), steps=1, batch=2, seq=8, log_every=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh(1, devices=[0])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr("sys.argv", ["train", "--arch", "olmo-1b", "--smoke",
                                     "--tp", "2", "--steps", "1", "--batch",
                                     "2", "--seq", "8", "--device", "cpu"])
    port_train.main()
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):])["steps_run"] == 1


def test_main_runs_a_smoke_config_on_the_cpu(capsys):
    port_train.main(["--arch", "xlstm-125m", "--smoke", "--steps", "3",
                     "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["steps_run"] == 3 and np.isfinite(summary["last_loss"])


def test_train_state_from_numpy_checks_its_input():
    ref_config, config = configs("olmo-1b")
    params, opt = numpy_state(ref_config)
    state = interop.train_state_from_numpy(
        (params, opt), config, OptConfig(moment_dtype=torch.bfloat16),
        device=CPU)
    assert all(t.dtype == torch.bfloat16 for _, t in leaves(state.opt["m"]))
    assert all(t.dtype == torch.float32 for _, t in leaves(state.params))
    with pytest.raises(ValueError, match="m, v and step"):
        interop.train_state_from_numpy((params, {"m": opt["m"]}), config,
                                       OptConfig(), device=CPU)
    with pytest.raises(ValueError, match="missing"):
        interop.train_state_from_numpy(
            (params, dict(opt, v={"embed": {}})), config, OptConfig(),
            device=CPU)
    with pytest.raises(TypeError, match="integer scalar"):
        interop.train_state_from_numpy(
            (params, dict(opt, step=np.float32(1))), config, OptConfig(),
            device=CPU)
