"""The port's checkpoints, recovery loop and straggler monitor against
the JAX package's.

The layout on disk is the reference's file for file and byte for byte,
so a stream checkpointed by either package restores in the other and
continues bit-identically to a stream run straight through; the
crash-restart loop recovers a stream bit-exactly; the straggler
monitor takes the reference's decisions on the same step times.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.checkpoint import manager as ref_manager  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.oracle import connected_components_oracle  # noqa: E402
from repro.runtime import straggler as ref_straggler  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.runtime import (FaultInjector, SimulatedFault,  # noqa: E402
                                 StragglerMonitor, backoff_delay,
                                 is_transient_error, run_with_recovery)

from test_torch_streaming import same_state  # noqa: E402

CPU = "cpu"

pytestmark = pytest.mark.chaos


def _port(n, **kw):
    return repro_torch.StreamingConnectivity(n, device=CPU, **kw)


def _batches(n_batches=10, seed=0):
    g = ref_gen.components_mix([ref_gen.path(300, seed=1),
                                ref_gen.rmat(9, seed=2)], seed=3)
    src, dst, n = g.to_numpy()
    m = len(src)
    perm = np.random.default_rng(seed).permutation(m)
    src, dst = src[perm], dst[perm]
    return n, [(src[b * m // n_batches:(b + 1) * m // n_batches],
                dst[b * m // n_batches:(b + 1) * m // n_batches])
               for b in range(n_batches)], \
        connected_components_oracle(src, dst, n)


def _state():
    return {"labels": torch.arange(8, dtype=torch.int32),
            "count": np.int64(3), "flag": torch.tensor(True),
            "visited": torch.tensor(1.5, dtype=torch.float32),
            "nested": {"b": np.arange(3, dtype=np.int64),
                       "a": [np.float32(2.0), np.int32(7)]}}


def _read(path):
    files = sorted(os.listdir(path))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    blobs = {name: open(os.path.join(path, name), "rb").read()
             for name in files if name.endswith(".npy")}
    return files, manifest, blobs


def test_layout_is_the_reference_byte_for_byte(tmp_path):
    state = _state()
    host = {"labels": state["labels"].numpy(), "count": state["count"],
            "flag": np.array(True), "visited": np.array(1.5, np.float32),
            "nested": state["nested"]}
    ours = save_checkpoint(str(tmp_path / "port"), 5, state)
    theirs = ref_manager.save_checkpoint(str(tmp_path / "ref"), 5, host)
    assert os.path.basename(ours) == os.path.basename(theirs) \
        == "step_00000005"
    assert _read(ours) == _read(theirs)
    # a bare array is one leaf, named as the reference names it
    ours = save_checkpoint(str(tmp_path / "port1"), 1, torch.arange(3))
    theirs = ref_manager.save_checkpoint(str(tmp_path / "ref1"), 1,
                                         np.arange(3))
    assert _read(ours) == _read(theirs)


def test_save_is_atomic_and_restores(tmp_path):
    d = str(tmp_path)
    # a stale temporary directory (a crash mid-save) is replaced, and
    # never counted as a step
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert latest_step(d) is None
    save_checkpoint(d, 2, _state())
    assert sorted(os.listdir(d)) == ["step_00000002"]
    assert latest_step(d) == 2
    restored, step = restore_checkpoint(d, _state())
    assert step == 2
    assert isinstance(restored["labels"], np.ndarray)
    assert restored["labels"].dtype == np.int32
    assert restored["nested"]["a"][1] == 7
    on_cpu, _ = restore_checkpoint(d, _state(), device=CPU)
    assert torch.equal(on_cpu["labels"], torch.arange(8, dtype=torch.int32))
    assert on_cpu["visited"].dtype == torch.float32
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _state())
    with pytest.raises(TypeError, match="keys must be str"):
        save_checkpoint(d, 3, {1: np.int64(0)})


def test_keep_k_and_async_save_copies_at_the_call(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    t = torch.zeros(1000, dtype=torch.int32)
    for step in range(1, 6):
        t.fill_(step)
        mgr.save(step, {"t": t})
        # changed in place right after the call, before the write
        t.fill_(-1)
    mgr.wait()
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000004",
                                                 "step_00000005"]
    for step in (4, 5):
        state, _ = mgr.restore({"t": 0}, step)
        assert (state["t"] == step).all()


def test_corrupt_state_errors():
    n, batches, _ = _batches()
    eng = _port(n)
    eng.ingest(*batches[0])
    state = eng.state_dict()
    bad = dict(state, n_cap=np.int64(int(state["n_cap"]) * 2))
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        _port(n).load_state_dict(bad)
    bad = dict(state, m=np.int64(state["src"].shape[0] + 1))
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        _port(n).load_state_dict(bad)
    with pytest.raises(ValueError, match="missing"):
        _port(n).load_state_dict(
            {k: v for k, v in state.items() if k != "labels"})


def test_state_dict_is_a_copy():
    n, batches, _ = _batches()
    eng = _port(n)
    eng.ingest(*batches[0])
    held = eng.state_dict()
    src = held["src"].clone()
    for b in batches[1:4]:
        eng.ingest(*b)
    assert torch.equal(held["src"], src)
    # and a loaded state is copied in: ingests do not write the caller's
    other = _port(n).load_state_dict(held)
    other.ingest(*batches[1])
    assert torch.equal(held["src"], src)


@pytest.mark.parametrize("store_edges", (True, False))
def test_reference_checkpoint_continues_in_the_port(tmp_path, store_edges):
    n, batches, oracle = _batches()
    straight = repro.StreamingConnectivity(n, store_edges=store_edges)
    for b in batches:
        straight.ingest(*b)
    ref = repro.StreamingConnectivity(n, store_edges=store_edges)
    for b in batches[:5]:
        ref.ingest(*b)
    assert ref.save(ref_manager.CheckpointManager(str(tmp_path),
                                                  async_save=False)) == 5
    port, step = repro_torch.StreamingConnectivity.restore(
        CheckpointManager(str(tmp_path)), device=CPU)
    assert step == 5 and port.n_batches == 5
    for b in batches[5:]:
        port.ingest(*b)
    same_state(straight, port)
    np.testing.assert_array_equal(port.labels.numpy(), oracle)


@pytest.mark.parametrize("store_edges", (True, False))
def test_port_checkpoint_continues_in_the_reference(tmp_path, store_edges):
    n, batches, _ = _batches()
    straight = _port(n, store_edges=store_edges)
    for b in batches:
        straight.ingest(*b)
    port = _port(n, store_edges=store_edges)
    for b in batches[:4]:
        port.ingest(*b)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    port.save(mgr)
    mgr.wait()
    ref, step = repro.StreamingConnectivity.restore(
        ref_manager.CheckpointManager(str(tmp_path)))
    assert step == 4
    for b in batches[4:]:
        ref.ingest(*b)
    same_state(ref, straight)


def test_stream_from_state():
    n, batches, _ = _batches()
    ref = repro.StreamingConnectivity(n)
    for b in batches[:3]:
        ref.ingest(*b)
    state = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    port = interop.stream_from_state(state, device=CPU)
    same_state(ref, port)
    for b in batches[3:]:
        ref.ingest(*b)
        port.ingest(*b)
    same_state(ref, port)
    with pytest.raises(TypeError, match="numpy"):
        interop.stream_from_state(dict(state, labels=torch.tensor([0])),
                                  device=CPU)
    with pytest.raises(ValueError, match="missing"):
        interop.stream_from_state({"n": np.int64(1)}, device=CPU)


def _stream_step(n, batches):
    def step(state, k):
        eng = _port(n).load_state_dict(state)
        eng.ingest(*batches[k])
        return eng.state_dict()
    return step


def test_run_with_recovery_is_bit_exact_after_crashes(tmp_path):
    n, batches, oracle = _batches()
    straight = repro.StreamingConnectivity(n)
    for b in batches:
        straight.ingest(*b)
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    events = []
    state, stats = run_with_recovery(
        _stream_step(n, batches), _port(n).state_dict(), len(batches), mgr,
        checkpoint_every=3,
        fault_injector=FaultInjector(fail_at=(2, 4, 7)),
        on_event=lambda ev, k: events.append((ev, k)))
    assert stats["restarts"] == 3
    assert events == [("restart", 2), ("restart", 4), ("restart", 7)]
    port = _port(n).load_state_dict(state)
    same_state(straight, port)
    np.testing.assert_array_equal(port.labels.numpy(), oracle)


def test_run_with_recovery_recoverable_set_backoff_and_budget(tmp_path):
    fired = set()

    def step(state, k):
        if k == 5 and k not in fired:
            fired.add(k)
            raise RuntimeError("transient failure")
        out = state.copy()
        out[k] += 1
        return out

    init = np.zeros(10, np.int64)
    with pytest.raises(RuntimeError):
        run_with_recovery(step, init, 10,
                          CheckpointManager(str(tmp_path / "a")),
                          checkpoint_every=3)
    fired.clear()
    state, stats = run_with_recovery(
        step, init, 10, CheckpointManager(str(tmp_path / "b")),
        checkpoint_every=3, recoverable=(RuntimeError,))
    assert stats["restarts"] == 1 and (state == 1).all()
    delays = []
    _, stats = run_with_recovery(
        lambda s, k: s + 1, np.int64(0), 10,
        CheckpointManager(str(tmp_path / "c"), async_save=False),
        checkpoint_every=4, fault_injector=FaultInjector(fail_at=(2, 5, 8)),
        backoff_base=0.5, backoff_factor=2.0, backoff_cap=1.5,
        sleep_fn=delays.append)
    assert stats["restarts"] == 3 and delays == [0.5, 1.0, 1.5]
    with pytest.raises(SimulatedFault):
        run_with_recovery(lambda s, k: s, np.int64(0), 5,
                          CheckpointManager(str(tmp_path / "d")),
                          checkpoint_every=2, max_restarts=2,
                          fault_injector=FaultInjector(fail_at=(1, 2, 3)))


def test_fault_classes():
    assert not is_transient_error(SimulatedFault("x"))
    assert not is_transient_error(ValueError("x"))
    assert is_transient_error(RuntimeError("CUDA error"))
    assert backoff_delay(3, base=0.1) == pytest.approx(0.4)
    assert backoff_delay(3, base=0.0) == 0.0
    inj = FaultInjector(fail_at=(1, (2, "post_write")))
    inj.maybe_fail(0)
    with pytest.raises(SimulatedFault):
        inj.maybe_fail(1, "pre")
    inj.maybe_fail(1, "pre")            # fires once
    inj.maybe_fail(2, "pre")
    with pytest.raises(SimulatedFault, match="post_write"):
        inj.maybe_fail(2, "post_write")


def test_straggler_monitor_decides_as_the_reference():
    rng = np.random.default_rng(0)
    times = np.concatenate([rng.uniform(0.9, 1.1, 20), [5, 5, 1, 5, 5, 5, 5],
                            rng.uniform(0.9, 1.1, 5)])
    ours, theirs = StragglerMonitor(), ref_straggler.StragglerMonitor()
    actions = [ours.observe(float(t)) for t in times]
    assert actions == [theirs.observe(float(t)) for t in times]
    assert {"ok", "warn", "checkpoint", "evict"} <= set(actions)
    assert ours.ewma == theirs.ewma
