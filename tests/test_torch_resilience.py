"""The port's recovery loops against the JAX package's, on the same faults.

``repro_torch.connectivity.stream_with_recovery`` and
``oocore_with_recovery`` on CPU tensors are driven beside
``repro.connectivity``'s, each with its own package's
``CheckpointManager`` and ``FaultInjector`` set to the same faults.  The
cases mirror ``tests/test_chaos.py``'s stream cases and
``tests/test_oocore.py``'s recovery cases: crashes at ``"pre"`` and
``"post_write"``, resume across a new call, a straggler forcing a
checkpoint, the restart budget running out (with backoff), and the
out-of-core mid-round crash, round-0 crash, round-boundary crash, resume
from the manifest and unrecoverable fault.  Each holds the results (the
whole stream ``state_dict()``, or labels, ``iterations``, ``converged``
and float32 ``edges_visited`` by their bits) and the stats, events and
backoff delays equal to the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import \
    CheckpointManager as RefManager  # noqa: E402
from repro.connectivity import SolveOptions as RefOptions  # noqa: E402
from repro.connectivity import resilience as ref_resilience  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.oracle import connected_components_oracle  # noqa: E402
from repro.runtime.recovery import FaultInjector as RefInjector  # noqa: E402
from repro.runtime.recovery import SimulatedFault as RefFault  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.connectivity import (FaultInjector,  # noqa: E402
                                      OutOfCoreContraction, SimulatedFault,
                                      SolveOptions, oocore_with_recovery,
                                      solve_chunks, stream_with_recovery)
from repro_torch.connectivity import resilience  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402

from test_torch_oocore import same_finish  # noqa: E402
from test_torch_oocore import same_state as same_round  # noqa: E402
from test_torch_streaming import same_state  # noqa: E402

pytestmark = pytest.mark.chaos

CPU = "cpu"
REF_STREAM = RefOptions(backend="xla")
PORT_STREAM = SolveOptions(backend="torch")


def _batches(n_batches=12, seed=0):
    """(n, oracle, batches): a shuffled micro-batch stream (test_chaos's
    fixture)."""
    g = ref_gen.components_mix([ref_gen.path(300, seed=1),
                                ref_gen.rmat(9, seed=2)], seed=3)
    src, dst, n = g.to_numpy()
    m = len(src)
    perm = np.random.default_rng(seed).permutation(m)
    src, dst = src[perm], dst[perm]
    batches = [(src[b * m // n_batches:(b + 1) * m // n_batches],
                dst[b * m // n_batches:(b + 1) * m // n_batches])
               for b in range(n_batches)]
    return n, connected_components_oracle(src, dst, n), batches


def _managers(tmp_path, **kw):
    return (RefManager(str(tmp_path / "ref"), async_save=False, **kw),
            CheckpointManager(str(tmp_path / "port"), async_save=False,
                              **kw))


def _streams(tmp_path, fail_at, **kw):
    """Both loops on the same batches and faults; returns their
    (engine, stats, events) and the oracle."""
    n, oracle, batches = _batches()
    ref_mgr, port_mgr = _managers(tmp_path)
    out = []
    for run, mgr, opts, injector, extra in (
            (ref_resilience.stream_with_recovery, ref_mgr, REF_STREAM,
             RefInjector, {}),
            (stream_with_recovery, port_mgr, PORT_STREAM, FaultInjector,
             {"device": CPU})):
        events = []
        eng, stats = run(
            batches, n, mgr, opts,
            fault_injector=injector(fail_at=fail_at),
            on_event=lambda ev, k, e=events: e.append((ev, k)),
            **kw, **extra)
        out.append((eng, stats, events))
    return out, oracle


# ---------------------------------------------------------------------------
# stream_with_recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fail_at", [
    (3, (7, "post_write"), (9, "pre")),
    ((0, "pre"),),
    ((11, "post_write"), (11, "pre"), 5)])
def test_stream_crash_recovery_equals_the_reference(tmp_path, fail_at):
    (ref, port), oracle = _streams(tmp_path, fail_at, checkpoint_every=3)
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[1]["restarts"] == len(fail_at)
    same_state(ref[0], port[0])
    np.testing.assert_array_equal(port[0].labels.numpy(), oracle)


def test_stream_recovery_resumes_across_calls(tmp_path):
    n, oracle, batches = _batches()
    ref_mgr, port_mgr = _managers(tmp_path)
    with pytest.raises(RefFault):
        ref_resilience.stream_with_recovery(
            batches, n, ref_mgr, REF_STREAM, checkpoint_every=3,
            max_restarts=0, fault_injector=RefInjector(fail_at=(7,)))
    with pytest.raises(SimulatedFault):
        stream_with_recovery(
            batches, n, port_mgr, PORT_STREAM, checkpoint_every=3,
            max_restarts=0, fault_injector=FaultInjector(fail_at=(7,)),
            device=CPU)
    assert port_mgr.latest_step() == ref_mgr.latest_step() == 6
    ref, ref_stats = ref_resilience.stream_with_recovery(
        batches, n, ref_mgr, REF_STREAM, checkpoint_every=3)
    port, port_stats = stream_with_recovery(
        batches, n, port_mgr, PORT_STREAM, checkpoint_every=3, device=CPU)
    assert port_stats == ref_stats
    assert port.n_batches == len(batches)
    same_state(ref, port)
    np.testing.assert_array_equal(port.labels.numpy(), oracle)


def test_stream_resumes_from_a_reference_checkpoint(tmp_path):
    """The port's loop picks up a stream the reference's loop
    checkpointed (and died on), and ends where the reference ends."""
    n, _, batches = _batches()
    mgr = RefManager(str(tmp_path), async_save=False)
    with pytest.raises(RefFault):
        ref_resilience.stream_with_recovery(
            batches, n, mgr, REF_STREAM, checkpoint_every=4,
            max_restarts=0, fault_injector=RefInjector(fail_at=(9,)))
    port, stats = stream_with_recovery(
        batches, n, CheckpointManager(str(tmp_path), async_save=False),
        PORT_STREAM, checkpoint_every=4, device=CPU)
    ref, _ = ref_resilience.stream_with_recovery(
        batches, n, RefManager(str(tmp_path / "clean"), async_save=False),
        REF_STREAM, checkpoint_every=4)
    assert stats["restarts"] == 0 and port.n_batches == len(batches)
    same_state(ref, port)


class _ScriptedMonitor:
    def __init__(self, actions):
        self.actions = list(actions)

    def start_step(self):
        pass

    def end_step(self):
        return self.actions.pop(0)


@pytest.mark.parametrize("action", ["checkpoint", "evict"])
def test_straggler_forces_a_checkpoint_as_the_reference(tmp_path, action):
    n, oracle, batches = _batches(n_batches=6)
    ref_mgr, port_mgr = _managers(tmp_path, keep=5)
    seen = []
    for run, mgr, opts, extra in (
            (ref_resilience.stream_with_recovery, ref_mgr, REF_STREAM, {}),
            (stream_with_recovery, port_mgr, PORT_STREAM, {"device": CPU})):
        steps, events = [], []
        orig = mgr.save

        def spy(step, state, steps=steps, orig=orig):
            steps.append(step)
            return orig(step, state)

        mgr.save = spy
        eng, stats = run(
            batches, n, mgr, opts, checkpoint_every=6,
            straggler=_ScriptedMonitor(["ok", action, "ok", "ok", "ok",
                                        "ok"]),
            on_event=lambda ev, k, e=events: e.append((ev, k)), **extra)
        seen.append((eng, stats, steps, events))
    (ref, ref_stats, ref_steps, ref_events), \
        (port, port_stats, port_steps, port_events) = seen
    assert port_stats == ref_stats and port_stats["straggler_events"] == 1
    assert port_steps == ref_steps == [2, 6]
    assert port_events == ref_events == [(f"straggler_{action}", 1)]
    same_state(ref, port)


def test_restart_budget_and_backoff_as_the_reference(tmp_path):
    n, _, batches = _batches()
    ref_mgr, port_mgr = _managers(tmp_path)
    fail_at = (2, 4, (5, "post_write"), 8)
    runs = []
    for run, mgr, opts, injector, fault, extra in (
            (ref_resilience.stream_with_recovery, ref_mgr, REF_STREAM,
             RefInjector, RefFault, {}),
            (stream_with_recovery, port_mgr, PORT_STREAM, FaultInjector,
             SimulatedFault, {"device": CPU})):
        delays, events = [], []
        with pytest.raises(fault):
            run(batches, n, mgr, opts, checkpoint_every=3,
                   max_restarts=3, fault_injector=injector(fail_at=fail_at),
                   backoff_base=0.5, backoff_factor=2.0, backoff_cap=1.5,
                   sleep_fn=delays.append,
                   on_event=lambda ev, k, e=events: e.append((ev, k)),
                   **extra)
        runs.append((delays, events, mgr.latest_step()))
    assert runs[1] == runs[0]
    assert runs[1][0] == [0.5, 1.0, 1.5]


def test_stream_loop_rejects_a_bad_cadence(tmp_path):
    n, _, batches = _batches()
    with pytest.raises(ValueError, match="checkpoint_every"):
        stream_with_recovery(batches, n, _managers(tmp_path)[1],
                             PORT_STREAM, checkpoint_every=0, device=CPU)


# ---------------------------------------------------------------------------
# oocore_with_recovery
# ---------------------------------------------------------------------------


def _oocore_sources(name):
    if name == "star":
        return (ref_gen.star_forest_chunks(k=8, b=1024),
                gen.star_forest_chunks(k=8, b=1024), 1)
    g = ref_gen.components_mix([ref_gen.path(500, seed=3),
                                ref_gen.star(400, seed=4),
                                ref_gen.rmat(9, seed=5)], seed=6)
    src, dst, n = g.to_numpy()
    return (ref_gen.ArrayChunks(src, dst, n, 1024),
            gen.ArrayChunks(src, dst, n, 1024), 4)


def _result_tuple(res):
    return res.labels, res.iterations, res.converged, res.edges_visited


@pytest.mark.parametrize("name,fail_at", [
    ("star", ((9, "oocore_chunk"),)),          # mid-stream in round 1
    ("mix", ((3, "oocore_chunk"),)),           # round 0: replay the source
    ("star", ((1, "oocore_round"),)),          # at a round boundary
    ("star", ((4, "oocore_chunk"), (1, "oocore_round"),
              (12, "oocore_chunk"))),
])
def test_oocore_recovery_equals_the_reference(tmp_path, name, fail_at):
    rc, pc, local_iters = _oocore_sources(name)
    ro = RefOptions(algorithm="oocore", variant="C-2", backend="xla",
                    oocore_local_iters=local_iters)
    po = SolveOptions(algorithm="oocore", variant="C-2", backend="torch",
                      oocore_local_iters=local_iters)
    ref_mgr, port_mgr = _managers(tmp_path)
    ref_events, port_events = [], []
    ref, ref_stats = ref_resilience.oocore_with_recovery(
        rc, ref_mgr, ro, fault_injector=RefInjector(fail_at=fail_at),
        on_event=lambda ev, k: ref_events.append((ev, k)))
    port, port_stats = oocore_with_recovery(
        pc, port_mgr, po, fault_injector=FaultInjector(fail_at=fail_at),
        on_event=lambda ev, k: port_events.append((ev, k)), device=CPU)
    assert isinstance(port_stats, resilience.RecoveryStats)
    assert dict(port_stats) == dict(ref_stats)
    assert port_stats.restarts == len(fail_at)
    assert port_events == ref_events
    same_finish(_result_tuple(ref), _result_tuple(port))
    assert port.provenance[1:] == ref.provenance[1:]
    # and the clean run of the same source
    clean = solve_chunks(pc, po, device=CPU)
    same_finish(_result_tuple(clean), _result_tuple(port))


def test_oocore_fresh_engine_resumes_from_the_manifest(tmp_path):
    rc, pc, _ = _oocore_sources("star")
    po = SolveOptions(algorithm="oocore", variant="C-2", backend="torch",
                      oocore_local_iters=1)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    eng = OutOfCoreContraction(pc, po, device=CPU)
    eng.run_round()
    eng.save(mgr)
    mgr.wait()
    eng2 = OutOfCoreContraction(pc, po, device=CPU)
    eng2.restore(mgr)
    assert eng2.round_index == 1
    assert eng2.round_counts == eng.round_counts
    same_round(eng.state_dict(), eng2.state_dict())
    clean = OutOfCoreContraction(pc, po, device=CPU)
    want = clean.run()
    while not eng2.finished_streaming:
        eng2.run_round()
    same_finish(want, eng2.finish())
    # oocore_with_recovery resumes from the same manifest and runs only
    # the rounds after it
    res, stats = oocore_with_recovery(pc, mgr, po, device=CPU)
    assert stats.restarts == 0
    assert stats.rounds == len(clean.round_counts) - 1
    same_finish(want, _result_tuple(res))


def test_oocore_unrecoverable_fault_propagates(tmp_path):
    rc, pc, _ = _oocore_sources("star")
    po = SolveOptions(algorithm="oocore", variant="C-2", backend="torch",
                      oocore_local_iters=1)
    # the restart budget spent
    with pytest.raises(SimulatedFault):
        oocore_with_recovery(
            pc, CheckpointManager(str(tmp_path / "a"), async_save=False),
            po, max_restarts=0, device=CPU,
            fault_injector=FaultInjector(fail_at=((2, "oocore_chunk"),)))
    # an error outside the recoverable set, as a CUDA error would be
    with pytest.raises(RuntimeError, match="device lost"):
        oocore_with_recovery(
            pc, CheckpointManager(str(tmp_path / "b"), async_save=False),
            po, device=CPU, fault_injector=FaultInjector(
                fail_at=((2, "oocore_chunk"),),
                exc_factory=lambda step, site: RuntimeError("device lost")))
