"""The port's out-of-core solver against the JAX package's, bit for bit.

``repro_torch.connectivity.oocore`` on CPU tensors is held against
``repro.connectivity.oocore`` round by round: the whole ``state_dict()``
(labels, the survivor manifest, the counters with ``visited`` by its
bits) after every round, each round's record, and at the end the labels,
``iterations``, ``converged``, float32 ``edges_visited``, ``round_counts``
and ``round_provenance()``.  The cases mirror ``tests/test_oocore.py``:
path, rmat and mix graphs at chunks of 1024 and 4096, the generator-fed
source (and its chunks for several scales, seeds and k), the star
forest's rounds, the facade and its alias, warm starts, the round-cap
waiver, the peak estimate, option/plan/bucket validation, out-of-range
ids and round-boundary checkpoints restored across the packages.

The reference's tracer guard (``solve()`` under ``jax.jit`` raising) has
no counterpart: the port has no tracing, so there is nothing to guard.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import \
    CheckpointManager as RefManager  # noqa: E402
from repro.connectivity import SolveOptions as RefOptions  # noqa: E402
from repro.connectivity import oocore as ref_oocore  # noqa: E402
from repro.connectivity import planner as ref_planner  # noqa: E402
from repro.connectivity import solve as ref_solve  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.oracle import connected_components_oracle  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.connectivity import (OutOfCoreContraction,  # noqa: E402
                                      SolveOptions, solve, solve_chunks)
from repro_torch.connectivity import oocore  # noqa: E402
from repro_torch.connectivity import planner  # noqa: E402
from repro_torch.connectivity.planner.staged import \
    MIN_STAGE_EDGES  # noqa: E402
from repro_torch.graphs import Graph  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402

pytestmark = pytest.mark.oocore

CPU = "cpu"


def _opts(**kw):
    """(reference options, port options) for the same solve."""
    return (RefOptions(algorithm="oocore", variant="C-2", backend="xla",
                       **kw),
            SolveOptions(algorithm="oocore", variant="C-2", backend="torch",
                         **kw))


def _both_chunks(src, dst, n, chunk_edges):
    return (ref_gen.ArrayChunks(src, dst, n, chunk_edges),
            gen.ArrayChunks(src, dst, n, chunk_edges))


def _suite():
    return {
        "path": ref_gen.path(3000, seed=1),
        "rmat": ref_gen.rmat(11, seed=2),
        "mix": ref_gen.components_mix(
            [ref_gen.path(500, seed=3), ref_gen.star(400, seed=4),
             ref_gen.rmat(9, seed=5)], seed=6),
    }


def same_state(ref_state: dict, port_state: dict) -> None:
    """Two round-boundary state dicts, key by key: dtypes, shapes, bits."""
    assert sorted(ref_state) == sorted(port_state)
    for key in ref_state:
        a, b = np.asarray(ref_state[key]), np.asarray(port_state[key])
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        assert a.shape == b.shape, (key, a.shape, b.shape)
        if a.dtype.kind == "f":
            a, b = a.view(np.uint64 if a.itemsize == 8 else np.uint32), \
                b.view(np.uint64 if b.itemsize == 8 else np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=key)


def same_finish(ref_out, port_out) -> None:
    """Labels, iterations, converged and float32 edges_visited, bits."""
    rl, rit, rdone, rvis = ref_out[:4]
    pl, pit, pdone, pvis = port_out[:4]
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    assert int(pit) == int(rit)
    assert bool(pdone) == bool(rdone)
    assert pvis.dtype == torch.float32
    assert (np.float32(pvis.item()).view(np.uint32)
            == np.float32(np.asarray(rvis)).view(np.uint32))


def lockstep(ref_chunks, port_chunks, ref_opts, port_opts, init=None):
    """Both engines round by round, their states equal after each."""
    ref = ref_oocore.OutOfCoreContraction(ref_chunks, ref_opts,
                                          init_labels=init)
    port = OutOfCoreContraction(port_chunks, port_opts, init_labels=init,
                                device=CPU)
    assert port.bucket == ref.bucket
    same_state(ref.state_dict(), port.state_dict())
    while not ref.finished_streaming:
        assert not port.finished_streaming
        assert port.run_round() == ref.run_round()
        same_state(ref.state_dict(), port.state_dict())
    assert port.finished_streaming
    same_finish(ref.finish(), port.finish())
    assert port.round_counts == ref.round_counts
    assert port.round_provenance() == ref.round_provenance()
    assert port.round_cap_exhausted == ref.round_cap_exhausted
    assert port.peak_bytes_estimate() == ref.peak_bytes_estimate()
    return ref, port


# ---------------------------------------------------------------------------
# equivalence with the reference, round by round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["path", "rmat", "mix"])
@pytest.mark.parametrize("chunk_edges", [1024, 4096])
def test_rounds_equal_the_reference(name, chunk_edges):
    src, dst, n = _suite()[name].to_numpy()
    ref, port = lockstep(*_both_chunks(src, dst, n, chunk_edges), *_opts())
    oracle = connected_components_oracle(src, dst, n)
    np.testing.assert_array_equal(port.labels.numpy(), oracle)
    one = solve(Graph.from_numpy(src, dst, n, device=CPU), backend="torch")
    assert torch.equal(port.labels, one.labels)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_solve_chunks_equals_the_reference(backend):
    src, dst, n = _suite()["mix"].to_numpy()
    rc, pc = _both_chunks(src, dst, n, 1024)
    ro, po = _opts()
    ref = ref_oocore.solve_chunks(rc, ro)
    port = solve_chunks(pc, po.replace(backend=backend), device=CPU)
    same_finish((ref.labels, ref.iterations, ref.converged,
                 ref.edges_visited),
                (port.labels, port.iterations, port.converged,
                 port.edges_visited))
    assert port.provenance[1:] == ref.provenance[1:]
    assert "chunk=1024" in port.provenance[0]


def test_generator_fed_chunks_equal_the_reference():
    rc = ref_gen.rmat_chunks(scale=12, edge_factor=8, seed=3,
                             chunk_edges=2048)
    pc = gen.rmat_chunks(scale=12, edge_factor=8, seed=3, chunk_edges=2048)
    lockstep(rc, pc, *_opts())
    port = solve_chunks(pc, _opts()[1], device=CPU)
    one = solve(pc.materialize(device=CPU), backend="torch")
    assert torch.equal(port.labels, one.labels)


@pytest.mark.parametrize("scale,seed,chunk_edges", [
    (9, 0, 1024), (10, 4, 1024), (12, 3, 2048), (14, 7, 4096)])
def test_rmat_chunks_equal_the_reference(scale, seed, chunk_edges):
    rc = ref_gen.RmatChunks(scale=scale, edge_factor=8, seed=seed,
                            chunk_edges=chunk_edges)
    pc = gen.RmatChunks(scale=scale, edge_factor=8, seed=seed,
                        chunk_edges=chunk_edges)
    assert (pc.n_vertices, pc.n_edges, pc.n_chunks) == \
        (rc.n_vertices, rc.n_edges, rc.n_chunks)
    for k in sorted({0, 1, pc.n_chunks // 2, pc.n_chunks - 1}):
        for a, b in zip(pc.chunk(k), rc.chunk(k)):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        pc.chunk(pc.n_chunks)


def test_star_forest_chunks_equal_the_reference():
    rc = ref_gen.star_forest_chunks(k=8, b=1024)
    pc = gen.star_forest_chunks(k=8, b=1024)
    assert (pc.n_vertices, pc.n_edges, pc.chunk_edges) == \
        (rc.n_vertices, rc.n_edges, rc.chunk_edges)
    for (ps, pd), (rs, rd) in zip(pc, rc):
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pd, rd)


def test_chunk_sizes_cover_the_edge_count():
    c = gen.ArrayChunks(np.zeros(5000, np.int64), np.ones(5000, np.int64),
                        8, 1024)
    assert c.n_chunks == 5
    assert sum(c.chunk_size(k) for k in range(c.n_chunks)) == 5000
    assert c.chunk_size(c.n_chunks - 1) == 5000 - 4 * 1024
    g = gen.rmat_chunks(scale=9, edge_factor=8, seed=0,
                        chunk_edges=1024).materialize(device=CPU)
    assert g.n_edges == (1 << 9) * 8 and g.device.type == "cpu"


def test_chunk_sources_reject_what_the_reference_rejects():
    for make in (lambda m: m.ArrayChunks(np.zeros(10, np.int64),
                                         np.zeros(10, np.int64), 4, 100),
                 lambda m: m.RmatChunks(scale=8, chunk_edges=3),
                 lambda m: m.ArrayChunks(np.zeros(10, np.int64),
                                         np.zeros(9, np.int64), 4, 8)):
        with pytest.raises(ValueError) as want:
            make(ref_gen)
        with pytest.raises(ValueError) as got:
            make(gen)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# round structure, the facade, warm starts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["oocore", "out_of_core"])
def test_facade_equals_the_reference(algorithm):
    src, dst, n = _suite()["mix"].to_numpy()
    ref = ref_solve(ref_gen.components_mix(
        [ref_gen.path(500, seed=3), ref_gen.star(400, seed=4),
         ref_gen.rmat(9, seed=5)], seed=6), algorithm=algorithm,
        oocore_chunk_edges=1024, variant="C-2", backend="xla")
    port = solve(Graph.from_numpy(src, dst, n, device=CPU),
                 algorithm=algorithm, oocore_chunk_edges=1024,
                 variant="C-2", backend="torch")
    same_finish((ref.labels, ref.iterations, ref.converged,
                 ref.edges_visited),
                (port.labels, port.iterations, port.converged,
                 port.edges_visited))
    assert any("chunk=1024" in e for e in port.provenance)
    assert port.provenance[1:] == ref.provenance[1:]
    assert port.provenance[1].startswith("oocore:rounds=")


def test_warm_start_equals_the_reference():
    src, dst, n = _suite()["rmat"].to_numpy()
    ro, po = _opts()
    first = ref_oocore.solve_chunks(ref_gen.ArrayChunks(src, dst, n, 2048),
                                    ro)
    init = np.asarray(first.labels)
    _, port = lockstep(*_both_chunks(src, dst, n, 2048), ro, po, init=init)
    # restarting from the fixed point: every edge retires in round 0
    assert port.round_counts[-1] == 0
    # a partial warm start (the first half of a stream's labels)
    half = np.minimum(init, np.arange(n, dtype=np.int32))[: n // 2]
    lockstep(*_both_chunks(src, dst, n, 2048), ro, po, init=half)


@pytest.mark.parametrize("local_iters,round_cap", [(1, 64), (1, 1), (2, 2)])
def test_star_forest_rounds_and_round_cap_equal_the_reference(local_iters,
                                                              round_cap):
    rc = ref_gen.star_forest_chunks(k=8, b=1024)
    pc = gen.star_forest_chunks(k=8, b=1024)
    _, port = lockstep(rc, pc, *_opts(oocore_local_iters=local_iters,
                                      oocore_round_cap=round_cap))
    if round_cap == 1:
        assert port.round_cap_exhausted
        assert "oocore_round_cap_exhausted" in port.round_provenance()
    if (local_iters, round_cap) == (1, 64):
        # a genuine second round, as the reference's multiround row
        assert len(port.round_counts) >= 2
        assert port.round_counts[0] > pc.chunk_edges
        assert not port.round_cap_exhausted


def test_round_counters_add_in_float32_as_the_reference(monkeypatch):
    """A round's fold counters are summed chunk by chunk, edges_visited
    in float32, before they join the totals: with folds whose visited
    counts pass 2**24 between them, a float64 sum would differ from the
    reference in the last bits."""
    import jax.numpy as jnp
    visits = [9_999_991.0, 7_654_321.0, 5_555_557.0, 3_333_331.0]

    def fake(make_int, make_float):
        calls = []

        def fold(labels, src, dst, n_active, **kw):
            calls.append(None)
            return (labels, make_int(3),
                    make_float(visits[(len(calls) - 1) % len(visits)]))
        return fold

    monkeypatch.setattr(ref_oocore, "_fold_chunk",
                        fake(jnp.int32, jnp.float32))
    monkeypatch.setattr(oocore, "_fold_chunk", fake(int, np.float32))
    src, dst, n = _suite()["rmat"].to_numpy()
    rc, pc = _both_chunks(src, dst, n, 1024)
    ref = ref_oocore.OutOfCoreContraction(rc, _opts()[0])
    port = OutOfCoreContraction(pc, _opts()[1], device=CPU)
    for _ in range(2):
        assert port.run_round() == ref.run_round()
        same_state(ref.state_dict(), port.state_dict())
    exact = sum(visits[k % len(visits)] for k in range(pc.n_chunks))
    assert port.state_dict()["visited"] != 2 * exact


def test_decay_strictly_decreasing():
    src, dst, n = _suite()["mix"].to_numpy()
    eng = OutOfCoreContraction(gen.ArrayChunks(src, dst, n, 1024),
                               _opts()[1], device=CPU)
    rounds = []
    while not eng.finished_streaming:
        rounds.append(eng.run_round())
    chain = [src.shape[0]] + [r["survivors"] for r in rounds]
    assert all(b < a for a, b in zip(chain, chain[1:]))
    for r, prev in zip(rounds, chain):
        assert r["edges_in"] == prev


def test_peak_estimate_below_edge_bytes_on_stress_graph():
    rc = ref_gen.rmat_chunks(scale=13, edge_factor=8, seed=9,
                             chunk_edges=2048)
    pc = gen.rmat_chunks(scale=13, edge_factor=8, seed=9, chunk_edges=2048)
    assert pc.n_edges >= 4 * pc.chunk_edges
    ref, port = lockstep(rc, pc, *_opts())
    assert not port.round_cap_exhausted
    assert port.peak_bytes_estimate() < oocore.EDGE_BYTES * pc.n_edges
    assert port.peak_bytes_estimate() == oocore.estimate_peak_bytes(
        pc.n_vertices, pc.chunk_edges) == ref.peak_bytes_estimate()
    assert (oocore.LABEL_ARRAYS, oocore.CHUNK_ARRAYS, oocore.EDGE_BYTES) \
        == (ref_oocore.LABEL_ARRAYS, ref_oocore.CHUNK_ARRAYS,
            ref_oocore.EDGE_BYTES)
    # on the CPU there is no device allocator to read
    assert oocore.device_peak_bytes(CPU) is None


# ---------------------------------------------------------------------------
# validation: options, plan, bucket, errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("field,value", [
    ("oocore_chunk_edges", MIN_STAGE_EDGES // 2), ("oocore_round_cap", 0),
    ("oocore_local_iters", 0), ("oocore_round_cap", -1)])
def test_options_reject_what_the_reference_rejects(field, value):
    with pytest.raises(ValueError) as want:
        RefOptions(**{field: value}).validate()
    with pytest.raises(ValueError) as got:
        SolveOptions(**{field: value}).validate()
    assert str(got.value) == str(want.value)
    # through the facade too, before any solve work
    g = gen.path(32, seed=0, device=CPU)
    with pytest.raises(ValueError, match=field):
        solve(g, algorithm="oocore", **{field: value})


def test_options_defaults_and_accepted_values_match_the_reference():
    for field in ("oocore_chunk_edges", "oocore_round_cap",
                  "oocore_local_iters"):
        assert getattr(SolveOptions(), field) == getattr(RefOptions(), field)
    SolveOptions(oocore_chunk_edges=MIN_STAGE_EDGES, oocore_round_cap=1,
                 oocore_local_iters=1).validate()


@pytest.mark.parametrize("bucket", [0, 1, 1024, 4096, 3, 6, -2])
def test_plan_chunk_bucket_rule_matches_the_reference(bucket):
    ref_plan = ref_planner.ExecutionPlan(backend="xla", chunk_bucket=bucket)
    try:
        ref_plan.validate()
    except ValueError:
        with pytest.raises(ValueError, match="chunk_bucket"):
            planner.ExecutionPlan(backend="torch", chunk_bucket=bucket)
        return
    port_plan = planner.ExecutionPlan(backend="torch", chunk_bucket=bucket)
    assert ("chunk=" in port_plan.provenance_entry()) == \
        ("chunk=" in ref_plan.provenance_entry())
    if bucket:
        assert port_plan.provenance_entry().endswith(f" chunk={bucket}")


def test_oocore_chunk_bucket_matches_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_VMEM_BYTES", raising=False)
    assert planner.OOCORE_BYTES_PER_EDGE == \
        ref_planner.OOCORE_BYTES_PER_EDGE
    for m in (0, 1, 64, 1000, 1024, 5000, 1 << 16, (1 << 17) + 1, 1 << 20,
              1 << 26):
        for requested in (0, 1, 1000, 1024, 3000, 4096, 1 << 18, 1 << 30):
            assert planner.oocore_chunk_bucket(m, requested=requested) == \
                ref_planner.oocore_chunk_bucket(m, requested=requested), \
                (m, requested)
    # the default bucket: 16 MiB over 128 bytes an edge
    assert planner.oocore_chunk_bucket(1 << 26) == 1 << 17


def test_chunk_bucket_ignores_the_vmem_variable(monkeypatch):
    """Queue C deviation: the reference derives its default bucket from
    the TPU's VMEM budget (``REPRO_VMEM_BYTES`` or a device report); the
    port has no VMEM and keeps the reference's 16 MiB default."""
    monkeypatch.setenv("REPRO_VMEM_BYTES", str(1 << 20))
    assert ref_planner.oocore_chunk_bucket(1 << 26) == 1 << 13
    assert planner.oocore_chunk_bucket(1 << 26) == 1 << 17
    with pytest.raises(TypeError):
        SolveOptions(vmem_limit_bytes=1 << 20)


def test_engine_rejects_what_the_reference_rejects():
    src, dst, n = _suite()["path"].to_numpy()
    with pytest.raises(TypeError, match="EdgeChunks"):
        OutOfCoreContraction((src, dst), device=CPU)
    # the reference's chunk source is not the port's
    with pytest.raises(TypeError, match="EdgeChunks"):
        OutOfCoreContraction(ref_gen.ArrayChunks(src, dst, n, 1024),
                             device=CPU)
    with pytest.raises(ValueError, match="C-Syn"):
        OutOfCoreContraction(gen.ArrayChunks(src, dst, n, 1024),
                             variant="C-Syn", device=CPU)
    with pytest.raises(ValueError, match="int32"):
        OutOfCoreContraction(gen.ArrayChunks(src, dst, 1 << 31, 1024),
                             device=CPU)
    eng = OutOfCoreContraction(gen.ArrayChunks(src, dst, n, 1024),
                               device=CPU)
    with pytest.raises(RuntimeError, match="rounds still pending"):
        eng.finish()
    eng.run()
    with pytest.raises(RuntimeError, match="already finished"):
        eng.run_round()


@pytest.mark.parametrize("bad", [-1, 3000])
def test_out_of_range_ids_raise_index_error(bad):
    src = np.arange(2999, dtype=np.int64)
    dst = src + 1
    dst[1500] = bad
    eng = OutOfCoreContraction(gen.ArrayChunks(src, dst, 3000, 1024),
                               _opts()[1], device=CPU)
    with pytest.raises(IndexError, match=str(bad)):
        eng.run_round()


# ---------------------------------------------------------------------------
# round-boundary checkpoints across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoints_restore_across_packages(tmp_path, direction):
    rc = ref_gen.star_forest_chunks(k=8, b=1024)
    pc = gen.star_forest_chunks(k=8, b=1024)
    ro, po = _opts(oocore_local_iters=1)
    straight = ref_oocore.OutOfCoreContraction(rc, ro)
    want = straight.run()
    ref = ref_oocore.OutOfCoreContraction(rc, ro)
    port = OutOfCoreContraction(pc, po, device=CPU)
    if direction == "ref_to_port":
        ref.run_round()
        mgr = RefManager(str(tmp_path), async_save=False)
        ref.save(mgr)
        mgr.wait()
        port.restore(CheckpointManager(str(tmp_path), async_save=False))
        resumed = port
    else:
        port.run_round()
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        port.save(mgr)
        mgr.wait()
        ref.restore(RefManager(str(tmp_path), async_save=False))
        resumed = ref
    assert resumed.round_index == 1
    while not resumed.finished_streaming:
        resumed.run_round()
    got = resumed.finish()
    if resumed is port:
        same_finish(want, got)
    else:
        same_finish(want, (torch.tensor(np.asarray(got[0])),
                           *got[1:3], torch.tensor(np.asarray(got[3]))))
    assert resumed.round_counts == straight.round_counts
    same_state(straight.state_dict(), resumed.state_dict())


def test_state_dict_is_a_copy():
    src, dst, n = _suite()["rmat"].to_numpy()
    eng = OutOfCoreContraction(gen.ArrayChunks(src, dst, n, 1024),
                               _opts()[1], device=CPU)
    held = eng.state_dict()
    before = held["labels"].copy()
    eng.run()
    np.testing.assert_array_equal(held["labels"], before)
    assert not np.array_equal(eng.state_dict()["labels"], before)
