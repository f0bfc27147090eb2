"""``repro_torch.solve_batch`` against ``repro.solve_batch``, bit for bit.

The same fleets (built once with numpy and handed to both packages):
labels, iterations, converged, ``edges_visited`` and ``batch_sizes`` of
the batched result must be identical, with provenance ``None`` where the
reference's is.  Dense Contour runs as one fleet (``contour.
contour_labels_batched``, its kernels' plain versions here); the frontier,
the baselines and ``auto`` run lane by lane.  Warm starts, a lane with an
edge-free pointer chain (it changes if the lane is not frozen once its
test passes), empty fleets, edgeless graphs and the errors are covered
too, and the fleet's entry points are held against each lane's
single-graph plain functions.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.connectivity import batch as ref_batch  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.connectivity import contour, minmap  # noqa: E402
from repro_torch.connectivity.batch import stack_graphs  # noqa: E402
from repro_torch.kernels.contour_mm import blocked  # noqa: E402
from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402

VARIANTS = ("C-Syn", "C-1", "C-2", "C-m", "C-11mm", "C-1m1m", "C-3")

FLEETS = {
    # path, rmat, grid and star: four families of different depths
    "mixed": lambda: [ref_gen.path(300), ref_gen.rmat(9),
                      ref_gen.grid2d(12, 24), ref_gen.star(150)],
    "ragged": lambda: [ref_gen.rmat(7, seed=1), ref_gen.path(40, seed=2),
                       ref_gen.components_mix([ref_gen.path(30, seed=3),
                                               ref_gen.star(20, seed=4)],
                                              seed=5),
                       ref_gen.grid2d(3, 4), ref_gen.cycle(64, seed=6)],
}


@functools.lru_cache(maxsize=None)
def _arrays(fname):
    return tuple(g.to_numpy() for g in FLEETS[fname]())


def _fleet_pair(fname, extra=()):
    arrays = _arrays(fname) + tuple(extra)
    ref = [repro.Graph.from_numpy(s, d, n) for s, d, n in arrays]
    port = [interop.graph_from_arrays(s, d, n, device="cpu")
            for s, d, n in arrays]
    return ref, port


def _same_batch(ref, port):
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(port.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(port.converged.numpy(),
                                  np.asarray(ref.converged))
    assert port.labels.dtype == torch.int32
    assert port.iterations.dtype == torch.int32
    assert port.converged.dtype == torch.bool
    if ref.edges_visited is None:
        assert port.edges_visited is None
    else:
        assert port.edges_visited.dtype == torch.float32
        np.testing.assert_array_equal(
            port.edges_visited.numpy().view(np.uint32),
            np.asarray(ref.edges_visited).view(np.uint32))
    assert port.batch_sizes == ref.batch_sizes
    assert (port.provenance is None) == (ref.provenance is None)
    for a, b in zip(port.unstack(), ref.unstack()):
        np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels))
        assert int(a.iterations) == int(b.iterations)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fname", sorted(FLEETS))
def test_dense_contour_fleet_matches_the_reference(fname, variant, backend):
    ref_fleet, fleet = _fleet_pair(fname)
    ref = repro.solve_batch(ref_fleet, variant=variant)
    port = repro_torch.solve_batch(fleet, variant=variant, backend=backend)
    _same_batch(ref, port)
    assert port.provenance[0].startswith(f"plan:{backend} ")
    assert "schedule=masked" in port.provenance[0]


def test_mixed_fleet_iterations():
    _, fleet = _fleet_pair("mixed")
    assert repro_torch.solve_batch(fleet).iterations.tolist() == [6, 3, 3, 2]
    assert repro_torch.solve_batch(fleet, algorithm="fastsv") \
        .iterations.tolist() == [9, 4, 5, 3]


LANE_BY_LANE = [
    {"sampling": 2, "compact_every": 2},
    {"sampling": 2, "compact_every": 2, "sampling_strategy": "kout"},
    {"sampling": 2, "compact_every": 2, "sampling_strategy": "bfs"},
    {"compact_every": 1, "variant": "C-m"},
    {"algorithm": "fastsv"},
    {"algorithm": "label_propagation"},
    {"algorithm": "union_find"},
    {"algorithm": "auto"},
    {"algorithm": "auto", "sampling_strategy": "bfs"},
]


@pytest.mark.parametrize("overrides", LANE_BY_LANE,
                         ids=[str(o) for o in LANE_BY_LANE])
@pytest.mark.parametrize("fname", sorted(FLEETS))
def test_lane_by_lane_families_match_the_reference(fname, overrides):
    ref_fleet, fleet = _fleet_pair(fname)
    ref = repro.solve_batch(ref_fleet, **overrides)
    port = repro_torch.solve_batch(fleet, **overrides)
    _same_batch(ref, port)


def test_auto_records_no_provenance():
    ref_fleet, fleet = _fleet_pair("mixed")
    assert repro.solve_batch(ref_fleet, algorithm="auto").provenance is None
    assert repro_torch.solve_batch(fleet, algorithm="auto").provenance \
        is None


def _chain_warm(fleet, lane, start):
    """Identity warm starts, except lane ``lane`` (of fewer vertices than
    the fleet's n): vertices ``start..n-1`` — padding no edge touches —
    form one pointer chain ``v -> v - 1``.  Each jump round shortens the
    chain, so the lane's labels change if it is not frozen."""
    n = max(g.n_vertices for g in fleet)
    rows = [np.arange(g.n_vertices, dtype=np.int32) for g in fleet]
    row = np.arange(n, dtype=np.int32)
    row[start:] = np.arange(start - 1, n - 1)
    rows[lane] = row
    return rows


@pytest.mark.parametrize("variant", ["C-2", "C-m", "C-1m1m", "C-Syn"])
@pytest.mark.parametrize("form", ["sequence", "stacked", "result"])
def test_warm_starts_and_frozen_lanes_match_the_reference(variant, form):
    ref_fleet, fleet = _fleet_pair("mixed")
    # lane 3 (a star, 2 iterations) holds a chain on vertices 200..511
    rows = _chain_warm(fleet, 3, 200)
    n = max(g.n_vertices for g in fleet)
    if form == "sequence":
        ref_ws, ws = rows, [torch.from_numpy(r) for r in rows]
    else:
        stacked = np.stack([np.concatenate([r, np.arange(len(r), n)])
                            for r in rows]).astype(np.int32)
        ref_ws, ws = stacked, torch.from_numpy(stacked)
        if form == "result":
            ref_ws = repro.solve_batch(ref_fleet, variant=variant,
                                       warm_start=stacked)
            ws = repro_torch.solve_batch(fleet, variant=variant,
                                         warm_start=ws)
    ref = repro.solve_batch(ref_fleet, variant=variant, warm_start=ref_ws)
    port = repro_torch.solve_batch(fleet, variant=variant, warm_start=ws)
    _same_batch(ref, port)


def test_an_unfrozen_lane_would_differ(monkeypatch):
    """The control: with the jump round ignoring the lanes' done words,
    the chain lane moves on after its test passed and the fleet no longer
    equals the reference."""
    ref_fleet, fleet = _fleet_pair("mixed")
    rows = _chain_warm(fleet, 3, 200)
    ref = repro.solve_batch(ref_fleet, warm_start=rows)
    real = cv.pointer_jump_batched_plain
    monkeypatch.setattr(cv, "pointer_jump_batched_plain",
                        lambda L, n, lanes=None: real(L, n))
    port = repro_torch.solve_batch(fleet, warm_start=[
        torch.from_numpy(r) for r in rows])
    assert not np.array_equal(port.labels.numpy()[3],
                              np.asarray(ref.labels)[3])


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_fleet_reads_any_chunk(chunk, monkeypatch):
    ref_fleet, fleet = _fleet_pair("ragged")
    ref = repro.solve_batch(ref_fleet, variant="C-11mm", max_iters=5)
    monkeypatch.setattr(cv, "CHUNK", chunk)
    reads = []
    real = cv.read_loop
    monkeypatch.setattr(cv, "read_loop",
                        lambda s: reads.append(1) or real(s))
    port = repro_torch.solve_batch(fleet, variant="C-11mm", max_iters=5)
    _same_batch(ref, port)
    its = int(port.iterations.max())
    assert len(reads) == min(-(-its // chunk), -(-5 // chunk))


def test_budget_cut_lanes_match_the_reference():
    ref_fleet, fleet = _fleet_pair("mixed")
    for max_iters in (1, 2, 4):
        ref = repro.solve_batch(ref_fleet, variant="C-1", max_iters=max_iters)
        port = repro_torch.solve_batch(fleet, variant="C-1",
                                       max_iters=max_iters)
        _same_batch(ref, port)
        assert not bool(port.converged.all())


def test_edgeless_graphs_match_the_reference():
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), 7)
    loop = (np.array([1], np.int32), np.array([1], np.int32), 3)
    for extra in ([empty], [empty, loop]):
        ref_fleet, fleet = _fleet_pair("ragged", extra)
        for variant in ("C-2", "C-Syn"):
            _same_batch(repro.solve_batch(ref_fleet, variant=variant),
                        repro_torch.solve_batch(fleet, variant=variant))
    # a fleet of edgeless graphs alone: one padding edge slot
    arrays = [empty, empty]
    ref = repro.solve_batch([repro.Graph.from_numpy(*a) for a in arrays])
    port = repro_torch.solve_batch(
        [interop.graph_from_arrays(*a, device="cpu") for a in arrays])
    _same_batch(ref, port)


def test_empty_fleet_matches_the_reference():
    ref = repro.solve_batch([])
    port = repro_torch.solve_batch([], device="cpu")
    assert tuple(port.labels.shape) == tuple(np.asarray(ref.labels).shape)
    assert port.unstack() == [] == ref.unstack()
    assert port.batch_sizes == () == ref.batch_sizes
    stacked, sizes = stack_graphs([], with_sizes=True, device="cpu")
    ref_stacked, ref_sizes = ref_batch.stack_graphs([], with_sizes=True)
    assert tuple(stacked.src.shape) == tuple(ref_stacked.src.shape)
    assert stacked.n_vertices == ref_stacked.n_vertices
    assert sizes == ref_sizes == ()
    # a mismatched warm start still raises on an empty fleet
    with pytest.raises(ValueError, match="entries"):
        repro.solve_batch([], warm_start=[np.arange(3)])
    with pytest.raises(ValueError, match="entries"):
        repro_torch.solve_batch([], warm_start=[np.arange(3)], device="cpu")


def test_stack_graphs_matches_the_reference():
    ref_fleet, fleet = _fleet_pair("ragged")
    stacked, sizes = stack_graphs(fleet, with_sizes=True)
    ref_stacked, ref_sizes = ref_batch.stack_graphs(ref_fleet,
                                                    with_sizes=True)
    np.testing.assert_array_equal(stacked.src.numpy(),
                                  np.asarray(ref_stacked.src))
    np.testing.assert_array_equal(stacked.dst.numpy(),
                                  np.asarray(ref_stacked.dst))
    assert stacked.n_vertices == ref_stacked.n_vertices
    assert sizes == ref_sizes


def test_a_prebatched_graph_with_sizes_matches_the_reference():
    ref_fleet, fleet = _fleet_pair("ragged")
    stacked, sizes = stack_graphs(fleet, with_sizes=True)
    ref_stacked, ref_sizes = ref_batch.stack_graphs(ref_fleet,
                                                    with_sizes=True)
    for algorithm in ("contour", "fastsv", "union_find"):
        ref = repro.solve_batch(ref_stacked, batch_sizes=ref_sizes,
                                algorithm=algorithm)
        port = repro_torch.solve_batch(stacked, batch_sizes=sizes,
                                       algorithm=algorithm)
        _same_batch(ref, port)
        assert [r.labels.shape[0] for r in port.unstack()] == list(sizes)
    # without sizes, unstack keeps the padded width
    port = repro_torch.solve_batch(stacked)
    assert all(r.labels.shape[0] == stacked.n_vertices
               for r in port.unstack())


BAD_SIZES = [([3, 4], "entries"), ([0] * 5, "outside"),
             ([10**6] * 5, "outside")]


@pytest.mark.parametrize("sizes,match", BAD_SIZES,
                         ids=["length", "zero", "too_big"])
def test_batch_sizes_errors_match_the_reference(sizes, match):
    ref_fleet, fleet = _fleet_pair("ragged")
    with pytest.raises(ValueError, match=match):
        repro.solve_batch(ref_fleet, batch_sizes=sizes)
    with pytest.raises(ValueError, match=match):
        repro_torch.solve_batch(fleet, batch_sizes=sizes)


def test_warm_start_errors_match_the_reference():
    ref_fleet, fleet = _fleet_pair("ragged")
    for bad, match in [(np.zeros((2, 3), np.int32), "batched warm_start"),
                       (np.zeros(5, np.int32), "batched warm_start"),
                       ([np.arange(3)] * 4, "entries")]:
        with pytest.raises(ValueError, match=match):
            repro.solve_batch(ref_fleet, warm_start=bad)
        with pytest.raises(ValueError, match=match):
            repro_torch.solve_batch(fleet, warm_start=bad)
    with pytest.raises(ValueError, match="does not support batched"):
        repro.solve_batch(ref_fleet, algorithm="oocore")
    with pytest.raises(ValueError, match="does not support batched"):
        repro_torch.solve_batch(fleet, algorithm="oocore")


def test_lanes_past_the_int32_id_space_are_refused_before_a_launch():
    src = torch.zeros((2, 1), dtype=torch.int32)
    g = repro_torch.Graph(src=src, dst=src, n_vertices=1 << 30)
    with pytest.raises(ValueError, match="int32"):
        repro_torch.solve_batch(g)
    with pytest.raises(ValueError, match="int32"):
        contour.contour_labels_batched(src, src, 1 << 30)


def test_single_graph_views_refuse_a_batched_result():
    ref_fleet, fleet = _fleet_pair("mixed")
    ref = repro.solve_batch(ref_fleet)
    port = repro_torch.solve_batch(fleet)
    assert port.is_batched and ref.is_batched
    for res in (ref, port):
        for call in (lambda r: r.n_components,
                     lambda r: r.same_component(0, 1),
                     lambda r: r.component_of(0),
                     lambda r: r.component_sizes()):
            with pytest.raises(ValueError, match="unstack"):
                call(res)
    with pytest.raises(ValueError, match="batched ComponentResult"):
        repro.solve(ref_fleet[0], warm_start=ref)
    with pytest.raises(ValueError, match="batched ComponentResult"):
        repro_torch.solve(fleet[0], warm_start=port)
    one = port.unstack()[1]
    assert not one.is_batched and one.unstack() == [one]
    assert one.n_components == ref.unstack()[1].n_components


# ---------------------------------------------------------------------------
# the fleet's entry points against each lane's single-graph functions
# ---------------------------------------------------------------------------


def _fleet_state(fname, iterations):
    """The fleet's labels after ``iterations`` C-2 iterations, its stacked
    edges and lane count."""
    _, fleet = _fleet_pair(fname)
    st = stack_graphs(fleet)
    n, lanes_b = st.n_vertices, int(st.src.shape[0])
    off = blocked.lane_offsets(lanes_b, n, "cpu")
    L = (torch.arange(n, dtype=torch.int32).expand(lanes_b, n) + off) \
        .reshape(-1)
    for _ in range(iterations):
        L = cv.pointer_jump_batched_plain(
            blocked.fused_relax_batched_plain(L, st.src, st.dst, n), n)
    return L, st.src, st.dst, n, lanes_b, off


def _lane(L, b, n, off):
    return L.view(-1, n)[b] - off[b]


@pytest.mark.parametrize("iterations", [0, 1, 3])
def test_fleet_entry_points_are_each_lanes_own(iterations):
    L, src, dst, n, lanes_b, off = _fleet_state("ragged", iterations)
    lanes = torch.zeros((lanes_b, 4), dtype=torch.int32)
    lanes[1::2, cv.DONE] = 1
    relax = blocked.fused_relax_batched(L, src, dst, n, lanes)
    t, v = contour.mm_update_stream_batched(L, src, dst, n, 1)
    scatter = blocked.scatter_min_batched(L, t, v, n, lanes)
    jump = cv.pointer_jump_batched(L, n, lanes)
    for b in range(lanes_b):
        Lb = _lane(L, b, n, off)
        frozen = b % 2 == 1
        want = Lb if frozen else minmap.mm_relax(Lb, src[b], dst[b], 2)
        assert torch.equal(_lane(relax, b, n, off), want)
        want = Lb if frozen else minmap.mm_relax(Lb, src[b], dst[b], 1)
        assert torch.equal(_lane(scatter, b, n, off), want)
        want = Lb if frozen else minmap.pointer_jump(Lb)
        assert torch.equal(_lane(jump, b, n, off), want)
    # the kernels' wrappers ran their plain versions: no launch
    assert blocked.fused_relax_batched.launches == 0
    assert cv.pointer_jump_batched.launches == 0


@pytest.mark.parametrize("iterations", [0, 1, 2, 6])
def test_fleet_tests_do_each_lanes_step(iterations):
    L, src, dst, n, lanes_b, off = _fleet_state("mixed", iterations)
    state = cv.fleet_state(lanes_b, "cpu")
    state.lanes[0, cv.DONE] = 1
    state.lanes[0, cv.IT] = 7
    cv.converged_early_batched(L, src, dst, n, state)
    want = [bool(minmap.converged_early(_lane(L, b, n, off), src[b], dst[b]))
            for b in range(lanes_b)]
    assert state.lanes[0].tolist() == [1, 7, 0, 0]
    for b in range(1, lanes_b):
        assert state.lanes[b].tolist() == [int(want[b]), 1, 0, 0]
    assert state.fleet[cv.DONE].item() == int(all(want[1:]))
    assert state.fleet[cv.IT].item() == 1
    jumped = cv.pointer_jump_batched_plain(L, n)
    state = cv.fleet_state(lanes_b, "cpu")
    cv.labels_unchanged_batched(jumped, L, n, state)
    for b in range(lanes_b):
        same = torch.equal(_lane(jumped, b, n, off), _lane(L, b, n, off))
        assert state.lanes[b].tolist() == [int(same), 1, 0, 0]


def test_a_done_fleet_takes_no_step():
    L, src, dst, n, lanes_b, _ = _fleet_state("mixed", 0)
    state = cv.fleet_state(lanes_b, "cpu")
    state.lanes[:, cv.DONE] = 1
    state.fleet[cv.DONE] = 1
    before = state.lanes.clone()
    cv.converged_early_batched(L, src, dst, n, state)
    assert torch.equal(state.lanes, before)
    assert state.fleet.tolist()[:2] == [1, 0]


ASYNC_OPTIONS = [{"variant": "C-2"}, {"variant": "C-Syn"},
                 {"variant": "C-m"}, {"sampling": 2, "compact_every": 2}]


@pytest.mark.parametrize("overrides", ASYNC_OPTIONS,
                         ids=[str(o) for o in ASYNC_OPTIONS])
def test_cuda_async_fleet_runs_lane_by_lane_as_the_reference(overrides):
    """``backend="cuda_async"`` (the reference's scalar ``"pallas"``, in
    interpret mode there) runs each lane as a solo solve of its padded
    row: the in-order sweep sees the row's edges in the reference's
    order."""
    arrays = [a.to_numpy() for a in (ref_gen.path(40, seed=1),
                                     ref_gen.rmat(5, seed=2),
                                     ref_gen.star(30, seed=3))]
    ref = repro.solve_batch([repro.Graph.from_numpy(*a) for a in arrays],
                            backend="pallas", **overrides)
    port = repro_torch.solve_batch(
        [interop.graph_from_arrays(*a, device="cpu") for a in arrays],
        backend="cuda_async", **overrides)
    _same_batch(ref, port)
    assert "plan:cuda_async" in port.provenance[0]
