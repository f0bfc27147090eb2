"""The fleet's lane route (``kernels/contour_mm/fleet.py``), on the CPU:
the plain replays of its four kernels' schedules against the plain
versions and, lane by lane, against the reference, bit for bit; and the
route's choice by shape.

A replay runs the lane kernels block by block as the card does: each
block copies its lane's labels, takes one of ``c`` slices of the lane's
edges (K2: of each of its runs of updates; K7: of its labels), sweeps
(K1), scatters (K2), tests (K6, tile by tile, stopping at the first tile
with a witness) or jumps (K7) and merges what it found.  The fleets are made with numpy
from a seed: lanes of different sizes padded to one ``n`` and ``m`` (``m``
not a multiple of the tile), some lanes frozen, and a label that points
outside its lane.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.connectivity import minmap as ref_mm  # noqa: E402

from repro_torch.connectivity import contour  # noqa: E402
from repro_torch.kernels.contour_mm import blocked  # noqa: E402
from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402
from repro_torch.kernels.contour_mm import fleet  # noqa: E402

N = 150
TILE = fleet.SHAPES["converged"].tile   # K6's tile
M = TILE * 2 + 37   # not a multiple of the tile
LANES = (1, 8, 33)
BLOCKS = (1, 2, 5)


def _fleet(lanes_b, seed=0):
    """``[B, M]`` edges of random graphs with ``N // 3`` to ``N``
    vertices (their own ids), padded with ``(0, 0)``; each lane's edge
    count varies."""
    rng = np.random.default_rng(seed)
    src = np.zeros((lanes_b, M), np.int64)
    dst = np.zeros((lanes_b, M), np.int64)
    for b in range(lanes_b):
        n_b = int(rng.integers(N // 3, N + 1))
        m_b = int(rng.integers(M // 2, M + 1))
        src[b, :m_b] = rng.integers(0, n_b, m_b)
        dst[b, :m_b] = rng.integers(0, n_b, m_b)
    return (torch.tensor(src, dtype=torch.int32),
            torch.tensor(dst, dtype=torch.int32))


def _states(src, dst, count=3):
    """The fleet's labels from identity through ``count`` C-2
    iterations."""
    lanes_b = int(src.shape[0])
    off = blocked.lane_offsets(lanes_b, N, "cpu")
    L = (torch.arange(N, dtype=torch.int32).expand(lanes_b, N) + off) \
        .reshape(-1).contiguous()
    out = [L]
    for _ in range(count):
        L = cv.pointer_jump_batched_plain(
            blocked.fused_relax_batched_plain(L, src, dst, N), N)
        out.append(L)
    return out


def _outside(L):
    """``L`` with lane 0's vertices 1 and 2 pointing into the last lane
    (a fleet of one lane: unchanged)."""
    lanes_b = int(L.shape[0]) // N
    out = L.clone()
    if lanes_b > 1:
        out[1] = (lanes_b - 1) * N
        out[2] = (lanes_b - 1) * N + 5
    return out


def _frozen(lanes_b):
    lanes = torch.zeros((lanes_b, 4), dtype=torch.int32)
    lanes[1::3, cv.DONE] = 1
    return lanes


def _lane(L, b):
    return L.view(-1, N)[b] - b * N


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("lanes_b", LANES)
def test_relax_replay_matches_the_plain_version(lanes_b, blocks):
    src, dst = _fleet(lanes_b, seed=lanes_b)
    for L in _states(src, dst):
        for labels in (L, _outside(L)):
            for lanes in (None, _frozen(lanes_b)):
                want = blocked.fused_relax_batched_plain(labels, src, dst, N,
                                                         lanes)
                got = fleet.relax_lane_replay(labels, src, dst, N, lanes,
                                              blocks_per_lane=blocks)
                assert torch.equal(got, want)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_relax_replay_matches_the_reference_lane_by_lane(blocks):
    lanes_b = 8
    src, dst = _fleet(lanes_b, seed=3)
    lanes = _frozen(lanes_b)
    for L in _states(src, dst):
        got = fleet.relax_lane_replay(L, src, dst, N, lanes,
                                      blocks_per_lane=blocks)
        for b in range(lanes_b):
            Lb = _lane(L, b).numpy()
            want = Lb if lanes[b, cv.DONE] else np.asarray(ref_mm.mm_relax(
                jnp.asarray(Lb), jnp.asarray(src[b].numpy()),
                jnp.asarray(dst[b].numpy()), 2))
            np.testing.assert_array_equal(_lane(got, b).numpy(), want)


def _words(lanes_b, lanes):
    state = cv.fleet_state(lanes_b, "cpu")
    if lanes is not None:
        state.lanes.copy_(lanes)
    return state


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("lanes_b", LANES)
def test_converged_replay_matches_the_plain_version(lanes_b, blocks):
    src, dst = _fleet(lanes_b, seed=10 + lanes_b)
    states = _states(src, dst, count=8)
    for L in states + [_outside(states[-1])]:
        for lanes in (None, _frozen(lanes_b)):
            want = _words(lanes_b, lanes)
            cv.converged_early_batched_plain(L, src, dst, N, want)
            got = _words(lanes_b, lanes)
            fleet.converged_lane_replay(L, src, dst, N, got,
                                        blocks_per_lane=blocks)
            assert torch.equal(got.lanes, want.lanes)
            assert torch.equal(got.fleet, want.fleet)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_converged_replay_matches_the_reference_lane_by_lane(blocks):
    lanes_b = 33
    src, dst = _fleet(lanes_b, seed=4)
    lanes = _frozen(lanes_b)
    for L in _states(src, dst, count=8):
        state = _words(lanes_b, lanes)
        fleet.converged_lane_replay(L, src, dst, N, state,
                                    blocks_per_lane=blocks)
        for b in range(lanes_b):
            if lanes[b, cv.DONE]:
                assert state.lanes[b].tolist() == [1, 0, 0, 0]
                continue
            ok = bool(ref_mm.converged_early(
                jnp.asarray(_lane(L, b).numpy()),
                jnp.asarray(src[b].numpy()), jnp.asarray(dst[b].numpy())))
            assert state.lanes[b].tolist() == [int(ok), 1, 0, 0]


def test_a_live_lane_streams_one_tile():
    """From identity every lane with an edge between two vertices is
    live at its first tile; at the fixed point every block streams its
    whole slice."""
    lanes_b, blocks = 8, 2
    src, dst = _fleet(lanes_b, seed=5)
    states = _states(src, dst, count=12)
    tiles = fleet.converged_lane_replay(states[0], src, dst, N,
                                        _words(lanes_b, None),
                                        blocks_per_lane=blocks)
    assert tiles[:, 0].tolist() == [1] * lanes_b
    assert int(tiles.sum()) < lanes_b * blocks * 2
    fixed = cv.fleet_state(lanes_b, "cpu")
    cv.converged_early_batched_plain(states[-1], src, dst, N, fixed)
    assert bool(fixed.lanes[:, cv.DONE].all())
    tiles = fleet.converged_lane_replay(states[-1], src, dst, N,
                                        _words(lanes_b, None),
                                        blocks_per_lane=blocks)
    per_slice = [-(-(hi - lo) // TILE) for lo, hi in
                 (fleet.slice_bounds(M, blocks, p) for p in range(blocks))]
    assert tiles.tolist() == [per_slice] * lanes_b


def test_a_done_fleet_streams_nothing():
    lanes_b = 8
    src, dst = _fleet(lanes_b, seed=6)
    state = _words(lanes_b, torch.ones((lanes_b, 4), dtype=torch.int32)
                   * torch.tensor([1, 3, 0, 0], dtype=torch.int32))
    state.fleet[cv.DONE] = 1
    tiles = fleet.converged_lane_replay(_states(src, dst)[0], src, dst, N,
                                        state)
    assert int(tiles.sum()) == 0
    assert state.lanes[:, cv.IT].tolist() == [3] * lanes_b
    assert state.fleet.tolist() == [1, 0, 0, 0]


def test_slices_cover_the_lane_once():
    for m in (0, 1, 7, M):
        for c in BLOCKS:
            bounds = [fleet.slice_bounds(m, c, p) for p in range(c)]
            assert bounds[0][0] == 0 and bounds[-1][1] == m
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_jump_slices_cover_the_lane_once_in_vectors():
    for n in (1, 7, N, 4096):
        for c in BLOCKS:
            bounds = [fleet.jump_bounds(n, c, p) for p in range(c)]
            assert bounds[0][0] == 0 and bounds[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
            assert all(lo % 4 == 0 or lo == n for lo, _ in bounds)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("lanes_b", LANES)
def test_scatter_replay_matches_the_plain_version(lanes_b, blocks):
    src, dst = _fleet(lanes_b, seed=20 + lanes_b)
    for L in _states(src, dst, count=1):
        for labels in (L, _outside(L)):
            for lanes in (None, _frozen(lanes_b)):
                for order in (1, 2, 3):
                    t, v = contour.mm_update_stream_batched(labels, src, dst,
                                                            N, order)
                    want = blocked.scatter_min_batched_plain(labels, t, v, N,
                                                             lanes)
                    got = fleet.scatter_lane_replay(
                        labels, t, v, N, lanes, run=M,
                        blocks_per_lane=blocks)
                    assert torch.equal(got, want), order


@pytest.mark.parametrize("blocks", BLOCKS)
def test_scatter_replay_matches_the_reference_lane_by_lane(blocks):
    lanes_b = 8
    src, dst = _fleet(lanes_b, seed=8)
    lanes = _frozen(lanes_b)
    for L in _states(src, dst, count=2):
        for order in (1, 3):
            t, v = contour.mm_update_stream_batched(L, src, dst, N, order)
            got = fleet.scatter_lane_replay(L, t, v, N, lanes, run=M,
                                            blocks_per_lane=blocks)
            for b in range(lanes_b):
                Lb = _lane(L, b).numpy()
                want = Lb if lanes[b, cv.DONE] else np.asarray(
                    ref_mm.mm_relax(jnp.asarray(Lb),
                                    jnp.asarray(src[b].numpy()),
                                    jnp.asarray(dst[b].numpy()), order))
                np.testing.assert_array_equal(_lane(got, b).numpy(), want)


def test_a_frozen_lane_still_sends_its_updates_to_live_lanes():
    """A K2 update is frozen by its target's lane, not by the run it sits
    in: a frozen lane's run that targets a live lane still lowers it."""
    lanes_b = 3
    L = torch.arange(lanes_b * N, dtype=torch.int32)
    lanes = torch.zeros((lanes_b, 4), dtype=torch.int32)
    lanes[0, cv.DONE] = 1
    t = torch.full((lanes_b * M,), 0, dtype=torch.int32)
    v = torch.zeros_like(t)
    t[:M] = 2 * N + 7          # lane 0's run: into live lane 2
    t[M:2 * M] = 0             # lane 1's run: into frozen lane 0
    t[2 * M:] = 2 * N + 9      # lane 2's own
    want = blocked.scatter_min_batched_plain(L, t, v, N, lanes)
    assert int(want[2 * N + 7]) == 0 and int(want[0]) == 0
    assert int(want[2 * N + 9]) == 0
    for blocks in BLOCKS:
        assert torch.equal(fleet.scatter_lane_replay(
            L, t, v, N, lanes, run=M, blocks_per_lane=blocks), want)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("lanes_b", LANES)
def test_jump_replay_matches_the_plain_version(lanes_b, blocks):
    src, dst = _fleet(lanes_b, seed=30 + lanes_b)
    states = _states(src, dst, count=3)
    for L in states + [_outside(states[1])]:
        for lanes in (None, _frozen(lanes_b)):
            want = cv.pointer_jump_batched_plain(L, N, lanes)
            got = fleet.jump_lane_replay(L, N, lanes,
                                         blocks_per_lane=blocks)
            assert torch.equal(got, want)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_jump_replay_matches_the_reference_lane_by_lane(blocks):
    lanes_b = 8
    src, dst = _fleet(lanes_b, seed=9)
    lanes = _frozen(lanes_b)
    for L in _states(src, dst, count=3):
        # a state part-way through a sweep, with chains to jump
        L = blocked.fused_relax_batched_plain(L, src, dst, N)
        got = fleet.jump_lane_replay(L, N, lanes, blocks_per_lane=blocks)
        for b in range(lanes_b):
            Lb = _lane(L, b).numpy()
            want = Lb if lanes[b, cv.DONE] else np.asarray(
                ref_mm.pointer_jump(jnp.asarray(Lb)))
            np.testing.assert_array_equal(_lane(got, b).numpy(), want)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

# 1024 x rmat(12,16) as chip_smoke.py stacks it: 4096 vertices and 48,736
# padded edges a lane
RMAT_FLEET = (4096, 1024, 48_736)


KINDS = ["relax", "converged", "scatter", "jump"]


def _items(kind, n, m):
    """What a lane's blocks share: its edges (K1, K6), a run of updates
    (K2, ``run = m``) or its labels (K7)."""
    return n if kind == "jump" else m


@pytest.mark.parametrize("kind", KINDS)
def test_the_rmat_fleet_takes_the_lane_route_with_one_block(kind):
    n, lanes_b, m = RMAT_FLEET
    assert fleet.fleet_route(n, lanes_b, _items(kind, n, m), kind,
                             fleet.H100) == fleet.FleetRoute("lane", 1)


def test_the_rmat_fleet_takes_the_lane_routes_of_k2_and_k7():
    n, lanes_b, m = RMAT_FLEET
    assert fleet.scatter_route(n, lanes_b, m, fleet.H100) == \
        fleet.FleetRoute("lane", 1)
    assert fleet.jump_route(n, lanes_b, fleet.H100) == \
        fleet.FleetRoute("lane", 1)


@pytest.mark.parametrize("kind", KINDS)
def test_a_small_fleet_splits_its_lanes(kind):
    n, _, m = RMAT_FLEET
    if kind == "jump":  # K7 splits a lane's labels: a lane of 2**15
        n = 1 << 15
    items = _items(kind, n, m)
    route = fleet.fleet_route(n, 8, items, kind, fleet.H100)
    assert route.route == "lane" and route.blocks_per_lane > 1
    # the lanes fill the card's block slots, each slice a few tiles
    shape = fleet.SHAPES[kind]
    assert 8 * route.blocks_per_lane <= shape.min_blocks * fleet.H100.sms
    assert -(-items // route.blocks_per_lane) >= \
        fleet.MIN_SLICE_TILES * shape.tile
    # a lane of few items is not split below the least slice
    assert fleet.fleet_route(n, 8, 100, kind, fleet.H100).blocks_per_lane \
        == 1


@pytest.mark.parametrize("kind", KINDS)
def test_lanes_above_the_cap_take_the_global_route(kind):
    cap = fleet.lane_cap(kind, fleet.H100)
    assert fleet.lane_smem_bytes(cap, kind) <= fleet.H100.smem_block
    assert fleet.lane_smem_bytes(cap + 1, kind) > fleet.H100.smem_block
    assert fleet.fleet_route(cap, 4, 10_000, kind, fleet.H100).route == \
        "lane"
    assert fleet.fleet_route(cap + 1, 4, 10_000, kind, fleet.H100) == \
        fleet.GLOBAL
    # K1 holds two label arrays, the others one: delaunay_like(14)'s 2**14
    # fit each
    assert cap >= 1 << 14


def test_k2_and_k7_above_the_cap_take_the_global_route():
    for kind, route in (("scatter", lambda n: fleet.scatter_route(
            n, 4, 10_000, fleet.H100)),
            ("jump", lambda n: fleet.jump_route(n, 4, fleet.H100))):
        cap = fleet.lane_cap(kind, fleet.H100)
        assert route(cap).route == "lane", kind
        assert route(cap + 1) == fleet.GLOBAL, kind


def test_a_stream_of_no_stated_layout_takes_the_global_route():
    n, lanes_b, _ = RMAT_FLEET
    assert fleet.scatter_route(n, lanes_b, None, fleet.H100) == fleet.GLOBAL
    assert fleet.stream_segments(12345, lanes_b, None) == 0


def test_a_stream_of_partial_segments_raises():
    lanes_b = 8
    src, dst = _fleet(lanes_b, seed=11)
    L = _states(src, dst, count=1)[1]
    t, v = contour.mm_update_stream_batched(L, src, dst, N, 2)
    assert fleet.stream_segments(int(t.shape[0]), lanes_b, M) == 4
    for tt, vv, run in ((t[:-1], v[:-1], M), (t, v, M + 1), (t, v, 0),
                        (t, v, -M)):
        with pytest.raises(ValueError):
            fleet.stream_segments(int(tt.shape[0]), lanes_b, run)
        with pytest.raises(ValueError):
            blocked.scatter_min_batched(L, tt, vv, N, run=run)
    # without a layout any stream is taken
    assert torch.equal(
        blocked.scatter_min_batched(L, t[:-1], v[:-1], N),
        blocked.scatter_min_batched_plain(L, t[:-1], v[:-1], N))


def test_route_errors():
    with pytest.raises(ValueError, match="kind"):
        fleet.fleet_route(10, 1, 10, "sweep", fleet.H100)


def test_the_shapes_follow_the_kernels_order():
    # csrc/fleet.cu's contour_fleet_shapes reports five ints a kernel in
    # this order
    assert list(fleet.SHAPES) == KINDS
    assert fleet.SHAPES["jump"].ring_bytes == 0
    assert fleet.SHAPES["scatter"].label_arrays == 1


def test_cpu_tensors_run_the_plain_versions_on_no_route():
    lanes_b = 8
    src, dst = _fleet(lanes_b, seed=7)
    L = _states(src, dst)[1]
    t, v = contour.mm_update_stream_batched(L, src, dst, N, 1)
    wrappers = (blocked.fused_relax_batched, cv.converged_early_batched,
                blocked.scatter_min_batched, cv.pointer_jump_batched)
    before = [dict(w.routes) for w in wrappers]
    blocked.fused_relax_batched(L, src, dst, N)
    cv.converged_early_batched(L, src, dst, N, cv.fleet_state(lanes_b,
                                                              "cpu"))
    assert torch.equal(blocked.scatter_min_batched(L, t, v, N, run=M),
                       blocked.scatter_min_batched_plain(L, t, v, N))
    assert torch.equal(cv.pointer_jump_batched(L, N),
                       cv.pointer_jump_batched_plain(L, N))
    assert [w.routes for w in wrappers] == before
    with pytest.raises(ValueError, match="CUDA"):
        blocked.fused_relax_batched_on(fleet.FleetRoute("lane"), L, src,
                                       dst, N)
    with pytest.raises(ValueError, match="CUDA"):
        cv.converged_early_batched_on(fleet.GLOBAL, L, src, dst, N,
                                      cv.fleet_state(lanes_b, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        blocked.scatter_min_batched_on(fleet.FleetRoute("lane"), L, t, v, N,
                                       run=M)
    with pytest.raises(ValueError, match="CUDA"):
        cv.pointer_jump_batched_on(fleet.GLOBAL, L, N)
