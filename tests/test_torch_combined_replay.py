"""The sweep kernels' reds, replayed in plain torch, against the plain
versions and the JAX package.

``blocked.fused_relax_combined_replay`` and
``blocked.scatter_min_combined_replay`` build the updates the CUDA kernels
turn into reds: an edge's targets ``s, d, L[s], L[d]`` that can lower
their input label, a later copy of an earlier target of the edge dropped,
and the updates of the stream that ``valid`` keeps and that can lower
their target's input label.  They apply those reds and count them, as the
kernels' counters count the updates before the test of the output label,
and count the hot slots of the kernels' warps (a slot's first live
lane's target shared by ``blocked.HOT_LANES`` live lanes), where the
kernels combine a target's lanes into one red.
Their labels are held bit for bit against the plain versions,
``minmap.mm_relax`` and, for n <= 4096, the reference's Pallas kernels in
interpret mode; their red counts against counts made here item by item in
Python, and their hot slots against a count made lane by lane from the
kernels' map of items to (step, slot, lane).  ``chip_smoke.py`` and
``test_torch_cuda.py`` hold the card's counts to the replays'.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.contour_mm import blocked as ref_blocked  # noqa: E402

from repro_torch.connectivity import minmap  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.graphs.structs import Graph  # noqa: E402
from repro_torch.kernels.contour_mm import blocked  # noqa: E402

GRAPHS = ["rmat(10)", "delaunay_like(10)", "star(4096)", "one_hub(4096)",
          "path_unshuffled(4096)"]


def one_hub(n: int) -> Graph:
    """Every edge meets vertex 0."""
    v = np.arange(1, n)
    return Graph.from_numpy(np.zeros(n - 1, np.int64), v, n, device="cpu")


@functools.lru_cache(maxsize=None)
def _graph(name: str) -> Graph:
    return {
        "rmat(10)": lambda: gen.rmat(10, 16, seed=2, device="cpu"),
        "delaunay_like(10)": lambda: gen.delaunay_like(10, device="cpu"),
        "star(4096)": lambda: gen.star(4096, device="cpu"),
        "path_unshuffled(4096)": lambda: gen.path(4096, shuffle_ids=False,
                                                  device="cpu"),
        "one_hub(4096)": lambda: one_hub(4096),
        "rmat(13)": lambda: gen.rmat(13, 16, seed=3, device="cpu"),
    }[name]()


@functools.lru_cache(maxsize=None)
def _states(name: str, count: int = 3):
    """Identity labels and the first ``count`` C-2 iterations' labels."""
    g = _graph(name)
    L = torch.arange(g.n_vertices, dtype=torch.int32)
    states = [L]
    for _ in range(count):
        L = minmap.pointer_jump(minmap.mm_relax(L, g.src, g.dst, 2))
        states.append(L)
    return states


def _expected_fused_reds(L, src, dst, m):
    """Reds the fused kernel issues before its test, counted edge by edge
    in Python: each edge's distinct targets that can lower their label."""
    lab = L.tolist()
    reds = 0
    for s, d in zip(src[:m].tolist(), dst[:m].tolist()):
        ls, ld = lab[s], lab[d]
        z = min(lab[ls], lab[ld])
        targets = {t for t, label in ((s, ls), (d, ld), (ls, lab[ls]),
                                      (ld, lab[ld])) if z < label}
        reds += len(targets)
    return reds


def _expected_hot(slot_targets, per_lane):
    """Hot slots counted lane by lane: item e is lane e % 32 of row
    (e // 32) % per_lane of step e // (32 * per_lane); ``slot_targets[e]``
    lists item e's targets by column, -1 where it has none."""
    items = len(slot_targets)
    width = len(slot_targets[0]) if items else 0
    chunk = 32 * per_lane
    hot = 0
    for step in range(-(-items // chunk)):
        for row in range(per_lane):
            for col in range(width):
                lanes = [slot_targets[e][col] if e < items else -1
                         for e in range(step * chunk + row * 32,
                                        step * chunk + row * 32 + 32)]
                live = [t for t in lanes if t >= 0]
                if live and lanes.count(live[0]) >= blocked.HOT_LANES:
                    hot += 1
    return hot


def _fused_slot_targets(L, src, dst):
    """Each edge's four targets that can lower their label, in the order
    s, d, L[s], L[d], a later copy of an earlier one replaced by -1."""
    lab = L.tolist()
    out = []
    for s, d in zip(src.tolist(), dst.tolist()):
        ls, ld = lab[s], lab[d]
        z = min(lab[ls], lab[ld])
        row = []
        for t, label in ((s, ls), (d, ld), (ls, lab[ls]), (ld, lab[ld])):
            row.append(t if z < label and t not in row else -1)
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# fused_relax (K1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state", [0, 1, 2, 3])
@pytest.mark.parametrize("name", GRAPHS)
def test_fused_replay_equals_mm_relax(name, state):
    g = _graph(name)
    L = _states(name)[state]
    got, counts = blocked.fused_relax_combined_replay(L, g.src, g.dst)
    assert torch.equal(got, minmap.mm_relax(L, g.src, g.dst, 2))
    assert torch.equal(got, blocked.fused_relax_plain(L, g.src, g.dst))
    assert counts["reds_before_test"] == _expected_fused_reds(
        L, g.src, g.dst, g.n_edges)


@pytest.mark.parametrize("state", [0, 1, 2])
@pytest.mark.parametrize("limit", [None, 0, 1, 31, 33, 3000])
def test_fused_replay_matches_pallas_interpret(state, limit):
    g = _graph("rmat(10)")
    L = _states("rmat(10)")[state]
    want = ref_blocked.fused_relax_pallas(
        jnp.asarray(L.numpy()), jnp.asarray(g.src.numpy()),
        jnp.asarray(g.dst.numpy()), interpret=True, edge_limit=limit)
    got, _ = blocked.fused_relax_combined_replay(L, g.src, g.dst, limit)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got,
                       blocked.fused_relax_plain(L, g.src, g.dst, limit))


@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 1), (2, 0)])
@pytest.mark.parametrize("name", ["rmat(10)", "star(4096)", "one_hub(4096)"])
def test_fused_replay_on_slices_and_edge_limits(name, offsets):
    """Slices of the edge list (a base past a 16-byte boundary, src and dst
    at different offsets), ragged lengths and edge limits 1, 31, 33 and
    m // 2: the labels equal the plain version's, the reds the count made
    edge by edge."""
    g = _graph(name)
    src, dst = g.src[offsets[0]:], g.dst[offsets[1]:]
    m = min(src.shape[0], dst.shape[0])
    src, dst = src[:m], dst[:m]
    for L in _states(name)[:2]:
        for limit in (m, 1, 31, 33, m // 2):
            got, counts = blocked.fused_relax_combined_replay(L, src, dst,
                                                              limit)
            assert torch.equal(got, blocked.fused_relax_plain(L, src, dst,
                                                              limit))
            assert counts["reds_before_test"] == _expected_fused_reds(
                L, src, dst, limit)


def test_fused_replay_makes_one_red_an_edge_on_identity_labels():
    """On identity labels with src < dst only d can be lowered (to s), and
    L[d] is d itself: one red an edge, exactly."""
    g = _graph("rmat(13)")
    assert (g.src < g.dst).all()
    _, counts = blocked.fused_relax_combined_replay(_states("rmat(13)")[0],
                                                    g.src, g.dst)
    assert counts["reds_before_test"] == g.n_edges


@pytest.mark.parametrize("name", GRAPHS)
def test_dedupe_control_doubles_the_reds_on_the_first_sweep(name):
    """The control that must differ: without the per-edge dedupe, each
    edge's d and L[d] (one address on identity labels) both send a red,
    so the first sweep counts exactly twice the reds, 2.00 an edge where
    the kernel makes 1.00; the labels are the same."""
    g = _graph(name)
    L = _states(name)[0]
    got, counts = blocked.fused_relax_combined_replay(L, g.src, g.dst)
    ctl, ctl_counts = blocked.fused_relax_combined_replay(L, g.src, g.dst,
                                                          dedupe=False)
    assert torch.equal(got, ctl)
    assert counts["reds_before_test"] == g.n_edges
    assert ctl_counts["reds_before_test"] == 2 * g.n_edges


def test_dedupe_keeps_distinct_targets_apart():
    """Later sweeps: the dedupe drops only copies, so the count falls
    short of the plain version's live (target, condition) pairs by
    exactly the copies."""
    g = _graph("rmat(10)")
    L = _states("rmat(10)")[1]
    reds = blocked.fused_relax_combined_replay(
        L, g.src, g.dst)[1]["reds_before_test"]
    ctl_reds = blocked.fused_relax_combined_replay(
        L, g.src, g.dst, dedupe=False)[1]["reds_before_test"]
    ls, ld = L[g.src], L[g.dst]
    z = torch.minimum(L[ls], L[ld])
    live = int((z < ls).sum() + (z < ld).sum() + (z < L[ls]).sum()
               + (z < L[ld]).sum())
    assert ctl_reds == live
    assert reds == _expected_fused_reds(L, g.src, g.dst, g.n_edges) < live


@pytest.mark.parametrize("per_lane", [1, 2, 4])
@pytest.mark.parametrize("state", [0, 1, 2])
@pytest.mark.parametrize("name", GRAPHS)
def test_fused_hot_slots_equal_a_count_made_lane_by_lane(name, state,
                                                         per_lane):
    g = _graph(name)
    L = _states(name)[state]
    _, counts = blocked.fused_relax_combined_replay(
        L, g.src, g.dst, items_per_lane=per_lane)
    assert counts["hot_slots"] == _expected_hot(
        _fused_slot_targets(L, g.src, g.dst), per_lane)


def test_hot_slots_find_the_hub_and_not_the_mesh():
    """On the star's first sweep every edge's update that lands on the
    hub sits in a slot whose lanes all target it: every step has a hot
    slot.  On the mesh the targets of a slot are spread out: none."""
    g = _graph("star(4096)")
    L = _states("star(4096)")[0]
    t, v = minmap.mm_update_stream(L, g.src, g.dst, 2)
    _, counts = blocked.scatter_min_combined_replay(L, t, v)
    steps = -(-t.shape[0] // (32 * blocked.SCATTER_ITEMS_PER_LANE))
    assert counts["hot_slots"] >= steps // 2
    d = _graph("delaunay_like(10)")
    for L in _states("delaunay_like(10)")[:2]:
        assert blocked.fused_relax_combined_replay(
            L, d.src, d.dst)[1]["hot_slots"] == 0


def test_fused_replay_rejects_ids_outside():
    L = torch.arange(8, dtype=torch.int32)
    with pytest.raises(IndexError):
        blocked.fused_relax_combined_replay(
            L, torch.tensor([0, 8], dtype=torch.int32),
            torch.tensor([1, 2], dtype=torch.int32))
    bad = L.clone()
    bad[3] = 9
    with pytest.raises(IndexError):
        blocked.fused_relax_combined_replay(
            bad, torch.tensor([3], dtype=torch.int32),
            torch.tensor([4], dtype=torch.int32))


# ---------------------------------------------------------------------------
# scatter_min (K2)
# ---------------------------------------------------------------------------


def _expected_scatter_reds(L, t, v, valid):
    lab = L.tolist()
    ok = [True] * len(t) if valid is None else valid.tolist()
    return sum(1 for ti, vi, oi in zip(t.tolist(), v.tolist(), ok)
               if oi and vi < lab[ti])


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("name", ["rmat(10)", "star(4096)",
                                  "one_hub(4096)", "delaunay_like(10)"])
def test_scatter_replay_equals_mm_relax(name, order, with_valid):
    g = _graph(name)
    rng = np.random.default_rng(order)
    for L in _states(name)[:3]:
        t, v = minmap.mm_update_stream(L, g.src, g.dst, order)
        valid = torch.from_numpy(rng.random(t.shape[0]) < 0.5) \
            if with_valid else None
        got, counts = blocked.scatter_min_combined_replay(L, t, v, valid)
        assert torch.equal(got, blocked.scatter_min_plain(L, t, v, valid))
        if valid is None:
            assert torch.equal(got, minmap.mm_relax(L, g.src, g.dst, order))
        assert counts["reds_before_test"] == _expected_scatter_reds(
            L, t, v, valid)


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_scatter_replay_matches_pallas_interpret(order, with_valid):
    g = _graph("rmat(10)")
    L = _states("rmat(10)")[1]
    t, v = minmap.mm_update_stream(L, g.src, g.dst, order)
    valid = np.random.default_rng(order).random(t.shape[0]) < 0.5 \
        if with_valid else None
    want = ref_blocked.binned_scatter_min_pallas(
        jnp.asarray(L.numpy()), jnp.asarray(t.numpy()),
        jnp.asarray(v.numpy()), interpret=True,
        valid=None if valid is None else jnp.asarray(valid))
    got, _ = blocked.scatter_min_combined_replay(
        L, t, v, None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 1, 2),
                                     (2, 0, 3)])
@pytest.mark.parametrize("size", [1, 31, 33, 1000])
def test_scatter_replay_on_slices_and_hubs(offsets, size):
    """Updates piled on a few hub targets, from slices at every offset and
    of ragged lengths: labels equal the plain version's, reds the count
    made update by update."""
    rng = np.random.default_rng(size)
    n = 64
    L = torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
    hubs = np.array([0, 5, 63], np.int32)
    t = torch.from_numpy(rng.choice(hubs, size + 4))[offsets[0]:]
    v = torch.from_numpy(rng.integers(0, n, size + 4)
                         .astype(np.int32))[offsets[1]:]
    ok = torch.from_numpy(rng.random(size + 4) < 0.7)[offsets[2]:]
    t, v, ok = t[:size], v[:size], ok[:size]
    for valid in (None, ok):
        got, counts = blocked.scatter_min_combined_replay(L, t, v, valid)
        assert torch.equal(got, blocked.scatter_min_plain(L, t, v, valid))
        assert counts["reds_before_test"] == _expected_scatter_reds(
            L, t, v, valid)


@pytest.mark.parametrize("per_lane", [1, 4])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("name", ["rmat(10)", "star(4096)", "one_hub(4096)",
                                  "delaunay_like(10)"])
def test_scatter_hot_slots_equal_a_count_made_lane_by_lane(name, with_valid,
                                                           per_lane):
    g = _graph(name)
    rng = np.random.default_rng(per_lane)
    for L in _states(name)[:2]:
        t, v = minmap.mm_update_stream(L, g.src, g.dst, 2)
        valid = torch.from_numpy(rng.random(t.shape[0]) < 0.8) \
            if with_valid else None
        _, counts = blocked.scatter_min_combined_replay(
            L, t, v, valid, items_per_lane=per_lane)
        lab = L.tolist()
        ok = [True] * t.shape[0] if valid is None else valid.tolist()
        targets = [[ti if oi and vi < lab[ti] else -1]
                   for ti, vi, oi in zip(t.tolist(), v.tolist(), ok)]
        assert counts["hot_slots"] == _expected_hot(targets, per_lane)


def test_scatter_replay_rejects_live_targets_outside():
    L = torch.zeros(4, dtype=torch.int32)
    t = torch.tensor([1, 4], dtype=torch.int32)
    v = torch.tensor([0, 0], dtype=torch.int32)
    with pytest.raises(IndexError):
        blocked.scatter_min_combined_replay(L, t, v)
    # a target outside [0, n) whose update is not valid is skipped
    got, counts = blocked.scatter_min_combined_replay(
        L, t, v, torch.tensor([True, False]))
    assert torch.equal(got, L)
    assert counts == {"reds_before_test": 0, "hot_slots": 0}
