"""The fleet's no-change test (``converged.labels_unchanged_batched``,
C-Syn's Alg. 1 line 10 over a fleet), on the CPU: the plain replay of
``unchanged_lanes_kernel``'s schedule (``converged.unchanged_batched_replay``:
tiles of one lane in slice-major order, 16-byte items after each lane's
scalar head, the tail as scalars, a tile of a done or witnessed lane
reading nothing) against the plain version's lane and fleet words, bit
for bit, and each lane's flag against the reference's
``jnp.all(L_new == L)`` under ``vmap``.

The labels are made with numpy from a seed.  Three layouts: both arrays
at an aligned base, both one int past it (one 16-byte phase, not 0), and
``b`` alone one int past it (phases differ: items of one label).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402

SIZES = (0, 1, 2, 3, 4, 5, 4097)
LANES = (1, 3, 64)
LAYOUTS = ("aligned", "both_offset", "b_offset")
TILE = cv.UNCHANGED_TILE


def _arrays(lanes_b, n, layout, seed=0):
    """``a`` and a copy ``b`` (``[B * n]`` int32) laid out as ``layout``
    says: views of buffers one int longer, so that an offset of one int
    keeps the length."""
    rng = np.random.default_rng(seed)
    size = lanes_b * n
    base = torch.tensor(rng.integers(0, max(size, 1), size + 1),
                        dtype=torch.int32)
    a_buf, b_buf = base.clone(), base.clone()
    a_off = 1 if layout == "both_offset" else 0
    b_off = 1 if layout in ("both_offset", "b_offset") else 0
    a = a_buf[a_off:a_off + size]
    b = b_buf[b_off:b_off + size]
    b.copy_(a)
    return a, b


def _states(lanes_b, n, a, b, seed=1):
    """``(name, b, lane words)`` cases: the fixed point; every lane
    differing at its first label; every lane at its last; lanes differing
    at random labels, some lanes done."""
    rng = np.random.default_rng(seed)
    zero = torch.zeros((lanes_b, 4), dtype=torch.int32)
    out = [("fixed", b.clone(), zero)]
    if n == 0:
        return out
    for name, v in (("first", 0), ("last", n - 1)):
        x = b.clone()
        x[torch.arange(lanes_b) * n + v] += 1
        out.append((name, x, zero))
    x = b.clone()
    hit = rng.random(lanes_b) < 0.5
    where = rng.integers(0, n, lanes_b)
    for lane in np.flatnonzero(hit):
        x[lane * n + int(where[lane])] -= 1
    words = zero.clone()
    words[1::3, cv.DONE] = 1
    words[1::3, cv.IT] = 5
    out.append(("mixed", x, words))
    return out


def _run(fn, a, b, n, words):
    state = cv.fleet_state(int(words.shape[0]), "cpu")
    state.lanes.copy_(words)
    fn(a, b, n, state)
    return state


def _view_like(x, like):
    """``x``'s values in a view with ``like``'s storage offset."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    off = like.storage_offset()
    out = buf[off:off + x.numel()]
    out.copy_(x)
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("lanes_b", LANES)
@pytest.mark.parametrize("n", SIZES)
def test_replay_matches_the_plain_version(n, lanes_b, layout):
    a, b = _arrays(lanes_b, n, layout)
    for name, x, words in _states(lanes_b, n, a, b):
        x = _view_like(x, b)
        got = cv.fleet_state(lanes_b, "cpu")
        got.lanes.copy_(words)
        cv.unchanged_batched_replay(a, x, n, got)
        want = _run(cv.labels_unchanged_batched_plain, a, x, n, words)
        assert torch.equal(got.lanes, want.lanes), name
        assert torch.equal(got.fleet, want.fleet), name


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", SIZES)
def test_each_lanes_flag_is_the_references(n, layout):
    lanes_b = 3
    a, b = _arrays(lanes_b, n, layout)
    ref = jax.vmap(lambda x, y: jnp.all(x == y))
    for name, x, _ in _states(lanes_b, n, a, b):
        x = _view_like(x, b)
        got = cv.fleet_state(lanes_b, "cpu")
        cv.unchanged_batched_replay(a, x, n, got)
        want = np.asarray(ref(jnp.asarray(a.numpy().reshape(lanes_b, n)),
                              jnp.asarray(x.numpy().reshape(lanes_b, n))))
        assert got.lanes[:, cv.DONE].numpy().astype(bool).tolist() \
            == want.tolist(), name


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", (1, 2, 3, 4, 5, 7, 9, TILE + 5, 2 * TILE + 1))
def test_every_label_is_compared_once(n, layout):
    """At the fixed point each live lane's tiles read ``n`` labels in all,
    and a difference at any one label witnesses its lane: each label is
    read exactly once (the head, the items, the tail)."""
    lanes_b = 3
    a, b = _arrays(lanes_b, n, layout, seed=n)
    state = cv.fleet_state(lanes_b, "cpu")
    reads = cv.unchanged_batched_replay(a, b, n, state)
    assert reads.sum(1).tolist() == [n] * lanes_b
    assert state.lanes[:, cv.DONE].tolist() == [1] * lanes_b
    picks = sorted({0, 1, 2, 3, 4, n // 2, TILE - 1, TILE, TILE + 1,
                    n - 4, n - 3, n - 2, n - 1} & set(range(n)))
    for lane in range(lanes_b):
        for v in picks:
            x = b.clone()
            x[lane * n + v] += 1
            x = _view_like(x, b)
            state = cv.fleet_state(lanes_b, "cpu")
            cv.unchanged_batched_replay(a, x, n, state)
            assert state.lanes[:, cv.DONE].tolist() == [
                int(other != lane) for other in range(lanes_b)], (lane, v)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_layout_is_the_launchers(layout):
    """16-byte items where the phases agree, each lane's first item on a
    16-byte boundary of both arrays (lanes of 7 labels start at every
    phase)."""
    lanes_b, n = 4, 7
    a, b = _arrays(lanes_b, n, layout)
    width, phase = cv.unchanged_layout(a, b)
    assert width == (1 if layout == "b_offset" else 4)
    if width == 4:
        assert (a.data_ptr() // 4 - phase) % 4 == 0
        for lane in range(lanes_b):
            head, items = cv.unchanged_lane_parts(n, lane, width, phase)
            for x in (a, b):
                assert (x.data_ptr() + 4 * (lane * n + head)) % 16 == 0
            assert 0 <= head < 4 and 0 <= n - head - 4 * items < 4


def test_a_witnessed_lane_reads_only_its_first_tile():
    """Lanes differing at their first label read one tile each; lanes
    differing only at their last read every tile; done lanes read
    nothing."""
    lanes_b, n = 4, 3 * TILE + 10
    a, b = _arrays(lanes_b, n, "aligned")
    x = b.clone()
    x[0 * n] += 1          # lane 0: its first label
    x[1 * n + n - 1] += 1  # lane 1: its last
    state = cv.fleet_state(lanes_b, "cpu")
    state.lanes[3, cv.DONE] = 1
    reads = cv.unchanged_batched_replay(a, x, n, state)
    assert reads.shape == (lanes_b, 4)
    assert (reads[0, 1:] == 0).all() and reads[0, 0] > 0
    assert (reads[1] > 0).all() and int(reads[1].sum()) == n
    assert int(reads[2].sum()) == n
    assert int(reads[3].sum()) == 0
    assert state.lanes[:, cv.DONE].tolist() == [0, 0, 1, 1]
    assert state.lanes[:, cv.IT].tolist() == [1, 1, 1, 0]


def test_a_done_fleet_reads_nothing():
    lanes_b, n = 3, 9
    a, b = _arrays(lanes_b, n, "aligned")
    x = b.clone()
    x[0] += 1
    # the state the loop leaves: every lane done, and the fleet
    state = cv.fleet_state(lanes_b, "cpu")
    state.lanes[:, cv.DONE] = 1
    state.fleet[cv.DONE] = 1
    before = (state.lanes.clone(), state.fleet.clone())
    assert int(cv.unchanged_batched_replay(a, x, n, state).sum()) == 0
    assert torch.equal(state.lanes, before[0])
    assert torch.equal(state.fleet, before[1])
    want = _run(cv.labels_unchanged_batched_plain, a, x, n, before[0])
    want.fleet[cv.DONE] = 1
    assert torch.equal(want.lanes, before[0])
    # the kernel returns at once on the fleet's done word, whatever the
    # lanes' words say
    state.lanes[0, cv.DONE] = 0
    before = state.lanes.clone()
    cv.unchanged_batched_replay(a, x, n, state)
    assert torch.equal(state.lanes, before)


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    lanes_b, n = 3, 5
    a, b = _arrays(lanes_b, n, "b_offset")
    for name, x, words in _states(lanes_b, n, a, b):
        launches = cv.labels_unchanged_batched.launches
        got = _run(cv.labels_unchanged_batched, a, x, n, words)
        want = _run(cv.labels_unchanged_batched_plain, a, x, n, words)
        assert cv.labels_unchanged_batched.launches == launches
        assert torch.equal(got.lanes, want.lanes), name
        assert torch.equal(got.fleet, want.fleet), name
