"""The benchmark's graph generators on the CPU, at toy sizes."""
import math

import pytest

torch = pytest.importorskip("torch")

from portbench import graphs, reference  # noqa: E402

KRON = dict(edgefactor=16, A=0.57, B=0.19, C=0.19, D=0.05)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def canonical(src, dst, n):
    assert src.dtype == dst.dtype == torch.int32
    assert bool((src < dst).all()) and int(dst.max()) < n
    key = src.long() * n + dst.long()
    assert key.unique().numel() == key.numel()  # no duplicates


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 33 + 1])
def test_kronecker_same_seed_same_edges(seed):
    a = graphs.kronecker(9, **KRON, gen=gen(seed))
    b = graphs.kronecker(9, **KRON, gen=gen(seed))
    c = graphs.kronecker(9, **KRON, gen=gen(seed + 1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[2] == 512
    assert not (a[0].shape == c[0].shape and torch.equal(a[0], c[0]))
    canonical(*a)
    assert a[0].shape[0] <= 16 * 512


def test_kronecker_is_skewed_and_keeps_most_edges():
    src, dst, n = graphs.kronecker(12, **KRON, gen=gen(3))
    deg = torch.bincount(torch.cat([src, dst]).long(), minlength=n)
    assert src.shape[0] > 0.6 * 16 * n
    assert int(deg.max()) > 20 * float(deg.float().mean())


def test_kronecker_refuses_bad_probabilities():
    with pytest.raises(ValueError):
        graphs.kronecker(5, 16, 0.5, 0.2, 0.2, 0.2, gen=gen(0))


@pytest.mark.parametrize("make", [
    lambda g, **kw: graphs.kronecker(10, **KRON, gen=g, **kw),
    lambda g, **kw: graphs.rgg(10, 0.55, g, **kw)], ids=["kronecker", "rgg"])
def test_edges_come_in_random_order(make):
    src, dst, n = make(gen(8))
    key = src.long() * n + dst.long()
    rises = float((key[1:] > key[:-1]).float().mean())
    assert 0.4 < rises < 0.6  # a sorted list rises at every step


@pytest.mark.parametrize("make", [
    lambda g, **kw: graphs.kronecker(9, **KRON, gen=g, **kw),
    lambda g, **kw: graphs.rgg(10, 0.55, g, **kw)], ids=["kronecker", "rgg"])
def test_a_fixed_draw_is_one_graph_in_orders_drawn_from_the_seed(make):
    a = make(gen(1), draws_seed=77)
    b = make(gen(2), draws_seed=77)
    c = make(gen(1), draws_seed=78)
    n = a[2]
    keys = [(g[0].long() * n + g[1].long()) for g in (a, b, c)]
    assert not torch.equal(keys[0], keys[1])
    assert torch.equal(keys[0].sort().values, keys[1].sort().values)
    assert not (keys[0].shape == keys[2].shape
                and torch.equal(keys[0].sort().values, keys[2].sort().values))


def brute_rgg(scale, radius, seed):
    n = 1 << scale
    pts = torch.rand((2, n), generator=gen(seed), dtype=torch.float64)
    r = radius * math.sqrt(math.log(n) / n)
    near = ((pts[:, :, None] - pts[:, None, :]) ** 2).sum(0) < r * r
    lo, hi = torch.nonzero(torch.triu(near, 1), as_tuple=True)
    return (lo * n + hi).sort().values


@pytest.mark.parametrize("scale,seed,block", [(5, 1, 1 << 25), (9, 2, 64),
                                              (11, 2 ** 33 + 1, 1 << 12)])
def test_rgg_equals_a_brute_force_search(scale, seed, block):
    src, dst, n = graphs.rgg(scale, 0.55, gen(seed), block=block)
    assert n == 1 << scale
    canonical(src, dst, n)
    assert torch.equal((src.long() * n + dst.long()).sort().values,
                       brute_rgg(scale, 0.55, seed))
    again = graphs.rgg(scale, 0.55, gen(seed))
    assert torch.equal(src, again[0]) and torch.equal(dst, again[1])


def test_rgg_degree_follows_the_radius():
    # n pi r^2 = 0.55^2 pi ln n neighbours, less at the square's edges
    src, dst, n = graphs.rgg(14, 0.55, gen(3))
    mean = 2 * src.shape[0] / n
    assert 0.9 * 0.55 ** 2 * math.pi * math.log(n) < mean \
        < 0.55 ** 2 * math.pi * math.log(n)


def test_shuffled_keeps_the_edges():
    src, dst, n = graphs.rgg(8, 0.55, gen(6))
    s, d = graphs.shuffled(src, dst, gen(7))
    assert not torch.equal(s, src)
    key = (s.long() * n + d.long()).sort().values
    assert torch.equal(key, (src.long() * n + dst.long()).sort().values)
