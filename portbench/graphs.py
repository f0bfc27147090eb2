"""Seeded graph generators, run on the device in a few large calls.

Frozen with the benchmark: a later change to the program cannot change
the graphs it is measured on.  Every generator draws from a
``torch.Generator`` seeded by the caller, so the same seed on the same
device type gives the same edges.  They return int32 edge lists with
each undirected edge once as ``(lo, hi)``, ``lo < hi``, self-loops
dropped and duplicates merged.

* :func:`kronecker` -- the Graph500 Kronecker generator (spec v3.0):
  ``edgefactor * 2**scale`` edges, each endpoint's bits drawn quadrant by
  quadrant with probabilities A, B, C, D, and every vertex id relabelled
  by one random permutation.
* :func:`rgg` -- DIMACS10's random geometric graphs ``rgg_n_2_<scale>``:
  ``2**scale`` points drawn uniformly in the unit square, an edge between
  every two closer than ``radius * sqrt(ln n / n)``; ids in draw order.

Both hand their edges on in a random order, as the Graph500 generator
ends (``ij(:, randperm(M))``).  A configuration may fix the graph itself
by a seed of its own (``draws_seed``): the run's seed then draws the
order alone, so every run solves the same graph handed in another order.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# edges drawn per block: bounds the scratch of one block at ~1.5 GB
BLOCK = 1 << 26


def canonical_keys(src: torch.Tensor, dst: torch.Tensor,
                   n: int) -> torch.Tensor:
    """``lo * n + hi`` as int64 for every edge that is not a self-loop."""
    lo = torch.minimum(src, dst).long()
    hi = torch.maximum(src, dst).long()
    keep = lo != hi
    return lo[keep] * n + hi[keep]


def split_keys(keys: torch.Tensor, n: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The sorted, merged keys as int32 ``(src, dst)``."""
    keys = torch.unique(keys, sorted=True)
    return (keys // n).int(), (keys % n).int()


def _quadrant_bits(k: int, scale: int, a: float, b: float, c: float,
                   gen: torch.Generator):
    """Row and column ids of ``k`` Kronecker draws (int32)."""
    device = gen.device
    row = torch.zeros(k, dtype=torch.int32, device=device)
    col = torch.zeros(k, dtype=torch.int32, device=device)
    for bit in range(scale):
        u = torch.rand(k, generator=gen, device=device)
        # quadrant 0..3 = A (0,0), B (0,1), C (1,0), D (1,1)
        q = (u >= a).int() + (u >= a + b).int() + (u >= a + b + c).int()
        row |= (q >> 1) << bit
        col |= (q & 1) << bit
    return row, col


def _check_quadrants(A: float, B: float, C: float, D: float) -> None:
    if min(A, B, C, D) < 0 or abs(A + B + C + D - 1.0) > 1e-9:
        raise ValueError(f"A, B, C, D must be >= 0 and sum to 1, got "
                         f"{A}, {B}, {C}, {D}")


def _draws(gen: torch.Generator, draws_seed: Optional[int]):
    """The generator of a graph's own draws: ``gen``, or, where a
    configuration fixes ``draws_seed``, one seeded by it on the same
    device."""
    if draws_seed is None:
        return gen
    fixed = torch.Generator(device=gen.device)
    fixed.manual_seed(int(draws_seed))
    return fixed


def kronecker(scale: int, edgefactor: int, A: float, B: float, C: float,
              D: float, gen: torch.Generator,
              draws_seed: Optional[int] = None):
    """A Graph500 Kronecker graph: ``(src, dst, n)``.  ``draws_seed`` fixes
    the draws and the relabelling."""
    _check_quadrants(A, B, C, D)
    n = 1 << scale
    m = edgefactor * n
    device = gen.device
    draws = _draws(gen, draws_seed)
    perm = torch.randperm(n, generator=draws, device=device).int()
    keys = []
    for lo in range(0, m, BLOCK):
        k = min(BLOCK, m - lo)
        row, col = _quadrant_bits(k, scale, A, B, C, draws)
        keys.append(canonical_keys(perm[row.long()], perm[col.long()], n))
        del row, col
    del perm
    src, dst = split_keys(torch.cat(keys), n)
    del keys
    return (*shuffled(src, dst, gen), n)


# the unit square's neighbouring cells, each unordered pair once
HALF_NEIGHBOURHOOD = ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1))


def rgg(scale: int, radius: float, gen: torch.Generator,
        draws_seed: Optional[int] = None, block: int = 1 << 25):
    """A random geometric graph: ``(src, dst, n)``; ``draws_seed`` fixes
    the points.

    The square is cut into ``g x g`` cells no narrower than the radius
    ``r``, so every edge joins a cell to itself or to one of its eight
    neighbours.  Each cell's points sit in a row of ``K`` slots (``K`` the
    fullest cell's count, empty slots at NaN), and each of the five
    half-neighbourhood offsets compares every slot of a cell with every
    slot of its neighbour, ``block`` pairs at a time.
    """
    n = 1 << scale
    r = radius * math.sqrt(math.log(n) / n)
    device = gen.device
    pts = torch.rand((2, n), generator=_draws(gen, draws_seed),
                     device=device, dtype=torch.float64)
    g = max(1, int(1.0 / r))
    cxy = (pts * g).long().clamp_(max=g - 1)
    cell = cxy[0] * g + cxy[1]
    del cxy
    order = torch.argsort(cell)
    counts = torch.bincount(cell, minlength=g * g)
    k = int(counts.max())
    sorted_cell = cell[order]
    del cell
    slot = (torch.arange(n, device=device)
            - (torch.cumsum(counts, 0) - counts)[sorted_cell])
    where = sorted_cell * k + slot
    del counts, sorted_cell, slot
    ids = torch.zeros(g * g * k, dtype=torch.int32, device=device)
    ids[where] = order.int()
    xy = torch.full((2, g * g * k), math.nan, dtype=torch.float64,
                    device=device)
    xy[:, where] = pts[:, order]
    del pts, order, where
    ids, xy = ids.view(g, g, k), xy.view(2, g, g, k)
    upper = torch.ones(k, k, dtype=torch.bool, device=device).triu(1)
    keys = []
    for dx, dy in HALF_NEIGHBOURHOOD:
        cols_a = slice(max(0, -dy), g - max(0, dy))
        cols_b = slice(max(0, dy), g - max(0, -dy))
        rows = max(1, block // ((g - abs(dy)) * k * k))
        for r0 in range(0, g - dx, rows):
            r1 = min(r0 + rows, g - dx)
            a = xy[:, r0:r1, cols_a, :, None]
            b = xy[:, r0 + dx:r1 + dx, cols_b, None, :]
            hit = ((a - b) ** 2).sum(0) < r * r  # NaN compares false
            if (dx, dy) == (0, 0):
                hit &= upper
            i, j, p, q = hit.nonzero(as_tuple=True)
            keys.append(canonical_keys(ids[r0:r1, cols_a][i, j, p],
                                       ids[r0 + dx:r1 + dx, cols_b][i, j, q],
                                       n))
            del a, b, hit, i, j, p, q
    del ids, xy
    src, dst = split_keys(torch.cat(keys), n)
    del keys
    return (*shuffled(src, dst, gen), n)


def shuffled(src: torch.Tensor, dst: torch.Tensor, gen: torch.Generator):
    """The same edges in a random order."""
    order = torch.randperm(src.shape[0], generator=gen, device=gen.device)
    return src[order], dst[order]
