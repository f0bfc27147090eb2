"""Work-adaptive edge-frontier contraction for the min-mapping fixpoint.

The port's counterpart of ``repro.connectivity.frontier`` (DESIGN.md
§10, §16).  Three mechanisms cut the edges each sweep touches, with the
fixed point unchanged:

1. **Sampling phase** — the first ``sampling`` iterations sweep only a
   sample of the edge list.  A :class:`SamplingStrategy` picks it and
   reduces to a permutation of the edge list plus a prefix width:
   ``"prefix"`` (the first ``m // 4`` edges), ``"kout"`` (each vertex's
   first ``k`` incident edges, Afforest) or ``"bfs"`` (balls grown
   around the highest-degree vertices).
2. **Skip-the-largest-component filter** — right after the sampling
   phase, every edge both of whose endpoints contract into the most
   frequent label is retired.
3. **Periodic contraction** — every ``compact_every`` iterations the
   active edges are rewritten to their depth-2 representatives ``L²[v]``
   and the self-loops this makes are retired, by a stable partition into
   an ``[active | retired]`` layout with ``active_m`` live edges.

Sweeps and the convergence check then touch only the active prefix, and
``edges_visited`` counts the per-sweep bounds (a float32 sum, as the
reference's) instead of ``iterations * m``.

The reference keeps the loop on the device inside one
``lax.while_loop``.  Here the loop runs on the host, which already knows
every bound: ``active_m``, the sample width and each sweep's limit are
Python ints.  The device→host reads are one convergence flag per
iteration, one survivor count per contraction, the sample width once for
``kout``/``bfs``, and one star-forest flag per round of the final
:func:`compress_full`.  The iteration's branch (filter, contraction or
none) is a host branch on the iteration counter where the reference used
``lax.switch``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.kernels.contour_mm import converged as cv

# The deterministic sampling prefix is m // SAMPLE_PREFIX_DENOM edges (at
# least 1: a zero-width prefix would make every sampling iteration a
# no-op that burns the budget).
SAMPLE_PREFIX_DENOM = 4

# k-out/Afforest sampling: incident edges each vertex contributes
# (SolveOptions.sampling_k's default).
DEFAULT_SAMPLING_K = 2

# BFS sampling: balls of this radius around this many top-degree seeds.
BFS_SAMPLE_SEEDS = 16
BFS_SAMPLE_ROUNDS = 4


def sample_prefix_m(n_edges: int) -> int:
    """Size of the deterministic edge-prefix sample."""
    return max(1, n_edges // SAMPLE_PREFIX_DENOM)


def stable_partition(src: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable two-way partition of an edge list into ``[keep | rest]``.

    Keepers land at their keep-rank, the rest after the last keeper at
    their rest-rank; both ranks grow with position, so each class keeps
    its order.  Returns ``(src', dst', n_keep)`` with ``n_keep`` a 0-d
    tensor on the edges' device (not read here).
    """
    k = keep.to(torch.int64)
    n_keep = k.sum()
    dest = torch.where(keep, torch.cumsum(k, 0) - 1,
                       n_keep + torch.cumsum(1 - k, 0) - 1)
    out_s = torch.empty_like(src).scatter_(0, dest, src)
    out_d = torch.empty_like(dst).scatter_(0, dest, dst)
    return out_s, out_d, n_keep


def _occurrence_rank(x: torch.Tensor) -> torch.Tensor:
    """``rank[i]`` = how many earlier positions hold the value ``x[i]``.

    A stable argsort groups equal values in list order (``torch.argsort``
    is stable only when asked), and a cummax over group starts gives each
    group's base offset.
    """
    m = x.shape[0]
    if m == 0:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    order = torch.argsort(x, stable=True)
    xs = x[order]
    idx = torch.arange(m, dtype=torch.int64, device=x.device)
    starts = torch.ones(m, dtype=torch.bool, device=x.device)
    starts[1:] = xs[1:] != xs[:-1]
    group_start = torch.cummax(torch.where(starts, idx, 0), 0).values
    rank = torch.empty(m, dtype=torch.int32, device=x.device)
    return rank.scatter_(0, order, (idx - group_start).to(torch.int32))


def _prepare_prefix(src, dst, n_vertices, k):
    """The deterministic edge prefix: identity permutation."""
    del n_vertices, k
    return src, dst, sample_prefix_m(src.shape[0])


def _prepare_kout(src, dst, n_vertices, k):
    """Afforest/k-out sample: each vertex's first ``k`` incident edges (in
    edge-list order, either endpoint), stably moved to the front."""
    del n_vertices
    m = src.shape[0]
    if m == 0:
        return src, dst, 0
    sampled = (_occurrence_rank(src) < k) | (_occurrence_rank(dst) < k)
    out_s, out_d, sample_m = stable_partition(src, dst, sampled)
    with trace.span("read.sample_width"):
        sample_m = int(sample_m)
    # >= 1: rank 0 of any endpoint is always sampled
    return out_s, out_d, max(sample_m, 1)


def _prepare_bfs(src, dst, n_vertices, k):
    """BFS sample: grow balls of radius ``BFS_SAMPLE_ROUNDS`` around the
    ``BFS_SAMPLE_SEEDS`` highest-degree vertices; sample every edge with
    an endpoint in a ball."""
    del k
    m = src.shape[0]
    if m == 0:
        return src, dst, 0
    deg = (torch.bincount(src, minlength=n_vertices)
           + torch.bincount(dst, minlength=n_vertices))
    # lax.top_k breaks ties toward the lower index; a stable descending
    # sort does the same (torch.topk promises no order among ties)
    order = torch.sort(deg, descending=True, stable=True).indices
    seeds = order[:min(BFS_SAMPLE_SEEDS, n_vertices)]
    reached = torch.zeros(n_vertices, dtype=torch.int32, device=src.device)
    reached[seeds] = 1
    ends = torch.cat([src, dst]).long()
    for _ in range(BFS_SAMPLE_ROUNDS):
        hit = torch.maximum(reached[src], reached[dst])
        reached = reached.scatter_reduce(0, ends, hit.repeat(2), "amax",
                                         include_self=True)
    sampled = (reached[src] | reached[dst]) > 0
    out_s, out_d, sample_m = stable_partition(src, dst, sampled)
    with trace.span("read.sample_width"):
        sample_m = int(sample_m)
    # the top-degree seed has an incident edge whenever m > 0
    return out_s, out_d, max(sample_m, 1)


@dataclasses.dataclass(frozen=True)
class SamplingStrategy:
    """One pluggable sampling phase (ConnectIt's sampling axis).

    ``prepare(src, dst, n_vertices, k) -> (src', dst', sample_m)`` returns
    the edge list permuted so that the sample is its first ``sample_m``
    edges (an int, or a 0-d tensor that :func:`prepare_sampling` reads).
    """

    name: str
    prepare: Callable[[torch.Tensor, torch.Tensor, int, int],
                      Tuple[torch.Tensor, torch.Tensor, object]]


_SAMPLING_REGISTRY: Dict[str, SamplingStrategy] = {}


def register_sampling_strategy(strategy: SamplingStrategy
                               ) -> SamplingStrategy:
    _SAMPLING_REGISTRY[strategy.name] = strategy
    return strategy


register_sampling_strategy(SamplingStrategy("prefix", _prepare_prefix))
register_sampling_strategy(SamplingStrategy("kout", _prepare_kout))
register_sampling_strategy(SamplingStrategy("bfs", _prepare_bfs))

# canonical order, as the reference's
SAMPLING_STRATEGIES = ("prefix", "kout", "bfs")


def get_sampling_strategy(name: str) -> SamplingStrategy:
    if name not in _SAMPLING_REGISTRY:
        raise ValueError(
            f"unknown sampling_strategy {name!r}; one of "
            f"{tuple(sorted(_SAMPLING_REGISTRY))}")
    return _SAMPLING_REGISTRY[name]


def prepare_sampling(name: str, src: torch.Tensor, dst: torch.Tensor,
                     n_vertices: int, k: int = DEFAULT_SAMPLING_K
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Permute ``(src, dst)`` so the strategy's sample is the leading
    prefix; returns ``(src', dst', sample_m)`` with ``sample_m`` an int."""
    if k < 1:
        raise ValueError(f"sampling k must be >= 1, got {k}")
    out_s, out_d, sample_m = get_sampling_strategy(name).prepare(
        src, dst, n_vertices, k)
    if isinstance(sample_m, torch.Tensor):
        # a registered strategy's width still on the device
        with trace.span("read.sample_width"):
            sample_m = int(sample_m)
    return out_s, out_d, int(sample_m)


def largest_component_label(L: torch.Tensor, n_vertices: int
                            ) -> torch.Tensor:
    """The most frequent label (a 0-d tensor, not read): the largest
    intermediate component.  ``argmax`` returns the first maximum, as
    the reference's does."""
    return torch.argmax(torch.bincount(L, minlength=n_vertices)).to(L.dtype)


def contract_edges(
    L: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    active_m: int,
    *,
    only_label: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One contraction step: relabel active edges, retire self-loops.

    The active edges (positions ``< active_m``) are rewritten to
    ``(L²[u], L²[v])`` and stably partitioned into ``[active | retired]``;
    ``only_label`` restricts retirement to self-loops of that label (the
    largest-component filter), ``None`` retires every self-loop.  The
    edges past ``active_m`` stay where they are: in the reference's
    whole-array partition they land at the same positions.  Returns
    ``(src', dst', active_m')``; reading ``active_m'`` is the step's one
    device→host read.
    """
    rs = L[L[src[:active_m]]]
    rd = L[L[dst[:active_m]]]
    if only_label is None:
        retire = rs == rd
    else:
        retire = (rs == only_label) & (rd == only_label)
    out_s, out_d, n_keep = stable_partition(rs, rd, ~retire)
    with trace.span("read.survivors"):
        n_keep = int(n_keep)
    return (torch.cat([out_s, src[active_m:]]),
            torch.cat([out_d, dst[active_m:]]), n_keep)


def masked_converged_early(L: torch.Tensor, src: torch.Tensor,
                           dst: torch.Tensor, active_m: int,
                           test: Callable = cv.converged_early
                           ) -> torch.Tensor:
    """Paper §III-B2 early-convergence predicate over the active prefix
    (retired edges lie inside their components); with no active edge the
    solve has converged.  ``test`` is a backend's (``converged.loop_ops``;
    default the kernel, its plain version on CPU tensors); not read
    here."""
    return test(L, src, dst, edge_limit=active_m)


def frontier_limit(it: int, active_m: int, sample_m: int,
                   sampling: int) -> int:
    """Per-iteration sweep bound: the sample first, the live frontier
    after."""
    if sampling > 0 and it < sampling:
        return min(sample_m, active_m)
    return active_m


def gate_sampling_done(done, it: int, sampling: int):
    """Pass-through: convergence may fire during the sampling phase,
    since :func:`masked_converged_early` tests the whole active prefix,
    not only the swept sample.  The reference keeps it as the named seam
    of the masked, staged and distributed loops' convergence site."""
    del it, sampling
    return done


def apply_compaction(
    L: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    active_m: int,
    it1: int,
    *,
    sampling: int,
    compact_every: int,
    n_vertices: int,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The compaction schedule after iteration ``it1`` (post-increment).

    The largest-component filter fires once, right after the sampling
    phase; general contraction fires every ``compact_every`` iterations
    after it.
    """
    if sampling > 0 and it1 == sampling:
        c_hat = largest_component_label(L, n_vertices)
        return contract_edges(L, src, dst, active_m, only_label=c_hat)
    if (compact_every > 0 and it1 > sampling
            and (it1 - sampling) % compact_every == 0):
        return contract_edges(L, src, dst, active_m)
    return src, dst, active_m


def compress_full(L: torch.Tensor, loop: Optional[cv.LoopOps] = None, *,
                  owned: bool = False) -> torch.Tensor:
    """Pointer-jump to the star-forest fixed point.  Vertices retired by
    contraction hang off pointer chains of any depth, so the adaptive
    path ends here instead of with the dense schedule's single jump.

    Each round is a backend's jump and its no-change test (``loop``,
    ``converged.loop_ops``; default the kernels'), one flag read a round:
    under the labelling invariant ``L[v] <= v`` (every solve's labels keep
    it: ``minmap.resolve_init_labels`` clamps, sweeps and jumps only lower
    labels) ``min(L, L[L]) == L`` exactly where ``L[L] == L``, so the
    first round whose jump changes nothing finds the star forest, with
    the labels and the rounds of ``while not is_star_forest(L): L =
    jump(L)``, and no gather of ``L[L]`` beside it.  The rounds alternate
    between two buffers: with ``owned`` the first is ``L`` itself (the
    caller's to overwrite), so the loop holds one label array besides
    ``L``, else two."""
    loop = loop or cv.loop_ops("cuda")
    spare = None
    while True:
        jumped = (loop.pointer_jump(L) if spare is None
                  else loop.pointer_jump(L, out=spare))
        unchanged = loop.labels_unchanged(jumped, L)
        with trace.span("read.star_forest"):
            unchanged = bool(unchanged)
        if unchanged:
            return L
        spare = L if owned else None
        L, owned = jumped, True


@dataclasses.dataclass
class FrontierState:
    """Host-side state of the work-adaptive loop."""

    L: torch.Tensor
    src: torch.Tensor       # [active | retired] layout
    dst: torch.Tensor
    active_m: int           # live prefix edges
    it: int = 0
    done: bool = False
    visited: np.float32 = np.float32(0)  # float32 sum of sweep bounds
    # the backend's test and jump round (converged.loop_ops)
    loop: cv.LoopOps = dataclasses.field(
        default_factory=lambda: cv.loop_ops("cuda"))
    # whether L is the loop's own (made by a step), which a later step and
    # the final compression may overwrite; the caller's labels never are
    owned: bool = False


def compress_state(s: FrontierState) -> None:
    """:func:`compress_full` of the state's labels, in place."""
    L = compress_full(s.L, s.loop, owned=s.owned)
    s.owned = s.owned or L is not s.L
    s.L = L


def advance(s: FrontierState, step, *, sample_m: int, sampling: int,
            compact_every: int, n_vertices: int, max_iters: int,
            sweep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> None:
    """One iteration of the loop, on ``s`` in place.

    ``step(L, it, src, dst, limit)`` sweeps the first ``limit`` edges of
    ``sweep`` (default: the state's edges); once the state owns its
    labels it is also given ``spare=L``, a buffer it may overwrite after
    its sweep (``contour._make_step``).  The sweep, the convergence
    check over the active prefix, the iteration count and the compaction
    schedule are those of the reference's loop body; the compaction is
    left out once the loop is about to end, since nothing reads the edges
    after it.
    """
    limit = frontier_limit(s.it, s.active_m, sample_m, sampling)
    src, dst = sweep if sweep is not None else (s.src, s.dst)
    # once the loop owns its labels the step may overwrite them after its
    # sweep (``spare``): the loop then holds two label arrays besides the
    # caller's
    L = s.L
    s.L = step(L, s.it, src, dst, limit, **({"spare": L} if s.owned else {}))
    s.owned = s.owned or s.L is not L
    s.visited = np.float32(s.visited + np.float32(limit))
    done = masked_converged_early(s.L, s.src, s.dst, s.active_m,
                                  s.loop.converged_early)
    with trace.span("read.frontier"):
        s.done = bool(done)
    s.it += 1
    if not s.done and s.it < max_iters:
        s.src, s.dst, s.active_m = apply_compaction(
            s.L, s.src, s.dst, s.active_m, s.it, sampling=sampling,
            compact_every=compact_every, n_vertices=n_vertices)


def adaptive_fixpoint(
    src: torch.Tensor,
    dst: torch.Tensor,
    L0: torch.Tensor,
    step: Callable,
    *,
    n_vertices: int,
    sampling: int,
    compact_every: int,
    max_iters: int,
    active_m0: Optional[int] = None,
    sample_m0: Optional[int] = None,
    loop: Optional[cv.LoopOps] = None,
    owned: bool = False,
):
    """Run ``step`` to the connectivity fixed point, work-adaptively (the
    masked realisation: the edge arrays keep their length).

    ``step(L, it, src, dst, limit)`` sweeps the first ``limit`` edges.
    ``active_m0`` is the initial live prefix (default every edge): a
    caller passing fewer asserts that the tail already lies inside its
    components under ``L0`` (self-loop padding, the streaming engine's
    padded batch), so it is never swept and never counted in
    ``edges_visited``.  ``sample_m0`` is the sample width (default
    :func:`sample_prefix_m` of the whole length), as a strategy's
    :func:`prepare_sampling` gives it.  ``loop`` is the backend's test
    and jump round (default the kernels').  ``owned``: ``L0`` is the
    caller's to overwrite (a copy it made for the loop), so the first
    step may reuse it; otherwise it is left as it is.

    Returns ``(labels, iterations, converged, edges_visited)``: an int
    and a bool beside the labels, and a float32 counter.
    """
    m = int(src.shape[0])
    sample_m = sample_prefix_m(m) if sample_m0 is None else int(sample_m0)
    s = FrontierState(L=L0, src=src, dst=dst,
                      active_m=m if active_m0 is None else int(active_m0),
                      loop=loop or cv.loop_ops("cuda"), owned=owned)
    while not s.done and s.it < max_iters:
        advance(s, step, sample_m=sample_m, sampling=sampling,
                compact_every=compact_every, n_vertices=n_vertices,
                max_iters=max_iters)
    compress_state(s)
    return s.L, s.it, s.done, s.visited
