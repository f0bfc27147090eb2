"""Distributed Contour connectivity over ``torch.distributed`` ranks.

The port's counterpart of ``repro.connectivity.distributed``, which runs
the paper's Arkouda/Chapel distribution on a TPU mesh with ``shard_map``.
Here every rank of a :class:`~repro_torch.runtime.mesh.Mesh` is one
process running the same program (SPMD) on its own device:

* the edge list is block-sharded over the mesh's ``edge_axes`` (the first
  axis major), padded with vertex-0 self-loops to a multiple of the
  shard count; each rank slices its own block where the graph lies and
  copies only that block to its device;
* the label array ``L`` is replicated: every rank holds all of it;
* each global round every rank relaxes its block ``local_rounds`` times
  (an order-2 sweep through ``ops.mm_relax_backend`` — K1 ``fused_relax``
  on the ``cuda`` backend — then ``async_compress`` pointer-jump rounds,
  K7), and one ``all_reduce(MIN)`` over the edge axes' group merges the
  label arrays: the reference's ``lax.pmin``, and the only exchange of
  labels;
* convergence is the paper's early predicate (K6 ``converged_early``) on
  each rank's own edges, AND-ed across the group by an ``all_reduce(MIN)``
  of the int32 flag.

The dense loop runs on ``converged.device_loop``: the rank's loop state
stays on its device, the agreed flag does the loop's step
(``converged.loop_step_plain``) and the sweeps and jumps of later
iterations read ``done`` and do nothing once it is set.  Under NCCL both
collectives are enqueued on the stream, so the host reads ``(done, it)``
once per ``converged.CHUNK`` iterations, as on one device.  Every rank
reads the same replicated ``done``, so every rank enqueues the same
iterations and issues the same collectives; a rank that stopped early
would leave the others waiting in a collective.

``sampling`` / ``compact_every`` enable the work-adaptive frontier per
shard, as in the reference: each rank samples a prefix of its own block,
retires its edges into the largest component after the sampling phase
and contracts its own live prefix against the replicated labels, so the
schedule adds no exchange of edges.  That loop runs on the host, as the
single-device frontier does (``connectivity.frontier``): one read of the
agreed flag an iteration, one of the survivor count a contraction.
``edges_visited`` adds ``local_rounds`` times the group's
``all_reduce(SUM)`` of each rank's float32 sweep bound.  It ends with
``frontier.compress_full``; the dense loop ends with no final jump,
unlike ``contour.contour_labels``, as the reference's dense branch does.

The round is order-2 + jump, not the C-2 variant's schedule, so
``iterations`` need not equal a one-device C-2 solve's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import trace
from repro_torch.connectivity import frontier as fr
from repro_torch.connectivity import minmap as lab
from repro_torch.graphs.structs import Graph
from repro_torch.kernels.contour_mm import converged as cv
from repro_torch.kernels.contour_mm import ops as mm_ops
from repro_torch.runtime.mesh import Mesh

_MIN = dist.ReduceOp.MIN
_SUM = dist.ReduceOp.SUM


def _round_up(x: int, k: int) -> int:
    return (x + k - 1) // k * k


def _agreed(flag: torch.Tensor, group) -> torch.Tensor:
    """The group's AND of a 0-d bool flag, as a ``[1]`` int32 tensor (an
    ``all_reduce(MIN)``); not read here."""
    flag = flag.to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=_MIN, group=group)
    return flag


def _relax_rounds(L, src, dst, limit, group, *, local_rounds: int,
                  async_compress: int, backend: str, fuse: bool, done=None):
    """``local_rounds`` x (an order-2 sweep of the block's first ``limit``
    edges, ``async_compress`` jump rounds), then the round's one
    collective: the elementwise minimum of the ranks' labels, in place on
    a label array the sweep made."""
    jump = cv.loop_ops(backend).pointer_jump
    for _ in range(local_rounds):
        L = mm_ops.mm_relax_backend(L, src, dst, order=2, backend=backend,
                                    edge_limit=limit, fuse=fuse, done=done)
        for _ in range(async_compress):
            L = jump(L) if done is None else jump(L, done)
    dist.all_reduce(L, op=_MIN, group=group)
    return L


def _dense_loop(L, src, dst, group, *, local_rounds: int, max_iters: int,
                async_compress: int, backend: str, fuse: bool,
                check_every: int = 1):
    """The dense schedule's loop on the rank's device; returns ``(L, it,
    done)`` with ``it`` and ``done`` 0-d tensors beside the labels.

    An iteration whose index ``i`` has ``(i + 1) % check_every != 0``
    makes no test and does the loop's step with ``done = False``."""
    test = cv.loop_ops(backend).converged_early
    state = cv.loop_state(L.device)
    done = cv.done_word(state)

    def body(it, L):
        L = _relax_rounds(L, src, dst, None, group, local_rounds=local_rounds,
                          async_compress=async_compress, backend=backend,
                          fuse=fuse, done=done)
        if (it + 1) % check_every == 0:
            cv.loop_step_plain(state, _agreed(test(L, src, dst), group)[0])
        else:
            cv.loop_step_plain(state, 0)
        return L

    L = cv.device_loop(body, L, state, max_iters)
    it, converged = cv.loop_result(state)
    return L, it, converged


def _adaptive_loop(L, src, dst, group, *, n_vertices: int, active0: int,
                   local_rounds: int, max_iters: int, async_compress: int,
                   backend: str, fuse: bool, sampling: int,
                   compact_every: int):
    """The work-adaptive schedule on the rank's block (the reference's
    per-shard frontier); returns ``(L, it, done, visited)``."""
    loop = cv.loop_ops(backend)
    device = L.device
    sample_m = fr.sample_prefix_m(int(src.shape[0]))
    active_m = active0
    visited = torch.zeros((), dtype=torch.float32, device=device)
    it, done = 0, False
    while not done and it < max_iters:
        limit = fr.frontier_limit(it, active_m, sample_m, sampling)
        L = _relax_rounds(L, src, dst, limit, group,
                          local_rounds=local_rounds,
                          async_compress=async_compress, backend=backend,
                          fuse=fuse)
        # the group's float32 sum of the sweep bounds, then local_rounds
        # times it, each a float32 operation as the reference's
        bounds = torch.tensor([limit], dtype=torch.float32, device=device)
        dist.all_reduce(bounds, op=_SUM, group=group)
        visited = visited + bounds[0] * local_rounds
        ok = _agreed(fr.masked_converged_early(L, src, dst, active_m,
                                               loop.converged_early), group)
        with trace.span("read.frontier"):
            ok = ok.item()
        done = bool(fr.gate_sampling_done(ok, it, sampling))
        it += 1
        if not done and it < max_iters:
            # L is replicated after the all-reduce, so every rank agrees
            # on the largest component and contracts its own block
            # against the same schedule
            src, dst, active_m = fr.apply_compaction(
                L, src, dst, active_m, it, sampling=sampling,
                compact_every=compact_every, n_vertices=n_vertices)
    L = fr.compress_full(L, loop, owned=True)
    return (L, torch.tensor(it, dtype=torch.int32, device=device),
            torch.tensor(done, device=device), visited)


def _check_member(mesh: Mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.runtime.Mesh, got "
                        f"{type(mesh).__name__}")
    if not dist.is_initialized():
        raise RuntimeError("a distributed solve needs the default process "
                           "group: call torch.distributed."
                           "init_process_group first")
    if mesh.coordinate is None:
        raise ValueError(f"rank {mesh.rank} is not in {mesh!r}")


def shard_block(src: torch.Tensor, dst: torch.Tensor, mesh: Mesh,
                edge_axes: Sequence[str]):
    """The calling rank's block of the edge list sharded over
    ``edge_axes`` on its device, and the block's length: the list padded
    with vertex-0 self-loops to a multiple of the shard count (at least
    one edge a shard), block ``i`` = ``[i * m_loc, (i + 1) * m_loc)``,
    sliced where the edges lie before the copy."""
    n_shards = mesh.n_shards(edge_axes)
    m = int(src.shape[0])
    m_loc = _round_up(max(m, n_shards), n_shards) // n_shards
    lo = min(mesh.shard_index(edge_axes) * m_loc, m)
    hi = min(lo + m_loc, m)
    out = []
    for x in (src, dst):
        block = torch.zeros(m_loc, dtype=torch.int32, device=mesh.device)
        block[:hi - lo] = x[lo:hi].to(device=mesh.device, dtype=torch.int32)
        out.append(block)
    return out[0], out[1], m_loc


def distributed_edges(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_vertices: int,
    mesh: Mesh,
    *,
    edge_axes: Sequence[str] = ("data",),
    local_rounds: int = 1,
    max_iters: int = 10_000,
    async_compress: int = 1,
    backend: str = "torch",
    plan=None,
    init_labels: Optional[torch.Tensor] = None,
    sampling: int = 0,
    compact_every: int = 0,
    n_active: Optional[int] = None,
):
    """:func:`distributed_contour` on an edge list whose ids are known to
    lie in ``[0, n_vertices)`` (the streaming engine's root-rewritten
    batch): no check of the ids, no read."""
    if sampling < 0 or compact_every < 0:
        raise ValueError("sampling and compact_every must be >= 0, got "
                         f"{sampling} / {compact_every}")
    m = int(src.shape[0])
    if n_active is None:
        n_active = m
    elif not 0 <= n_active <= m:
        raise ValueError(f"n_active={n_active} outside [0, {m}]")
    _check_member(mesh)
    axes = tuple(edge_axes)
    src_loc, dst_loc, m_loc = shard_block(src, dst, mesh, axes)
    group = mesh.group(axes)
    L0 = lab.resolve_init_labels(init_labels, n_vertices, mesh.device,
                                 torch.int32)
    fuse = plan.fuse_relabel if plan is not None else True
    common = dict(local_rounds=local_rounds, max_iters=max_iters,
                  async_compress=async_compress, backend=backend, fuse=fuse)
    if sampling > 0 or compact_every > 0:
        # this shard's slice of the real-edge prefix: the layout is [real
        # | padding] and block i holds [i * m_loc, (i + 1) * m_loc)
        active0 = min(max(n_active - mesh.shard_index(axes) * m_loc, 0),
                      m_loc)
        return _adaptive_loop(L0, src_loc, dst_loc, group,
                              n_vertices=n_vertices, active0=active0,
                              sampling=sampling, compact_every=compact_every,
                              **common)
    L, it, done = _dense_loop(L0, src_loc, dst_loc, group, **common)
    # the sweeps touch the padded block (self-loops are no-ops), but the
    # counter reports real edges only: float32 products in the
    # reference's order (ops.edges_visited's, times local_rounds first)
    visited = it.to(torch.float32) * local_rounds * n_active
    return L, it, done, visited


def distributed_contour(
    graph: Graph,
    mesh: Mesh,
    *,
    edge_axes: Sequence[str] = ("data",),
    local_rounds: int = 1,
    max_iters: int = 10_000,
    async_compress: int = 1,
    backend: str = "torch",
    plan=None,
    init_labels: Optional[torch.Tensor] = None,
    sampling: int = 0,
    compact_every: int = 0,
    n_active: Optional[int] = None,
):
    """Run Contour's order-2 rounds with the edges sharded over
    ``edge_axes`` of ``mesh``; every rank of the mesh calls it with the
    same arguments.

    Returns ``(labels, n_global_rounds, converged, edges_visited)`` on
    the rank's device (``mesh.device``): the replicated labels, an int32,
    a bool and a float32, each the same on every rank.  ``backend`` picks
    the per-shard sweep (``ops.mm_relax_backend``: ``"cuda"`` runs the
    kernels, ``"torch"`` the plain versions, as the reference's
    ``"xla"``); a pinned ``plan`` gives the sweep's ``fuse``.
    ``init_labels`` warm-starts the replica.  ``n_active`` is the real
    edge count of a graph already padded with trailing self-loops (the
    streaming engine's buckets): edges past it are born retired on the
    frontier schedule and never counted in ``edges_visited``.
    """
    return distributed_edges(
        graph.src, graph.dst, graph.n_vertices, mesh, edge_axes=edge_axes,
        local_rounds=local_rounds, max_iters=max_iters,
        async_compress=async_compress, backend=backend, plan=plan,
        init_labels=init_labels, sampling=sampling,
        compact_every=compact_every, n_active=n_active)


def distributed_contour_step_fn(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_vertices: int,
    mesh: Mesh,
    edge_axes: Sequence[str] = ("data",),
    local_rounds: int = 1,
    max_iters: int = 10_000,
    check_every: int = 1,
    backend: str = "torch",
):
    """The dense rounds on edges already sharded: ``src``/``dst`` are the
    calling rank's block; returns the replicated ``(labels, rounds)``.

    Identical math to :func:`distributed_contour` with one jump round,
    from identity labels.  ``check_every`` is the convergence-check
    cadence: the early check (a gather of L at every edge endpoint and
    the flag's all-reduce) runs only after every ``check_every``-th
    round, at the cost of up to ``check_every - 1`` rounds past the
    fixed point.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    _check_member(mesh)
    src = src.to(mesh.device)
    dst = dst.to(mesh.device)
    L0 = torch.arange(n_vertices, dtype=torch.int32, device=mesh.device)
    L, it, _ = _dense_loop(L0, src, dst, mesh.group(tuple(edge_axes)),
                           local_rounds=local_rounds, max_iters=max_iters,
                           async_compress=1, backend=backend, fuse=True,
                           check_every=check_every)
    return L, it
