"""The Contour connectivity algorithm (paper Alg. 1) and its six variants.

The port's counterpart of ``repro.connectivity.contour``.  Variants
(paper §III-B4):

* ``C-Syn``  — Alg. 1 verbatim: synchronous 2-order sweeps, plain
  no-change convergence test.
* ``C-1``    — 1-order operator + recompaction + early check.
* ``C-2``    — 2-order operator + recompaction + early check (the paper's
  default).
* ``C-m``    — high-order operator, realised as a 2-order edge sweep
  followed by ``log2(m)`` pointer-jump rounds.
* ``C-11mm`` — ``warmup`` iterations of C-1 then C-m until convergence.
* ``C-1m1m`` — alternate C-1 and C-m per iteration.
* ``C-<h>``  — the literal h-order operator of Definition 3.

Every sweep goes through ``kernels.contour_mm.ops.mm_relax_backend``.
The dense loop keeps its state on the device, as the reference's
``lax.while_loop`` does (``kernels.contour_mm.converged``; its kernels
on the ``cuda`` backends, their plain versions on ``torch``): each
iteration's convergence test also does the loop's step (``it += 1``,
``done`` = the test) in the ``it``/``done`` words, and the sweeps and
jump rounds of later iterations read ``done`` and do nothing once it is
set.  The host enqueues ``converged.CHUNK`` iterations at a time and
reads ``(done, it)`` once per chunk, so ``iterations`` is the first
converged iteration however many were enqueued past it.

:func:`contour_labels_batched` runs the dense loop of a fleet of
graphs at once (``solve_batch``): one sweep launch per iteration covers
every lane, each lane freezes at the iteration its own test passes, and
the host reads the fleet's words once per chunk.

``sampling`` / ``compact_every`` enable the work-adaptive frontier
schedule of ``connectivity.frontier`` (masked realisation; the staged one
is ``planner.staged``): the same fixed point, with sweeps and the
convergence check on the live edge prefix only.  ``C-Syn`` stays
Alg.-1-verbatim and rejects it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.connectivity import frontier as fr
from repro_torch.connectivity import minmap as lab
from repro_torch.kernels.contour_mm import converged as cv
from repro_torch.kernels.contour_mm import ops as mm_ops
from repro_torch.kernels.contour_mm.blocked import lane_offsets

VARIANTS = ("C-Syn", "C-1", "C-2", "C-m", "C-11mm", "C-1m1m")

# C-m's effective order: the paper uses m = 1024; log2(1024) = 10 jump
# rounds after the 2-order edge sweep cover the same mapping depth.
_CM_JUMP_ROUNDS = 10


def _schedule(variant: str, warmup: int, async_compress: int, relax,
              jump):
    """The variant's iteration, ``step(L, it, src, dst, ctx, spare)``,
    from a sweep ``relax(L, src, dst, order, ctx)`` and a jump round
    ``jump(L, ctx, out)`` (``out``: a buffer it may overwrite, or None);
    ``ctx`` is whatever the two need besides the labels and edges.

    ``it`` is the host's iteration counter; C-11mm and C-1m1m branch on it
    where the reference used ``lax.cond``.  The jump rounds alternate
    between ``spare`` and the sweep's output."""

    def sweep_async(L, src, dst, order, jump_rounds, ctx, spare):
        """MM^order + pointer-jump recompaction (``async_compress`` extra
        rounds spread freshly lowered labels inside the iteration)."""
        L = relax(L, src, dst, order, ctx)
        for _ in range(jump_rounds + async_compress):
            spare, L = L, jump(L, ctx, spare)
        return L

    def low(L, src, dst, ctx, spare):
        return sweep_async(L, src, dst, 1, 0, ctx, spare)

    def high(L, src, dst, ctx, spare):
        return sweep_async(L, src, dst, 2, _CM_JUMP_ROUNDS, ctx, spare)

    if variant == "C-Syn":
        def step(L, it, src, dst, ctx, spare):
            return relax(L, src, dst, 2, ctx)
    elif variant == "C-1":
        def step(L, it, src, dst, ctx, spare):
            return low(L, src, dst, ctx, spare)
    elif variant == "C-2":
        def step(L, it, src, dst, ctx, spare):
            return sweep_async(L, src, dst, 2, 0, ctx, spare)
    elif variant == "C-m":
        def step(L, it, src, dst, ctx, spare):
            return high(L, src, dst, ctx, spare)
    elif variant == "C-11mm":
        def step(L, it, src, dst, ctx, spare):
            return (low(L, src, dst, ctx, spare) if it < warmup
                    else high(L, src, dst, ctx, spare))
    elif variant == "C-1m1m":
        def step(L, it, src, dst, ctx, spare):
            return (low(L, src, dst, ctx, spare) if it % 2 == 0
                    else high(L, src, dst, ctx, spare))
    elif variant.startswith("C-") and variant[2:].isdigit():
        # literal h-order minimum-mapping operator (Definition 3)
        order = int(variant[2:])

        def step(L, it, src, dst, ctx, spare):
            return sweep_async(L, src, dst, order, 0, ctx, spare)
    else:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS} "
                         "or literal 'C-<h>'")
    return step


def _make_step(variant: str, warmup: int, async_compress: int,
               backend: str = "torch", fuse: bool = True):
    """Return step(L, it, src, dst, limit=None, done=None, spare=None) ->
    L_new for the variant (:func:`_schedule`).

    ``limit`` is the frontier bound (None: every edge, the dense
    schedule).  ``done`` is the dense loop's flag word: once it is set the
    step returns its input labels (a sweep past the early-convergence
    point is a no-op anyway; the jump rounds would still shorten chains
    of vertices on no edge).  ``spare`` is a label array the step may
    overwrite once the sweep has read ``L`` (the caller passes ``L``
    itself when the loop owns it), so a step holds at most two label
    arrays besides its input.
    """

    pointer_jump = cv.loop_ops(backend).pointer_jump

    def relax(L, src, dst, order, ctx):
        limit, done = ctx
        return mm_ops.mm_relax_backend(L, src, dst, order=order,
                                       backend=backend, edge_limit=limit,
                                       fuse=fuse, done=done)

    def jump(L, ctx, out):
        done = ctx[1]
        return (pointer_jump(L, done) if out is None
                else pointer_jump(L, done, out=out))

    schedule = _schedule(variant, warmup, async_compress, relax, jump)

    def step(L, it, src, dst, limit=None, done=None, spare=None):
        return schedule(L, it, src, dst, (limit, done), spare)

    return step


def contour_labels(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_vertices: int,
    init_labels: Optional[torch.Tensor] = None,
    *,
    variant: str = "C-2",
    max_iters: int = 100_000,
    warmup: int = 2,
    async_compress: int = 1,
    backend: str = "torch",
    sampling: int = 0,
    compact_every: int = 0,
    sampling_strategy: str = "prefix",
    sampling_k: int = fr.DEFAULT_SAMPLING_K,
    fuse: bool = True,
):
    """Run Contour; returns (labels[n], n_iterations, converged, visited).

    Labels converge to the minimum vertex id of each component on the
    device of ``src``.  ``n_iterations`` (int32), ``converged`` (bool) and
    ``visited`` (float32) are 0-d tensors on the same device;
    ``converged`` is False iff the ``max_iters`` budget ran out.
    ``visited`` counts the edges swept: ``n_iterations * m`` on the dense
    schedule, the float32 sum of the per-sweep frontier bounds when
    ``sampling``/``compact_every`` enable the frontier schedule.
    ``sampling_strategy`` (``"prefix"``/``"kout"``/``"bfs"``, fan-in
    ``sampling_k``) picks the sampling phase's edges.  ``backend`` and
    ``fuse`` choose the kernel of every sweep (``mm_relax_backend``).
    """
    if warmup < 0 or async_compress < 0:
        raise ValueError("warmup and async_compress must be >= 0, got "
                         f"{warmup} / {async_compress}")
    if sampling < 0 or compact_every < 0:
        raise ValueError("sampling and compact_every must be >= 0, got "
                         f"{sampling} / {compact_every}")
    adaptive = sampling > 0 or compact_every > 0
    sync = variant == "C-Syn"
    if adaptive and sync:
        raise ValueError(
            "C-Syn is the Alg.-1-verbatim reference and does not take the "
            "work-adaptive schedule; use C-2/C-m (or any async variant) "
            "with sampling/compact_every")
    step = _make_step(variant, warmup, async_compress, backend, fuse)
    loop = cv.loop_ops(backend)
    device = src.device
    L = lab.resolve_init_labels(init_labels, n_vertices, device, src.dtype)

    if adaptive:
        sample_m = None
        if sampling > 0 and sampling_strategy != "prefix":
            src, dst, sample_m = fr.prepare_sampling(
                sampling_strategy, src, dst, n_vertices, sampling_k)
        # L is resolve_init_labels' new array: the loop's to overwrite
        L, it, done, visited = fr.adaptive_fixpoint(
            src, dst, L, step, n_vertices=n_vertices, sampling=sampling,
            compact_every=compact_every, max_iters=max_iters,
            sample_m0=sample_m, loop=loop, owned=True)
        return (L, torch.tensor(it, dtype=torch.int32, device=device),
                torch.tensor(done, device=device),
                torch.tensor(visited, dtype=torch.float32, device=device))

    state = cv.loop_state(device)
    done = cv.done_word(state)

    def body(it, L):
        L_new = step(L, it, src, dst, done=done)
        if sync:  # Alg. 1 line 10: no label change
            loop.labels_unchanged(L_new, L, state=state)
        else:  # §III-B2
            loop.converged_early(L_new, src, dst, state=state)
        return L_new

    L = cv.device_loop(body, L, state, max_iters)
    # Final compression: interior vertices of chains off the edge endpoints
    # may still be one hop from their star root.
    L = loop.pointer_jump(L)
    it, done = cv.loop_result(state)
    return L, it, done, mm_ops.edges_visited(it, int(src.shape[0]), device)


def _make_fleet_step(variant: str, warmup: int, async_compress: int,
                     n: int, ops: cv.FleetOps, fuse: bool):
    """``step(L, it, src, dst, lanes) -> L_new`` for a fleet: the
    variant's :func:`_schedule` on ``[B * n]`` labels and ``[B, m]``
    edges, with each lane frozen once its ``done`` word in ``lanes`` is
    set.  ``it`` is the host's iteration, which every live lane shares."""

    def relax(L, src, dst, order, lanes):
        if fuse and order == 2:
            return ops.fused_relax(L, src, dst, n, lanes)
        t, v = mm_update_stream_batched(L, src, dst, n, order)
        return ops.scatter_min(L, t, v, n, lanes)

    def jump(L, lanes, out):
        return ops.pointer_jump(L, n, lanes)

    schedule = _schedule(variant, warmup, async_compress, relax, jump)
    return lambda L, it, src, dst, lanes: schedule(L, it, src, dst, lanes,
                                                   None)


def mm_update_stream_batched(L: torch.Tensor, src: torch.Tensor,
                             dst: torch.Tensor, n: int, order: int):
    """A fleet's ``MM^order`` update stream: ``minmap.mm_update_stream``
    of every lane, with targets as ids of the ``[B * n]`` label array."""
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    lanes_b = int(src.shape[0])
    Lv = L.view(lanes_b, n)
    chain_s = [Lv.gather(1, src.long())]
    chain_d = [Lv.gather(1, dst.long())]
    for _ in range(order - 1):
        chain_s.append(L[chain_s[-1]])
        chain_d.append(L[chain_d[-1]])
    z = torch.minimum(chain_s[-1], chain_d[-1])
    off = lane_offsets(lanes_b, n, src.device)
    targets = [src + off, dst + off]
    for k in range(order - 1):
        targets += [chain_s[k], chain_d[k]]
    return (torch.cat([t.reshape(-1) for t in targets]),
            z.reshape(-1).repeat(len(targets)))


def contour_labels_batched(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_vertices: int,
    init_labels: Optional[torch.Tensor] = None,
    *,
    variant: str = "C-2",
    max_iters: int = 100_000,
    warmup: int = 2,
    async_compress: int = 1,
    backend: str = "torch",
    fuse: bool = True,
):
    """Contour's dense loop over a fleet: ``src``/``dst`` are ``[B, m]``
    (each graph's own ids, padded with ``(0, 0)`` self-loops) and
    ``init_labels`` is None or ``[B, n]``.

    Returns ``(labels [B, n], iterations [B], converged [B],
    edges_visited [B])`` on the edges' device, each lane equal to
    :func:`contour_labels` of its row alone: the lanes share one label
    array (lane ``b``'s vertex ``v`` at ``b * n + v``), one sweep launch
    per iteration covers them all, a lane freezes at the iteration its
    own test passes, and the host reads the fleet's ``(done, it)`` once
    per ``converged.CHUNK`` iterations.  ``backend`` is ``"cuda"`` (the
    kernels; their plain versions on CPU tensors) or ``"torch"`` (the
    plain versions on any device).
    """
    if warmup < 0 or async_compress < 0:
        raise ValueError("warmup and async_compress must be >= 0, got "
                         f"{warmup} / {async_compress}")
    if backend not in ("cuda", "torch"):
        raise ValueError(f"the fleet's dense loop runs on 'cuda' or "
                         f"'torch', not {backend!r}")
    n = int(n_vertices)
    lanes_b, m = int(src.shape[0]), int(src.shape[1])
    if lanes_b * n >= 1 << 31:
        raise ValueError(f"B * n = {lanes_b} * {n} = {lanes_b * n} labels "
                         "exceed the int32 id space of one label array")
    device = src.device
    ops = cv.batch_ops(backend)
    step = _make_fleet_step(variant, warmup, async_compress, n, ops, fuse)
    iota = torch.arange(n, dtype=torch.int32, device=device)
    L0 = (iota.expand(lanes_b, n) if init_labels is None
          else init_labels.to(device=device, dtype=torch.int32))
    off = lane_offsets(lanes_b, n, device)
    L = (L0 + off).reshape(-1)
    state = cv.fleet_state(lanes_b, device)
    sync = variant == "C-Syn"

    def body(it, L):
        L_new = step(L, it, src, dst, state.lanes)
        if sync:  # Alg. 1 line 10: no label change
            ops.labels_unchanged(L_new, L, n, state)
        else:  # §III-B2
            ops.converged_early(L_new, src, dst, n, state)
        return L_new

    L = cv.device_loop(body, L, state.fleet, max_iters)
    # the final compression of every lane, as after each solo loop
    L = ops.pointer_jump(L, n)
    labels = L.view(lanes_b, n) - off
    iterations = state.lanes[:, cv.IT].clone()
    return (labels, iterations, state.lanes[:, cv.DONE].bool(),
            iterations.to(torch.float32) * m)
