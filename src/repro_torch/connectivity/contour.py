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

VARIANTS = ("C-Syn", "C-1", "C-2", "C-m", "C-11mm", "C-1m1m")

# C-m's effective order: the paper uses m = 1024; log2(1024) = 10 jump
# rounds after the 2-order edge sweep cover the same mapping depth.
_CM_JUMP_ROUNDS = 10


def _make_step(variant: str, warmup: int, async_compress: int,
               backend: str = "torch", fuse: bool = True):
    """Return step(L, it, src, dst, limit=None, done=None) -> L_new for the
    variant.

    ``it`` is the host's iteration counter; C-11mm and C-1m1m branch on it
    where the reference used ``lax.cond``.  ``limit`` is the frontier
    bound (None: every edge, the dense schedule).  ``done`` is the dense
    loop's flag word: once it is set the step returns its input labels
    (a sweep past the early-convergence point is a no-op anyway; the jump
    rounds would still shorten chains of vertices on no edge).
    """

    jump = cv.loop_ops(backend).pointer_jump

    def relax(L, src, dst, order, limit, done):
        return mm_ops.mm_relax_backend(L, src, dst, order=order,
                                       backend=backend, edge_limit=limit,
                                       fuse=fuse, done=done)

    def sweep_async(L, src, dst, order, jump_rounds, limit, done):
        """MM^order + pointer-jump recompaction (``async_compress`` extra
        rounds spread freshly lowered labels inside the iteration)."""
        L = relax(L, src, dst, order, limit, done)
        for _ in range(jump_rounds + async_compress):
            L = jump(L, done)
        return L

    def low(L, src, dst, limit, done):
        return sweep_async(L, src, dst, 1, 0, limit, done)

    def high(L, src, dst, limit, done):
        return sweep_async(L, src, dst, 2, _CM_JUMP_ROUNDS, limit, done)

    if variant == "C-Syn":
        def step(L, it, src, dst, limit=None, done=None):
            return relax(L, src, dst, 2, limit, done)
    elif variant == "C-1":
        def step(L, it, src, dst, limit=None, done=None):
            return low(L, src, dst, limit, done)
    elif variant == "C-2":
        def step(L, it, src, dst, limit=None, done=None):
            return sweep_async(L, src, dst, 2, 0, limit, done)
    elif variant == "C-m":
        def step(L, it, src, dst, limit=None, done=None):
            return high(L, src, dst, limit, done)
    elif variant == "C-11mm":
        def step(L, it, src, dst, limit=None, done=None):
            return (low(L, src, dst, limit, done) if it < warmup
                    else high(L, src, dst, limit, done))
    elif variant == "C-1m1m":
        def step(L, it, src, dst, limit=None, done=None):
            return (low(L, src, dst, limit, done) if it % 2 == 0
                    else high(L, src, dst, limit, done))
    elif variant.startswith("C-") and variant[2:].isdigit():
        # literal h-order minimum-mapping operator (Definition 3)
        order = int(variant[2:])

        def step(L, it, src, dst, limit=None, done=None):
            return sweep_async(L, src, dst, order, 0, limit, done)
    else:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS} "
                         "or literal 'C-<h>'")
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
        L, it, done, visited = fr.adaptive_fixpoint(
            src, dst, L, step, n_vertices=n_vertices, sampling=sampling,
            compact_every=compact_every, max_iters=max_iters,
            sample_m0=sample_m, loop=loop)
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
