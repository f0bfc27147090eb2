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

Every sweep goes through ``kernels.contour_mm.ops.mm_relax_backend``.  The
loop runs on the host: after each iteration it reads one convergence flag
from the device, so ``iterations`` is the first converged iteration,
exactly as in the reference's ``lax.while_loop``.  Only the dense
schedule is ported; the frontier schedule (``sampling`` /
``compact_every``) comes with the frontier slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.connectivity import minmap as lab
from repro_torch.kernels.contour_mm import ops as mm_ops

VARIANTS = ("C-Syn", "C-1", "C-2", "C-m", "C-11mm", "C-1m1m")

# C-m's effective order: the paper uses m = 1024; log2(1024) = 10 jump
# rounds after the 2-order edge sweep cover the same mapping depth.
_CM_JUMP_ROUNDS = 10


def _make_step(variant: str, warmup: int, async_compress: int,
               backend: str = "torch", fuse: bool = True):
    """Return step(L, it, src, dst) -> L_new for the chosen variant.

    ``it`` is the Python iteration counter; C-11mm and C-1m1m branch on it
    where the reference used ``lax.cond``.
    """

    def sweep_async(L, src, dst, order, jump_rounds):
        """MM^order + pointer-jump recompaction (``async_compress`` extra
        rounds spread freshly lowered labels inside the iteration)."""
        L = mm_ops.mm_relax_backend(L, src, dst, order=order,
                                    backend=backend, fuse=fuse)
        return lab.pointer_jump(L, rounds=jump_rounds + async_compress)

    def low(L, src, dst):
        return sweep_async(L, src, dst, 1, 0)

    def high(L, src, dst):
        return sweep_async(L, src, dst, 2, _CM_JUMP_ROUNDS)

    if variant == "C-Syn":
        def step(L, it, src, dst):
            return mm_ops.mm_relax_backend(L, src, dst, order=2,
                                           backend=backend, fuse=fuse)
    elif variant == "C-1":
        def step(L, it, src, dst):
            return low(L, src, dst)
    elif variant == "C-2":
        def step(L, it, src, dst):
            return sweep_async(L, src, dst, 2, 0)
    elif variant == "C-m":
        def step(L, it, src, dst):
            return high(L, src, dst)
    elif variant == "C-11mm":
        def step(L, it, src, dst):
            return low(L, src, dst) if it < warmup else high(L, src, dst)
    elif variant == "C-1m1m":
        def step(L, it, src, dst):
            return low(L, src, dst) if it % 2 == 0 else high(L, src, dst)
    elif variant.startswith("C-") and variant[2:].isdigit():
        # literal h-order minimum-mapping operator (Definition 3)
        order = int(variant[2:])

        def step(L, it, src, dst):
            return sweep_async(L, src, dst, order, 0)
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
    fuse: bool = True,
):
    """Run Contour; returns (labels[n], n_iterations, converged, visited).

    Labels converge to the minimum vertex id of each component on the
    device of ``src``.  ``n_iterations`` (int32), ``converged`` (bool) and
    ``visited`` (float32 ``n_iterations * m``) are 0-d tensors on the same
    device; ``converged`` is False iff the ``max_iters`` budget ran out.
    ``backend`` and ``fuse`` choose the kernel of every sweep
    (``mm_relax_backend``).
    """
    if warmup < 0 or async_compress < 0:
        raise ValueError("warmup and async_compress must be >= 0, got "
                         f"{warmup} / {async_compress}")
    mm_ops.require_dense_schedule(sampling, compact_every)
    step = _make_step(variant, warmup, async_compress, backend, fuse)
    device = src.device
    L = lab.resolve_init_labels(init_labels, n_vertices, device, src.dtype)
    sync = variant == "C-Syn"
    it, done = 0, False
    while not done and it < max_iters:
        L_new = step(L, it, src, dst)
        if sync:
            done = torch.equal(L_new, L)  # Alg. 1 line 10: no label change
        else:
            done = bool(lab.converged_early(L_new, src, dst))  # §III-B2
        L = L_new
        it += 1
    # Final compression: interior vertices of chains off the edge endpoints
    # may still be one hop from their star root.
    L = lab.pointer_jump(L, rounds=1)
    return (L, torch.tensor(it, dtype=torch.int32, device=device),
            torch.tensor(done, device=device),
            mm_ops.edges_visited(it, int(src.shape[0]), device))

