"""Staged realisation of the work-adaptive frontier: the arrays really shrink.

The port's counterpart of ``repro.connectivity.planner.staged``.  The
fixpoint runs in stages.  Each stage is the frontier loop of
``frontier.adaptive_fixpoint`` over edge arrays sliced to a power-of-two
capacity; once the live frontier falls to half the capacity the stage
ends, its labels are compressed to a star forest, and the next stage
starts at the smaller capacity (never below ``MIN_STAGE_EDGES``).  The
sampling phase runs first, over a slice of the sample alone.

On the TPU each stage was one compiled program per capacity.  Torch has
nothing to compile, but the stages stay as the reference has them: the
compression between stages, the ``MIN_STAGE_EDGES`` floor, the pow2
capacities, the exit at half the capacity and the sampling slice decide
the labels each sweep sees, and so ``iterations`` and
``edges_visited``.  Every bound is a host int already (``active_m`` is
read once per contraction), so a stage boundary costs no extra read.

Soundness of dropping the suffix: every live edge is in the ``active_m``
prefix; positions past it are never swept, never checked and never
re-activated.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.connectivity import frontier as fr
from repro_torch.connectivity import minmap as lab
from repro_torch.connectivity.planner.plan import next_pow2
from repro_torch.kernels.contour_mm import converged as cv

# The reference's floor (staged.py:59): below this capacity a stage runs
# to convergence instead of re-slicing.
MIN_STAGE_EDGES = 1024


def _stage(s: fr.FrontierState, step, *, sampling: int, compact_every: int,
           n_vertices: int, max_iters: int, allow_exit: bool) -> None:
    """One stage at the capacity ``len(s.src)``, on ``s`` in place: the
    frontier loop, with an exit once the live frontier fits in half the
    capacity (after the sampling phase), then a compression of the
    labels to a star forest."""
    m = int(s.src.shape[0])
    half = m // 2
    stop = half if (allow_exit and half >= MIN_STAGE_EDGES) else 0
    while (not s.done and s.it < max_iters
           and not (stop > 0 and s.active_m <= stop and s.it >= sampling)):
        fr.advance(s, step, sample_m=fr.sample_prefix_m(m),
                   sampling=sampling, compact_every=compact_every,
                   n_vertices=n_vertices, max_iters=max_iters)
    fr.compress_state(s)


def _shrink(s: fr.FrontierState) -> bool:
    """Slice the edges to the pow2 capacity of the live frontier; False
    if that would not make them shorter."""
    new_m = max(MIN_STAGE_EDGES, next_pow2(s.active_m))
    if new_m >= int(s.src.shape[0]):
        return False
    s.src, s.dst = s.src[:new_m], s.dst[:new_m]
    return True


def staged_adaptive_labels(
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
    sampling: int = 0,
    compact_every: int = 0,
    sampling_strategy: str = "prefix",
    sampling_k: int = fr.DEFAULT_SAMPLING_K,
):
    """Host-driven staged fixpoint; same contract as ``contour_labels``.

    Returns ``(labels, n_iterations, converged, edges_visited)`` as 0-d
    tensors beside the labels, on the device of ``src``.
    """
    # contour imports the planner; import it late to keep the cycle open
    from repro_torch.connectivity.contour import _make_step

    if variant == "C-Syn":
        raise ValueError(
            "C-Syn is the Alg.-1-verbatim reference and does not take the "
            "work-adaptive schedule; use C-2/C-m (or any async variant) "
            "with sampling/compact_every")
    if sampling < 0 or compact_every < 0:
        raise ValueError("sampling and compact_every must be >= 0, got "
                         f"{sampling} / {compact_every}")
    step = _make_step(variant, warmup, async_compress, backend, fuse)
    device = src.device
    L = lab.resolve_init_labels(init_labels, n_vertices, device, src.dtype)
    # L is resolve_init_labels' new array: the loop's to overwrite
    s = fr.FrontierState(L=L, src=src, dst=dst, active_m=int(src.shape[0]),
                         loop=cv.loop_ops(backend), owned=True)
    common = dict(sampling=sampling, n_vertices=n_vertices,
                  max_iters=max_iters)

    def result():
        return (s.L, torch.tensor(s.it, dtype=torch.int32, device=device),
                torch.tensor(s.done, device=device),
                torch.tensor(s.visited, dtype=torch.float32, device=device))

    if sampling > 0:
        if sampling_strategy != "prefix":
            s.src, s.dst, sm = fr.prepare_sampling(
                sampling_strategy, src, dst, n_vertices, sampling_k)
        else:
            sm = fr.sample_prefix_m(int(src.shape[0]))
        # the sample's sweeps run over a slice of the sample alone; the
        # check still covers every active edge
        sample = (s.src[:sm], s.dst[:sm])
        while not s.done and s.it < min(sampling, max_iters):
            fr.advance(s, step, sample_m=sm, compact_every=0, sweep=sample,
                       **common)
        if s.done or s.it >= max_iters:
            fr.compress_state(s)
            return result()
        # the filter may have collapsed the frontier: slice straight away
        _shrink(s)
    while True:
        _stage(s, step, compact_every=compact_every, allow_exit=True,
               **common)
        if s.done or s.it >= max_iters:
            return result()
        if not _shrink(s):
            # cannot shrink further: finish at this capacity
            _stage(s, step, compact_every=compact_every, allow_exit=False,
                   **common)
            return result()
