from repro_torch.kernels.contour_mm.blocked import fused_relax, scatter_min
from repro_torch.kernels.contour_mm.converged import (converged_early,
                                                      labels_unchanged,
                                                      pointer_jump)
from repro_torch.kernels.contour_mm.kernel import mm2
from repro_torch.kernels.contour_mm.ops import (
    BACKENDS,
    contour_cc_fixpoint,
    contour_mm_step,
    mm_relax_backend,
    mm_update_stream,
)
from repro_torch.kernels.contour_mm.ref import mm_block_ref, mm_sync_ref

# the sweep kernels, and the fixpoint loop's kernels (converged.cu); each
# wrapper counts its launches
KERNELS = (fused_relax, scatter_min, mm2)
LOOP_KERNELS = (converged_early, labels_unchanged, pointer_jump)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for kernel in KERNELS + LOOP_KERNELS:
        kernel.launches = 0


__all__ = [
    "BACKENDS",
    "KERNELS",
    "LOOP_KERNELS",
    "contour_cc_fixpoint",
    "contour_mm_step",
    "converged_early",
    "fused_relax",
    "labels_unchanged",
    "mm2",
    "mm_block_ref",
    "mm_relax_backend",
    "mm_sync_ref",
    "mm_update_stream",
    "pointer_jump",
    "reset_launch_counts",
    "scatter_min",
]
