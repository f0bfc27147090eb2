from repro_torch.kernels.contour_mm.blocked import fused_relax, scatter_min
from repro_torch.kernels.contour_mm.kernel import mm2
from repro_torch.kernels.contour_mm.ops import (
    BACKENDS,
    contour_cc_fixpoint,
    contour_mm_step,
    mm_relax_backend,
    mm_update_stream,
)
from repro_torch.kernels.contour_mm.ref import mm_block_ref, mm_sync_ref

# every CUDA kernel of the family; each wrapper counts its launches
KERNELS = (fused_relax, scatter_min, mm2)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for kernel in KERNELS:
        kernel.launches = 0


__all__ = [
    "BACKENDS",
    "KERNELS",
    "contour_cc_fixpoint",
    "contour_mm_step",
    "fused_relax",
    "mm2",
    "mm_block_ref",
    "mm_relax_backend",
    "mm_sync_ref",
    "mm_update_stream",
    "reset_launch_counts",
    "scatter_min",
]
