from repro_torch.kernels.contour_mm.blocked import (fused_relax, scatter_min,
                                                    reset_launch_counts)
from repro_torch.kernels.contour_mm.ops import (
    BACKENDS,
    contour_cc_fixpoint,
    contour_mm_step,
    mm_relax_backend,
    mm_update_stream,
)
from repro_torch.kernels.contour_mm.ref import mm_block_ref, mm_sync_ref

__all__ = [
    "BACKENDS",
    "contour_cc_fixpoint",
    "contour_mm_step",
    "fused_relax",
    "mm_block_ref",
    "mm_relax_backend",
    "mm_sync_ref",
    "mm_update_stream",
    "reset_launch_counts",
    "scatter_min",
]
