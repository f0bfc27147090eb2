from repro_torch.kernels.fused_rmsnorm.kernel import (rmsnorm_rows,
                                                      rmsnorm_rows_plain)
from repro_torch.kernels.fused_rmsnorm.ops import fused_rmsnorm
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

__all__ = ["fused_rmsnorm", "rmsnorm_ref", "rmsnorm_rows",
           "rmsnorm_rows_plain"]
