from repro_torch.kernels.flash_attention.kernel import (flash_mha,
                                                        flash_mha_plain)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_ref

__all__ = ["flash_attention", "flash_mha", "flash_mha_plain", "mha_ref"]
