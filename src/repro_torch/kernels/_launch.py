"""Input checks and launch plumbing shared by the float kernels
(``fused_rmsnorm``, ``flash_attention``).

Each of their wrappers runs its CUDA kernel on CUDA tensors and its plain
version on CPU tensors, and raises on anything else: tensors on two
devices, another device type, or an element type the kernel does not
take.  The C launchers return ``cudaGetLastError()`` of their launch;
:func:`raise_on_error` turns a code other than 0 into ``RuntimeError``.
"""
from __future__ import annotations

import torch

# the kernels' element types, by the code their C interfaces take
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if the tensors lie on one CUDA device, False if all on the
    CPU; raises ValueError otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for tensors on {device}")
    return device.type == "cuda"


def check_dtype(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} must be float32, bfloat16 or float16, got "
                        f"{t.dtype}")


def raise_on_error(rc: int, what: str, error_string) -> None:
    """Raise RuntimeError for a launch that returned CUDA error ``rc``;
    ``error_string`` is the library's ``cudaGetErrorString``."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({error_string(rc).decode()})")
