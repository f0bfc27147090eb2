"""Assigned-architecture registry: ``--arch <id>`` resolution (the port's
``repro.configs``).

Ten architectures from the public pool (see per-module docstrings for the
exact assignment line and citation), copied field for field with torch
dtypes; ``build_model`` builds every family.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import SHAPES, ArchSpec, ShapeSpec, input_specs

from repro_torch.configs.stablelm_1_6b import ARCH as _stablelm
from repro_torch.configs.olmo_1b import ARCH as _olmo
from repro_torch.configs.mistral_nemo_12b import ARCH as _nemo
from repro_torch.configs.yi_6b import ARCH as _yi
from repro_torch.configs.xlstm_125m import ARCH as _xlstm
from repro_torch.configs.zamba2_2_7b import ARCH as _zamba
from repro_torch.configs.deepseek_moe_16b import ARCH as _dsmoe
from repro_torch.configs.arctic_480b import ARCH as _arctic
from repro_torch.configs.llava_next_34b import ARCH as _llava
from repro_torch.configs.seamless_m4t_large_v2 import ARCH as _seamless

ARCHS: Dict[str, ArchSpec] = {
    a.name: a
    for a in (
        _stablelm, _olmo, _nemo, _yi, _xlstm,
        _zamba, _dsmoe, _arctic, _llava, _seamless,
    )
}


def get_arch(name: str) -> ArchSpec:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ArchSpec", "ShapeSpec", "get_arch",
           "input_specs"]
