#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s LM mesh phase alone on one CUDA GPU.

``chip_smoke.phase_lm_mesh``: on a 1-rank NCCL mesh in this process,
olmo-1b's train step at full width and depth against the mesh-less step
and mistral-nemo-12b's greedy tokens after a prefill of 4096 tokens
against the mesh-less ones; then ``LM_MESH_RANKS`` gloo ranks sharing
the card on ``make_host_mesh(2)`` (full width, 2 layers, float32), each
case against the same model without a mesh on rank 0, with each rank's
bytes and collectives.  The mesh-less step's mean ms that
``train_path`` would measure is printed as null.  Run from the root of a
checkout::

    python3 tools/lm_mesh.py

It prints the card's name and power limit and one JSON line per result.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_mesh: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.device_line()
    print(card, flush=True)
    cs.phase_lm_mesh(card, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
