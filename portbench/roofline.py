"""Peaks of the card and the bytes a solve needs, frozen with the
benchmark so that a change to the program cannot change its yardstick.

Every share this benchmark reports is bounded by its memory term: the
connectivity kernels do a handful of integer operations a byte, far
below the ridge point of the card's 67 T int32 operations/s against its
3.35 TB/s (20 operations a byte), so bytes bound them all.
"""
from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3), data sheet: 3.35 TB/s of HBM at the full
# power limit of 700 W
HBM_BYTES_PER_S = 3.35e12


def sweep_bytes(n: int, m: int) -> int:
    """K1, one order-2 sweep (``fused_relax``): the labels read and the new
    labels written (4n + 4n) and both endpoints of every edge read once
    (8m)."""
    return 8 * n + 8 * m


def least_solve_bytes(n: int, m: int) -> int:
    """The least any solver moves: every edge read once (8m) and every
    label written once (4n)."""
    return 8 * m + 4 * n


def seconds_at_peak(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
