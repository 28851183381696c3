"""Peaks of the card and the least bytes of each measured piece of work.

Peaks: NVIDIA's H100 SXM data sheet (dense, 700 W).  A share of a peak is
the least time the work needs at that peak over the time it took.  The
bytes count each input read once and each output written once, from the
inputs and outputs of the call, whatever implements it.
"""
from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


def hbm_bytes_per_s(card: str) -> float | None:
    """The published HBM bandwidth of ``card``; None for a card this
    table does not hold (its shares are then not reported)."""
    return H100_HBM_BYTES_PER_S if "H100" in card else None


def fusion_bytes(changed_voxels: int, points: int) -> int:
    """One fusion: each voxel whose value or weight changed is read and
    written (int16 value and weight: 4 bytes each way), and the scan's
    points are read (three int32 each)."""
    return 8 * int(changed_voxels) + 12 * int(points)


def fields_bytes(window_voxels: int, out_bytes: int) -> int:
    """One fields computation: the window's value and weight read once
    (4 bytes a voxel) and the fields written once."""
    return 4 * int(window_voxels) + int(out_bytes)


def share_pct(nbytes: float, seconds: float, card: str) -> float | None:
    """100 x the least time of ``nbytes`` over ``seconds``."""
    bw = hbm_bytes_per_s(card)
    if bw is None or seconds <= 0:
        return None
    return 100.0 * (nbytes / bw) / seconds
