"""Sums of groups of rows, in a fixed order on the card.

Featsense's voxel reductions (``frontends/featsense/odometry
.voxel_downsample`` and ``vgicp.build_voxel_table``) sum the rows of a
sorted cloud by group.  ``index_add_`` adds in row order on the CPU, but on
a CUDA tensor it adds with float atomics, whose order, and so whose last
bits, change from run to run: the card's featsense poses varied between
runs.  ``segment_sum`` keeps ``index_add_`` on the CPU and sums in a fixed
order on any other device (``segment_sum_fixed``).
"""
from __future__ import annotations

import torch

# rows summed at a time by the fixed-order sum
_BLOCK = 32


def segment_sum(values: torch.Tensor, gid: torch.Tensor,
                groups: int) -> torch.Tensor:
    """``(groups, *values.shape[1:])``: row ``g`` is the sum of the rows
    ``i`` of ``values`` with ``gid[i] == g`` (zero where there are none).
    ``gid`` (int64) must be ascending, so that a group's rows are
    contiguous.  CPU: ``index_add_`` (row order); otherwise
    ``segment_sum_fixed``."""
    if values.device.type == "cpu":
        return torch.zeros((groups, *values.shape[1:]), dtype=values.dtype,
                           device=values.device).index_add_(0, gid, values)
    return segment_sum_fixed(values, gid, groups)


def segment_sum_fixed(values: torch.Tensor, gid: torch.Tensor,
                      groups: int) -> torch.Tensor:
    """``segment_sum`` without atomics, in an order fixed by the shapes
    alone: each group's rows are cut into blocks of ``_BLOCK`` consecutive
    rows (one zero block for an empty group), each block is gathered into a
    padded row and summed, and the block sums of each group are summed the
    same way until one row per group is left.  Memory stays within the
    rows plus ``_BLOCK`` per group, whatever the longest group."""
    dev = values.device
    while True:
        counts = torch.bincount(gid, minlength=groups)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(values.shape[0], device=dev) - start[gid]
        blocks = torch.clamp((counts + _BLOCK - 1) // _BLOCK, min=1)
        first = torch.cumsum(blocks, 0) - blocks
        total = int(first[-1] + blocks[-1])
        padded = torch.zeros((total, _BLOCK, *values.shape[1:]),
                             dtype=values.dtype, device=dev)
        padded[first[gid] + rank // _BLOCK, rank % _BLOCK] = values
        sums = padded.sum(dim=1)
        if total == groups:                # one block per group: done
            return sums
        values = sums
        gid = torch.repeat_interleave(
            torch.arange(groups, device=dev), blocks)
