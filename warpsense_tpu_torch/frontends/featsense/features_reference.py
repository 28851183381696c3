"""Feature-stage parameters and block layout (numpy, no JAX).

The part of ``warpsense_tpu/frontends/featsense/features_reference.py``
that the tensor feature stage needs; that module's numpy twin of the whole
stage stays the test oracle.  Blocks follow lidar_processing.cpp:230-237.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FeatureParams:
    min_distance: float = 2.0
    max_distance: float = 50.0
    edge_threshold: float = 2.5
    surf_threshold: float = 0.1
    max_edge_per_block: int = 20
    max_surf_per_block: int = 20


def block_bounds(W: int) -> list[tuple[int, int]]:
    """[sp, ep) column ranges of the per-row extraction blocks: starts at
    5, step W//6, clipped to W-6."""
    step = W // 6
    return [(sp, min(sp + step, W - 6)) for sp in range(5, W - 6, step)]
