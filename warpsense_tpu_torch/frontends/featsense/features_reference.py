"""Host (numpy) twin of the featsense feature stage.

The port's own copy of ``warpsense_tpu/frontends/featsense/
features_reference.py`` (a re-derivation of the F-LOAM-style organized
feature stage, src/featsense/lidar_processing.cpp:125-286): the golden
reference of the tensor feature stage (``features.py``) and one side of
``eval/feature_compare``.  It keeps that module's deliberate cleanups of
the reference's quirks (both passes stay inside the block, a plain
accept-at-most-N budget, stable curvature ties, independent blocks whose
edge pass suppresses their surf pass).  Blocks follow
lidar_processing.cpp:230-237.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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


def curvature_and_ranges(cloud: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """cloud: (H, W, 3).  Returns (curvature (H, W), ranges (H, W)).

    Curvature = |sum_{o=-5..5} p[v+o] - 11 p[v]|^2 over the row window
    (lidar_processing.cpp:190-216); defined for v in [5, W-6), +inf
    elsewhere (never a candidate).
    """
    H, W = cloud.shape[:2]
    curv = np.full((H, W), np.inf, dtype=np.float64)
    ranges = np.zeros((H, W), dtype=np.float64)
    pts = cloud.astype(np.float64)
    for u in range(H):
        for v in range(5, W - 6):
            window = pts[u, v - 5:v + 6].sum(axis=0) - 11.0 * pts[u, v]
            curv[u, v] = float(window @ window)
            ranges[u, v] = float(np.linalg.norm(pts[u, v]))
    return curv, ranges


def mark_occluded(ranges: np.ndarray, p: FeatureParams) -> np.ndarray:
    """Occlusion / range / parallel-beam mask (lidar_processing.cpp:136-188).
    True = point may not become a feature."""
    H, W = ranges.shape
    picked = np.zeros((H, W), dtype=bool)
    for u in range(H):
        for v in range(5, W - 6):
            d = ranges[u, v]
            dn = ranges[u, v + 1]
            dp = ranges[u, v - 1]
            if d < p.min_distance or d > p.max_distance:
                picked[u, v] = True
            if d - dn > 0.3:
                picked[u, v - 5:v + 1] = True
            if dn - d > 0.3:
                picked[u, v + 1:v + 7] = True
            if abs(dp - d) > 0.02 * d and abs(dn - d) > 0.02 * d:
                picked[u, v] = True
    return picked


def extract_features(cloud: np.ndarray, p: FeatureParams = FeatureParams()
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Full feature stage.  cloud: (H, W, 3) float, invalid points (0,0,0).

    Returns (edge_idx, surf_idx): arrays of flat indices u*W+v into the
    organized cloud, in (row, block, curvature-rank) acceptance order.
    """
    H, W = cloud.shape[:2]
    curv, ranges = curvature_and_ranges(cloud)
    picked = mark_occluded(ranges, p)

    edge_idx: list[int] = []
    surf_idx: list[int] = []
    for u in range(H):
        for sp, ep in block_bounds(W):
            cols = np.arange(sp, ep)
            order = cols[np.argsort(curv[u, sp:ep], kind="stable")]
            blocked = picked[u].copy()     # block-local suppression state

            n_edge = 0
            for v in order[::-1]:          # descending curvature
                if n_edge >= p.max_edge_per_block:
                    break
                if curv[u, v] >= p.edge_threshold and not blocked[v]:
                    edge_idx.append(u * W + v)
                    n_edge += 1
                    blocked[max(v - 5, 0):v + 5] = True

            n_surf = 0
            for v in order:                # ascending curvature
                if n_surf >= p.max_surf_per_block:
                    break
                if curv[u, v] <= p.surf_threshold and not blocked[v]:
                    surf_idx.append(u * W + v)
                    n_surf += 1
                    blocked[max(v - 5, 0):v + 6] = True

    return (np.asarray(edge_idx, dtype=np.int64),
            np.asarray(surf_idx, dtype=np.int64))
