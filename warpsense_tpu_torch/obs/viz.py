"""TSDF map visualization exports.

Counterpart of ``warpsense_tpu/obs/viz.py``: the reference's RViz
publishing (publish_local_map's marker cloud colored by signed TSDF value
and publish_local_map_skeleton's window box,
include/warpsense/visualization/map.h:14-246) as file exports: a colored
PLY of the occupied window cells and a line-skeleton of the window bounds.

A ``LocalMapState`` of tensors is read with one ``.cpu()`` per plane; the
rest is numpy, so the PLY bytes equal the JAX package's for the same map.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..io.pcd import write_ply
from ..map.local_map import LocalMapState


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


def tsdf_cloud(state: LocalMapState, *, resolution: int, tau: int,
               value_limit: float | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Occupied cells -> (points (N, 3) meters, colors (N, 3) uint8).

    Negative values (behind surface) fade red, positive fade green —
    the reference's intensity scheme re-expressed as RGB.
    """
    value = _host(state.value, np.int32)
    weight = _host(state.weight, np.int32)
    pos = _host(state.pos, np.int64)
    offset = _host(state.offset, np.int64)
    size = np.asarray(value.shape, np.int64)
    limit = float(value_limit if value_limit is not None else tau)

    occ = (weight > 0) & (np.abs(value) < limit)
    a = np.argwhere(occ)                       # array coords
    # invert ring indexing: global = pos + ((a - offset + s/2) mod s) - s/2
    rel = np.mod(a - offset + size // 2, size) - size // 2
    g = pos + rel
    pts = (g * resolution + resolution / 2.0) / 1000.0

    v = value[occ].astype(np.float64) / max(limit, 1.0)
    colors = np.zeros((len(v), 3), np.uint8)
    neg = v < 0
    colors[neg, 0] = np.clip(255 * (1.0 + v[neg]), 0, 255).astype(np.uint8)
    colors[~neg, 1] = np.clip(255 * (1.0 - v[~neg]), 0, 255).astype(np.uint8)
    colors[:, 2] = np.clip(64 * (1.0 - np.abs(v)), 0, 255).astype(np.uint8)
    return pts.astype(np.float32), colors


def export_tsdf_ply(path: str | Path, state: LocalMapState, *,
                    resolution: int, tau: int) -> int:
    pts, colors = tsdf_cloud(state, resolution=resolution, tau=tau)
    write_ply(path, pts, colors)
    return len(pts)


def window_skeleton(state: LocalMapState, *, resolution: int,
                    points_per_edge: int = 32) -> np.ndarray:
    """Window bounding-box edges as a polyline point cloud (meters);
    parity publish_local_map_skeleton (map.h:175-246)."""
    pos = _host(state.pos, np.float64)
    size = np.asarray(tuple(state.value.shape), np.float64)
    half = size / 2.0
    lo = (pos - half) * resolution / 1000.0
    hi = (pos + half) * resolution / 1000.0
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]])
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    ts = np.linspace(0.0, 1.0, points_per_edge)[:, None]
    segs = [corners[i] + ts * (corners[j] - corners[i]) for i, j in edges]
    return np.concatenate(segs).astype(np.float32)
