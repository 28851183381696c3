"""Fusion-backend dispatch shared by both pipelines.

Counterpart of ``warpsense_tpu/pipeline/fusion_backend.py``: resolves the
fusion name, picks the beam-grid attitude, and runs the projective update
or the ray march.  For the projective update the device of the state picks
the implementation: a CUDA state runs kernel K1 (``kernels/fusion.py``), a
CPU state its plain version.  The ray march is plain PyTorch on either.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.consts import MATRIX_RESOLUTION
from ..core.geometry import to_int_mat, transform_point_fixed
from ..kernels._build import MAX_VOXELS
from ..map.local_map import LocalMapState
from ..ops.tsdf import tsdf_update
from ..ops.tsdf_projective import tsdf_update_projective


def sensor_tilt_deg(pose_mm: np.ndarray) -> float:
    """Tilt of the sensor z axis from the map vertical, degrees."""
    R = np.asarray(pose_mm, np.float64)[:3, :3]
    return float(np.degrees(np.arccos(np.clip(R[2, 2], -1.0, 1.0))))


def level_tilt_budget_deg(vfov_deg: float) -> float:
    """Tilt envelope of the LEVEL map-aligned beam grid: 2 degrees (ring
    aliasing dominates the coverage deficit at any tilt > 0; band clipping
    grows with tilt).  Beyond it dispatch bins with the sensor attitude."""
    del vfov_deg
    return 2.0


def grid_rotation_for(pose_mm: np.ndarray, vfov_deg: float,
                      budget_deg: float | None = None):
    """(rotation 3x3 float32 CPU tensor, level: bool) — the beam-grid
    attitude for a scan captured at ``pose_mm``: identity (level grid)
    inside the tilt envelope, the sensor attitude beyond it."""
    budget = (level_tilt_budget_deg(vfov_deg) if budget_deg is None
              else budget_deg)
    if sensor_tilt_deg(pose_mm) <= budget:
        return torch.eye(3, dtype=torch.float32), True
    return torch.as_tensor(np.asarray(pose_mm, np.float32)[:3, :3].copy()), \
        False


def resolve_fusion(fusion: str, *, size, channels: int,
                   columns: int = 1024) -> str:
    """"auto" -> "projective-level" (the production level grid with the
    attitude fallback) when the window fits K1's 32-bit voxel index;
    explicit names pass through.  K1 takes any z extent, channel count and
    column count: its level sweep stages two beam rows per warp in shared
    memory, which holds up to 1,816 channels on an H100 (after opting in
    to the 232,448 bytes a block can have); beyond that its wrapper runs
    the general sweep at the identity rotation, which gives the same bits,
    so no channel count raises."""
    del channels, columns
    if fusion != "auto":
        return fusion
    n = int(size[0]) * int(size[1]) * int(size[2])
    if n > MAX_VOXELS:
        raise ValueError(f"window of {n} voxels exceeds the fusion kernel's "
                         f"{MAX_VOXELS}-voxel index")
    return "projective-level"


def fuse_cloud(state: LocalMapState, pts_mm, mask, pose_mm: np.ndarray, *,
               params, size, fusion: str, max_steps: int | None = None,
               max_isteps: int | None = None) -> LocalMapState:
    """One fusion step of a map-frame mm cloud captured at ``pose_mm``, IN
    PLACE on ``state``'s planes.

    ``fusion``: "raymarch" (the reference's ray march, ``ops/tsdf.py``;
    needs ``max_steps``/``max_isteps`` from ``plan_raymarch``),
    "projective" (bins with the sensor attitude), "projective-level" (bins
    on the level map-aligned grid inside the tilt envelope and falls back
    to the attitude grid beyond it) or "auto"."""
    m = params.map
    fusion = resolve_fusion(fusion, size=size,
                            channels=params.lidar.channels,
                            columns=params.lidar.hresolution)
    if fusion not in ("raymarch", "projective", "projective-level"):
        raise ValueError(f"unknown fusion {fusion!r}")
    scanner_pos = torch.as_tensor(
        np.floor(np.asarray(pose_mm)[:3, 3] / m.resolution).astype(np.int32),
        device=state.value.device)
    if fusion == "raymarch":
        if max_steps is None or max_isteps is None:
            raise ValueError("raymarch fusion needs max_steps and max_isteps "
                             "(ops.tsdf.plan_raymarch)")
        # the sensor's up vector in the map frame, MR-scaled, through the
        # same fixed-point rotation the reference uses
        int_rot = to_int_mat(torch.as_tensor(np.asarray(pose_mm, np.float32)))
        int_rot[:3, 3] = 0
        up = transform_point_fixed(
            torch.tensor([0, 0, MATRIX_RESOLUTION], dtype=torch.int32),
            int_rot)
        return tsdf_update(
            state, pts_mm, mask, scanner_pos, up, size=size, tau=m.tau,
            max_weight=m.max_weight_scaled, resolution=m.resolution,
            max_steps=max_steps, max_isteps=max_isteps,
            channels=params.lidar.channels, vfov_deg=params.lidar.vfov)
    if fusion == "projective":
        grid_rot, level = torch.as_tensor(
            np.asarray(pose_mm, np.float32)[:3, :3].copy()), False
    else:
        grid_rot, level = grid_rotation_for(pose_mm, params.lidar.vfov)
    return tsdf_update_projective(
        state, pts_mm, mask, scanner_pos, grid_rot, size=size, tau=m.tau,
        max_weight=m.max_weight_scaled, resolution=m.resolution,
        channels=params.lidar.channels, columns=params.lidar.hresolution,
        vfov_deg=params.lidar.vfov, level=level)
