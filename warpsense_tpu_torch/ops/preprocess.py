"""Scan preprocessing: voxel snap + dedup + fixed-point pose transform.

Counterpart of ``warpsense_tpu/ops/preprocess.py`` (``App::preprocess``,
src/warpsense/app.cpp:120-148), bit-exact with it.  The cloud keeps a static
shape: voxel keys are sorted, duplicates masked, and valid points compacted
to the front.  ``preprocess`` runs ``preprocess_plain`` on CPU tensors and
the CUDA kernel (``kernels/preprocess.preprocess``, one launch, no sync) on
CUDA tensors; both give these bits.  In the plain version
``jnp.lexsort((cz, cy, cx))`` becomes three stable sorts (least
significant key first), and the compaction stays a stable argsort.
"""
from __future__ import annotations

import torch

from ..core.geometry import to_int_mat, transform_point_fixed


def _lexsort3(cx: torch.Tensor, cy: torch.Tensor,
              cz: torch.Tensor) -> torch.Tensor:
    """Indices sorting by (cx, cy, cz), ties kept in input order."""
    order = torch.argsort(cz, stable=True)
    order = order[torch.argsort(cy[order], stable=True)]
    return order[torch.argsort(cx[order], stable=True)]


def preprocess(points_m: torch.Tensor, valid: torch.Tensor, pose, *,
               resolution: int, capacity: int,
               snap: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``preprocess_plain`` on a CPU cloud, the CUDA kernel on a CUDA one
    (``kernels/preprocess.preprocess``: one launch, no host copy, no
    sync).  ``pose``: the 4x4 float32 pose (mm translation) on the host, a
    numpy array or a CPU tensor, on either route."""
    if points_m.device.type == "cpu":
        return preprocess_plain(points_m, valid, torch.as_tensor(pose),
                                resolution=resolution, capacity=capacity,
                                snap=snap)
    from ..kernels.preprocess import preprocess as kernel
    return kernel(points_m, valid, pose, resolution=resolution,
                  capacity=capacity, snap=snap)


def preprocess_plain(points_m: torch.Tensor, valid: torch.Tensor,
                     pose: torch.Tensor, *, resolution: int, capacity: int,
                     snap: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """points_m: (N, 3) float32 meters (padded rows arbitrary); valid: (N,)
    bool; pose: 4x4 float32 (mm translation), all on one device.

    Returns (points (min(N, capacity), 3) int32 mm, mask (min(N,
    capacity),) bool): deduplicated voxel representatives in the map
    frame, valid first.
    ``snap=True`` returns voxel centers (reference parity); ``snap=False``
    keeps the first point's true mm coordinates per voxel (fast mode)."""
    x, y, z = points_m[:, 0], points_m[:, 1], points_m[:, 2]
    near = (x < 0.3) & (y < 0.3) & (z < 0.3)   # reference quirk: AND, not norm
    keep = valid & ~near & torch.all(torch.isfinite(points_m), dim=-1)

    mm = points_m * 1000.0
    center = (torch.floor(mm / resolution) * resolution
              + resolution // 2).to(torch.int32)

    big = torch.tensor(2 ** 30, dtype=torch.int32, device=points_m.device)
    cx = torch.where(keep, center[:, 0], big)
    cy = torch.where(keep, center[:, 1], big)
    cz = torch.where(keep, center[:, 2], big)
    order = _lexsort3(cx, cy, cz)
    sc = center[order]
    skeep = keep[order]

    first = torch.cat([torch.ones((1,), dtype=torch.bool,
                                  device=points_m.device),
                       torch.any(sc[1:] != sc[:-1], dim=-1)])
    uniq = skeep & first
    if not snap:
        sc = torch.round(mm).to(torch.int32)[order]

    comp = torch.argsort((~uniq).to(torch.uint8), stable=True)[:capacity]
    out_pts = sc[comp]
    out_mask = uniq[comp]

    transformed = transform_point_fixed(out_pts, to_int_mat(pose))
    return torch.where(out_mask[:, None], transformed,
                       torch.zeros_like(transformed)), out_mask


def preprocess_host(points_m, *, resolution: int, capacity: int,
                    near_limit_m: float = 0.3, backend: str = "native"):
    """Host preprocessing twin: the same mm scale -> voxel-center snap ->
    dedup -> near filter as ``preprocess``, without the pose transform (the
    caller applies it, or feeds the centers straight to the device).
    Returns numpy (points (capacity, 3) int32 mm, mask (capacity,) bool);
    data-loader threads use it to shrink host-to-device transfers to the
    dedup'd cloud.

    ``backend="native"`` runs ``ws_preprocess`` (native/native.cpp; raises
    when the library cannot be built), ``"numpy"`` the numpy twin."""
    import ctypes

    import numpy as np

    pts = np.ascontiguousarray(points_m, dtype=np.float32).reshape(-1, 3)
    out = np.zeros((capacity, 3), dtype=np.int32)
    if backend == "native":
        from ..native import load as load_native
        n = int(load_native().ws_preprocess(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts),
            int(resolution), float(near_limit_m),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), capacity))
    elif backend == "numpy":
        keep = np.any(pts != 0.0, axis=1) & ~np.all(pts < near_limit_m, axis=1)
        mm = np.round(pts[keep] * 1000.0).astype(np.int64)
        vox = np.floor_divide(mm, resolution)
        _, first = np.unique(vox, axis=0, return_index=True)
        vox = vox[np.sort(first)][:capacity]
        n = len(vox)
        out[:n] = vox * resolution + resolution // 2
    else:
        raise ValueError(f"unknown preprocess_host backend {backend!r}")
    mask = np.zeros((capacity,), bool)
    mask[:n] = True
    return out, mask
