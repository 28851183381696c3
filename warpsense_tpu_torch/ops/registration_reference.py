"""Exact host-side reference of point-to-TSDF Gauss-Newton registration.

Counterpart of ``warpsense_tpu/ops/registration_reference.py``: numpy
integer statistics (the same code); the pose update of the GN loop goes
through this package's ``core.geometry.xi_to_transform`` in float64.

The framework's "CPU twin" for the device registration op — plays the role
src/cpu/registration.cpp plays for the reference's CUDA kernels.  Semantics
re-derived from:

* Jacobian + gradient masking — src/warpsense/cuda/registration.cu:194-257
* (H, g, e, c) accumulation   — src/warpsense/cuda/registration.cu:14-110
* GN loop, damping, 4-error convergence window —
  src/warpsense/tsdf_registration.cpp:28-105

All arithmetic is integer (int64 accumulators, like the reference's `long`)
so device-op parity tests have a bit-exact target.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.consts import MATRIX_RESOLUTION
from ..core.geometry import xi_to_transform


def c_div(a, b):
    """Elementwise C-style integer division (truncates toward zero)."""
    a = np.asarray(a, dtype=np.int64)
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (np.asarray(b) < 0), -q, q)


def transform_point_fixed_np(points: np.ndarray, int_mat: np.ndarray) -> np.ndarray:
    """(R_fixed @ p + t_fixed) / MATRIX_RESOLUTION with C truncation."""
    p = points.astype(np.int64)
    m = int_mat.astype(np.int64)
    out = p @ m[:3, :3].T + m[:3, 3]
    return c_div(out, MATRIX_RESOLUTION)


def jacobian_stats(points_mm: np.ndarray, local_map, total_transform: np.ndarray,
                   resolution: int):
    """Per-iteration statistics of the GN normal equations.

    Returns (H 6x6 int64, g 6 int64, e int, c int).
    ``local_map`` is a host LocalMap (value/weight int16 arrays + ring index).
    """
    int_mat = np.trunc(total_transform * MATRIX_RESOLUTION).astype(np.int64)
    center = total_transform[:3, 3].astype(np.int64)  # C cast: trunc toward 0

    pts = transform_point_fixed_np(np.asarray(points_mm, np.int64), int_mat)
    buf = np.floor_divide(pts, resolution)  # floor cells, like the device op
    p = pts - center

    size = np.asarray(local_map.size)
    pos = np.asarray(local_map.state.pos, dtype=np.int64)
    off = np.asarray(local_map.state.offset, dtype=np.int64)
    value_arr = np.asarray(local_map.state.value)
    weight_arr = np.asarray(local_map.state.weight)

    H = np.zeros((6, 6), dtype=np.int64)
    g = np.zeros((6,), dtype=np.int64)
    e = 0
    c = 0

    def entry(ix):
        a = (ix - pos + off) % size
        return (int(value_arr[a[0], a[1], a[2]]), int(weight_arr[a[0], a[1], a[2]]))

    half = size // 2
    for i in range(len(pts)):
        b = buf[i]
        # in_bounds_with_buffer_neg(buf, 1): window shrunk by 1 voxel
        if not np.all(np.abs(b - pos) <= half - 1):
            continue
        cur_v, cur_w = entry(b)
        if cur_w == 0:
            continue
        grad = np.zeros(3, dtype=np.int64)
        for ax in range(3):
            nb = b.copy(); nb[ax] += 1
            pb = b.copy(); pb[ax] -= 1
            nv, nw = entry(nb)
            pv, pw = entry(pb)
            if nw != 0 and pw != 0 and not ((nv > 0) != (pv > 0) and nv != 0 and pv != 0):
                # reference test: sign change between the two neighbors rejects
                # the axis (registration.cu:225-246); matches
                # (nv>0 && pv<0)||(nv<0 && pv>0)
                if not ((nv > 0 and pv < 0) or (nv < 0 and pv > 0)):
                    grad[ax] = int(c_div(nv - pv, 2))
        cross = np.cross(p[i], grad)
        J = np.concatenate([cross, grad]).astype(np.int64)
        H += np.outer(J, J)
        g += J * cur_v
        e += abs(cur_v)
        c += 1
    return H, g, e, c


def register_cloud_reference(points_mm, local_map, pretransform, *,
                             resolution: int, max_iterations: int,
                             it_weight_gradient: float, epsilon: float):
    """Full GN loop (tsdf_registration.cpp:28-105).  Returns 4x4 float pose."""
    total = np.array(pretransform, dtype=np.float32)
    center = total[:3, 3].astype(np.int64)
    alpha = 0.0
    prev = [0.0, 0.0, 0.0, 0.0]
    for _ in range(max_iterations):
        H, g, e, c = jacobian_stats(points_mm, local_map, total, resolution)
        if c == 0:
            break
        hf = H.astype(np.float64) + alpha * c * np.eye(6)
        try:
            xi = -np.linalg.solve(hf, g.astype(np.float64))
        except np.linalg.LinAlgError:
            break
        transform = xi_to_transform(
            torch.as_tensor(xi, dtype=torch.float64),
            torch.as_tensor(center)).numpy().astype(np.float32)
        alpha += it_weight_gradient
        total = transform @ total
        err = e / c
        if abs(err - prev[2]) < epsilon and abs(err - prev[0]) < epsilon:
            break
        prev = prev[1:] + [err]
    return total
