"""Wrapper of ``csrc/preprocess.cu``: scan preprocessing (voxel snap,
dedup, compaction, fixed-point pose transform) in one launch on the card.

It replaces no TPU kernel: the JAX package preprocesses with XLA
(``warpsense_tpu/ops/preprocess.py``), and the port's plain version,
``ops/preprocess.preprocess_plain``, runs the same eager ops.
``ops/preprocess.preprocess`` sends CPU tensors there and CUDA tensors
here.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.consts import MATRIX_RESOLUTION
from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("preprocess")
    if lib.ws_preprocess.argtypes is None:
        lib.ws_preprocess.argtypes = [_VP] * 5 + [_I] * 3 + [
            ctypes.c_float, _I, _VP, _VP]
        lib.ws_preprocess.restype = _I
        lib.ws_preprocess_max_points.restype = _I
    return lib


def int_mat(pose) -> np.ndarray:
    """``core.geometry.to_int_mat`` of a host pose as the card computes
    it: the top three rows times MATRIX_RESOLUTION (exact in float64 for a
    float32 or float64 pose) truncated to int32, saturating at the int32
    range and NaN to 0 as CUDA's float-to-int conversion does.  (3, 4)
    int32."""
    if isinstance(pose, torch.Tensor) and pose.device.type != "cpu":
        raise ValueError("the pose must be on the host (a numpy array or a "
                         "CPU tensor): reading a card pose would sync")
    m = np.asarray(pose, dtype=np.float64)
    if m.shape != (4, 4):
        raise ValueError(f"the pose must be 4x4, not {m.shape}")
    m = np.trunc(m[:3] * MATRIX_RESOLUTION)
    m = np.clip(np.where(np.isnan(m), 0.0, m), -2.0 ** 31, 2.0 ** 31 - 1)
    return np.ascontiguousarray(m, dtype=np.int32)


def preprocess(points_m: torch.Tensor, valid: torch.Tensor, pose, *,
               resolution: int, capacity: int, snap: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``ops/preprocess.preprocess_plain`` on the card in one launch of
    ``csrc/preprocess.cu``, bit for bit: ``points_m`` (N, 3) float32 and
    ``valid`` (N,) bool on one CUDA device, N at most 32,768 (one
    cluster); ``pose`` the 4x4 pose on the host (``int_mat``, passed with
    the launch).  Returns (points (min(N, capacity), 3) int32, mask).

    No host copy, no host read, no sync: outputs and scratch come from
    ``torch.empty`` and the launch goes on the current stream.
    ``launches`` counts the calls that launched the kernel."""
    dev = points_m.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocessing kernel runs on CUDA tensors, "
                         f"not on {dev}")
    n = points_m.shape[0]
    if points_m.dtype != torch.float32 or points_m.shape != (n, 3) \
            or not points_m.is_contiguous():
        raise ValueError("points_m must be a contiguous (N, 3) float32 "
                         "tensor")
    if valid.dtype != torch.bool or valid.shape != (n,) \
            or not valid.is_contiguous() or valid.device != dev:
        raise ValueError("valid must be a contiguous (N,) bool tensor on "
                         "the points' device")
    lib = _lib()
    if not 1 <= n <= lib.ws_preprocess_max_points():
        raise ValueError(f"the preprocessing kernel takes 1 to "
                         f"{lib.ws_preprocess_max_points()} points, not {n}")
    if capacity < 1 or resolution < 1:
        raise ValueError(f"capacity {capacity} and resolution {resolution} "
                         f"must be positive")
    mat = int_mat(pose)
    rows = min(n, capacity)
    out = torch.empty((rows, 3), dtype=torch.int32, device=dev)
    mask = torch.empty((rows,), dtype=torch.bool, device=dev)
    payload = torch.empty((n, 8), dtype=torch.int32, device=dev)
    # PyTorch's CUDA division by a Python scalar multiplies by its float32
    # reciprocal, computed on the host
    inv_res = float(np.float32(1.0) / np.float32(resolution))
    rc = lib.ws_preprocess(
        points_m.data_ptr(), valid.data_ptr(), payload.data_ptr(),
        out.data_ptr(), mask.data_ptr(), n, capacity, resolution, inv_res,
        int(snap), mat.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "the preprocessing kernel")
    preprocess.launches += 1
    return out, mask


preprocess.launches = 0
