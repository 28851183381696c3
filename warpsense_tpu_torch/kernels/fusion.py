"""Wrapper of CUDA kernel K1 (``csrc/fusion.cu``): projective TSDF sweep +
merge, in place on the int16 map planes.

Replaces the TPU kernels ``warpsense_tpu/kernels/tsdf_pallas.py``
``_fusion_kernel_level16`` (level grid) and ``_fusion_kernel`` (attitude
grid).  A CUDA state launches the kernel (or raises); a CPU state runs the
plain PyTorch version, ``ops/tsdf_projective.sweep_merge_plain``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from ..ops.tsdf_projective import (_ATAN_COEFFS, dz_per_distance,
                                   sweep_merge_plain)
from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("fusion")
    fn = lib.ws_fusion_sweep_merge
    if fn.argtypes is None:
        fn.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                       _I, _I, _VP]
        fn.restype = _I
        lib.ws_fusion_num_consts.restype = _I
    return lib


def fusion_consts(rotation: torch.Tensor, *, tau, resolution, channels,
                  columns, vfov_deg) -> list[float]:
    """The kernel's float constants, in ``csrc/fusion.cu``'s enum order:
    each computed in Python double exactly as the JAX code writes it and
    rounded to float32 when handed over (as JAX rounds a weak Python float
    against a float32 array)."""
    spacing = math.radians(vfov_deg) / (channels - 1)
    weight_epsilon = tau // 10
    R = rotation.detach().to(device="cpu", dtype=torch.float32).reshape(9)
    return [*R.tolist(), *_ATAN_COEFFS,
            1e-20, math.pi / 2, math.pi, 1.0,
            math.radians(vfov_deg) / 2.0, 1.0 / spacing, spacing,
            columns / (2 * math.pi), 2 * math.pi / columns, 1e4,
            float(tau), float(dz_per_distance(channels, vfov_deg)),
            1.0 / MATRIX_RESOLUTION, resolution * 0.5,
            float(-weight_epsilon), float(WEIGHT_RESOLUTION),
            1.0 / (tau - weight_epsilon)]


def beam_table_float4(rng_tab, endpoint, scanner_mm) -> torch.Tensor:
    """(beams, 4) float32 rows (bx, by, bz, range): scanner-relative
    endpoints (the same f32 subtraction the sweep does) and range."""
    rel = endpoint - scanner_mm.to(torch.float32)
    return torch.cat([rel, rng_tab[:, None]], dim=1).contiguous()


def fusion_sweep_merge(value, weight, cx, cy, cz, rng_tab, endpoint,
                       scanner_mm, rotation, *, tau, max_weight, resolution,
                       channels, columns, vfov_deg, level: bool) -> None:
    """Sweep the (X, Y, Z) window given by per-axis scanner-relative
    coordinates ``cx, cy, cz`` (f32 mm) against the beam table and merge
    the result into ``value``/``weight`` (int16) IN PLACE.

    ``level=True`` runs the level-grid instantiation, which requires
    ``rotation`` to be the identity."""
    if level and not torch.equal(rotation.detach().cpu().to(torch.float32),
                                 torch.eye(3)):
        raise ValueError("level fusion needs the identity grid rotation")
    kw = dict(tau=tau, resolution=resolution, channels=channels,
              columns=columns, vfov_deg=vfov_deg)
    if value.device.type == "cpu":
        sweep_merge_plain(value, weight, cx, cy, cz, rng_tab, endpoint,
                          scanner_mm, rotation, max_weight=max_weight, **kw)
        return
    if value.device.type != "cuda":
        raise ValueError(f"unsupported device {value.device}")
    X, Y, Z = value.shape
    if value.dtype != torch.int16 or weight.dtype != torch.int16:
        raise TypeError("value/weight must be int16")
    if weight.shape != value.shape or not (value.is_contiguous()
                                           and weight.is_contiguous()):
        raise ValueError("value/weight must be contiguous and of one shape")
    if X * Y * Z > _build.MAX_VOXELS:
        raise ValueError("window exceeds the kernel's 32-bit voxel index")
    coords = [c.to(torch.float32).contiguous() for c in (cx, cy, cz)]
    if [c.numel() for c in coords] != [X, Y, Z] or any(
            c.device != value.device for c in coords):
        raise ValueError("cx/cy/cz must match the window extents and device")
    if rng_tab.numel() != channels * columns:
        raise ValueError("beam table size != channels * columns")
    beams = beam_table_float4(rng_tab, endpoint, scanner_mm).to(value.device)
    lib = _lib()
    consts = fusion_consts(rotation, **kw)
    assert len(consts) == lib.ws_fusion_num_consts()
    carr = (ctypes.c_float * len(consts))(*consts)
    rc = lib.ws_fusion_sweep_merge(
        value.data_ptr(), weight.data_ptr(), coords[0].data_ptr(),
        coords[1].data_ptr(), coords[2].data_ptr(), beams.data_ptr(),
        ctypes.cast(carr, _VP), X, Y, Z, channels, columns, int(max_weight),
        int(bool(level)), torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(rc, "fusion kernel K1")
    fusion_sweep_merge.launches += 1


fusion_sweep_merge.launches = 0
