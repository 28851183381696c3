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
        fn.argtypes = [_VP] * 12 + [_I] * 7 + [_VP]
        fn.restype = _I
        lib.ws_fusion_num_consts.restype = _I
        lib.ws_fusion_max_channels.restype = _I
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


def fusion_sweep_merge(value, weight, cx, cy, cz, rng_tab, endpoint,
                       scanner_mm, rotation, *, tau, max_weight, resolution,
                       channels, columns, vfov_deg, level: bool) -> None:
    """Sweep the (X, Y, Z) window given by per-axis scanner-relative
    coordinates ``cx, cy, cz`` (f32 mm, array order, as
    ``ops/tsdf_projective.relative_coords`` gives them: ``cz`` ascending up
    to the ring's rotation) against the beam table and merge the result
    into ``value``/``weight`` (int16) IN PLACE.

    ``level=True`` runs the level sweep (``level_kernel``), which requires
    ``rotation`` to be the identity; where its beam rows exceed the shared
    memory a block can opt into (``max_level_channels``), the general
    sweep runs at the identity instead, which gives the same bits
    (csrc/fusion.cu).  ``launches`` counts every call that launches the
    kernel, ``general_launches`` those that ran the general sweep."""
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
    if not 0 < X <= _build.MAX_GRID_Y or min(Y, Z) < 1:
        raise ValueError(f"window extents {(X, Y, Z)} out of the kernel's "
                         f"launch range (1 <= X <= {_build.MAX_GRID_Y})")
    coords = [c.to(torch.float32).contiguous() for c in (cx, cy, cz)]
    if [c.numel() for c in coords] != [X, Y, Z] or any(
            c.device != value.device for c in coords):
        raise ValueError("cx/cy/cz must match the window extents and device")
    if rng_tab.numel() != channels * columns:
        raise ValueError("beam table size != channels * columns")
    lib = _lib()
    general = not level or channels > max_level_channels()
    dev = value.device
    rng = rng_tab.to(device=dev, dtype=torch.float32).contiguous()
    ends = endpoint.to(device=dev, dtype=torch.float32).contiguous()
    scanner = scanner_mm.to(device=dev, dtype=torch.int32).contiguous()
    if ends.shape != (channels * columns, 3) or scanner.numel() != 3:
        raise ValueError("endpoint must be (channels * columns, 3) and "
                         "scanner_mm (3,)")
    # scratch the kernel fills: float4 beam rows and each row's maximum
    beams = torch.empty((channels * columns, 4), dtype=torch.float32,
                        device=dev)
    rowmax = torch.empty(columns, dtype=torch.float32, device=dev)
    # the general sweep's per-z rotation terms and its range limit
    zterm = (torch.empty((Z + 1, 4), dtype=torch.float32, device=dev)
             if general else None)
    consts = fusion_consts(rotation, **kw)
    assert len(consts) == lib.ws_fusion_num_consts()
    carr = (ctypes.c_float * len(consts))(*consts)
    rc = lib.ws_fusion_sweep_merge(
        value.data_ptr(), weight.data_ptr(), coords[0].data_ptr(),
        coords[1].data_ptr(), coords[2].data_ptr(), rng.data_ptr(),
        ends.data_ptr(), scanner.data_ptr(), beams.data_ptr(),
        rowmax.data_ptr(), None if zterm is None else zterm.data_ptr(),
        ctypes.cast(carr, _VP), X, Y, Z, channels, columns, int(max_weight),
        int(not general), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fusion kernel K1")
    fusion_sweep_merge.launches += 1
    if general:
        fusion_sweep_merge.general_launches += 1


fusion_sweep_merge.launches = 0
fusion_sweep_merge.general_launches = 0


def max_level_channels() -> int:
    """The largest channel count the level sweep takes on the current CUDA
    device: two beam rows per warp in the shared memory a block can opt
    into (1,816 channels on an H100)."""
    n = _lib().ws_fusion_max_channels()
    if n < 0:
        _build.check(-n, "fusion kernel K1's shared-memory query")
    return n
