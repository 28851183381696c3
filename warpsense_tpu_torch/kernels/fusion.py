"""Wrappers of ``csrc/fusion.cu``: the fusion's table step and kernel K1,
the projective TSDF sweep + merge, in place on the int16 map planes.

K1 replaces the TPU kernels ``warpsense_tpu/kernels/tsdf_pallas.py``
``_fusion_kernel_level16`` (level grid) and ``_fusion_kernel`` (attitude
grid); the table step replaces the eager beam table
(``ops/tsdf_projective.build_beam_table``, XLA in the JAX package).  CUDA
tensors launch the kernels (or raise); CPU tensors run the plain PyTorch
versions, ``ops/tsdf_projective.fusion_table_plain`` and
``sweep_rows_plain``.  A fusion is ``fusion_table``, then
``fusion_sweep_merge`` on its rows.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from ..ops.tsdf_projective import (_ATAN_COEFFS, dz_per_distance,
                                   fusion_table_plain, sweep_rows_plain)
from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("fusion")
    if lib.ws_fusion_sweep_merge.argtypes is None:
        lib.ws_fusion_sweep_merge.argtypes = [_VP] * 9 + [_I] * 7 + [_VP]
        lib.ws_fusion_table.argtypes = [_VP] * 13
        lib.ws_fusion_table_sizes.argtypes = [ctypes.POINTER(_I)]
        for fn in (lib.ws_fusion_sweep_merge, lib.ws_fusion_table,
                   lib.ws_fusion_num_consts,
                   lib.ws_fusion_max_channels, lib.ws_fusion_table_sizes):
            fn.restype = _I
        sizes = (_I * 2)()
        lib.ws_fusion_table_sizes(sizes)
        # the table step's float and int parameters, checked at each call
        lib.table_sizes = tuple(sizes)
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


def _host_ints(v) -> list[int]:
    """Three ints from a sequence, a numpy array or a tensor (a CUDA
    tensor is read back: a sync)."""
    out = v.tolist() if isinstance(v, torch.Tensor) else [int(x) for x in v]
    if len(out) != 3:
        raise ValueError(f"scanner voxel must have 3 coordinates: {out}")
    return out


def fusion_table(points, mask, pos, offset, scanner_voxel, rotation, *,
                 size, tau, resolution, channels, columns, vfov_deg,
                 x_rows: tuple[int, int] | None = None):
    """The fusion's table step: the scan's beam table as K1's prepared
    rows, and the sweep's coordinates.  Returns ``(beams, rowmax, cx, cy,
    cz)``: ``beams`` (columns*channels, 4) float32 rows (bx, by, bz,
    range), the nearest return's endpoint relative to the scanner and its
    range (+inf at a hole); ``rowmax`` (columns,) each azimuth column's
    largest finite range; ``cx`` (rows ``x_rows`` of the window, all
    without it), ``cy``, ``cz``, the voxel centers relative to the scanner
    (f32 mm, array order).

    ``points`` (N, 3) int32 mm (map frame), ``mask`` (N,) bool, ``pos`` and
    ``offset`` the window's center voxel and ring offset (int32 (3,), on
    the points' device), ``scanner_voxel`` three ints, ``rotation`` the
    3x3 grid rotation (CPU).  Points outside the window grown by tau / 2
    are dropped, as the ray march drops them.

    On the card one call of ``csrc/fusion.cu``'s ``ws_fusion_table`` (a
    memset, the bin kernel, ``prepare_kernel``): nothing is copied from the
    host and nothing synchronises, and the result is the plain version's
    bit for bit.  On the CPU the plain version
    (``ops/tsdf_projective.fusion_table_plain``).  ``launches`` counts the
    calls that launched the step."""
    kw = dict(size=size, tau=tau, resolution=resolution, channels=channels,
              columns=columns, vfov_deg=vfov_deg, x_rows=x_rows)
    dev = points.device
    if dev.type == "cpu":
        return fusion_table_plain(points, mask, pos, offset, scanner_voxel,
                                  rotation, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    X, Y, Z = (int(s) for s in size)
    lo, hi = (0, X) if x_rows is None else (int(x_rows[0]), int(x_rows[1]))
    n = points.shape[0]
    if not 0 <= lo < hi <= X or min(Y, Z) < 1:
        raise ValueError(f"rows [{lo}, {hi}) of window {(X, Y, Z)}")
    if points.dtype != torch.int32 or points.shape != (n, 3) \
            or not points.is_contiguous():
        raise ValueError("points must be a contiguous (N, 3) int32 tensor")
    if n >= 1 << 17:
        raise ValueError("the beam table supports at most 128K points")
    if mask.dtype != torch.bool or mask.shape != (n,) \
            or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous (N,) bool tensor")
    if any(t.dtype != torch.int32 or t.numel() != 3
           or not t.is_contiguous() for t in (pos, offset)):
        raise ValueError("pos and offset must be contiguous int32 (3,)")
    if any(t.device != dev for t in (mask, pos, offset)):
        raise ValueError("mask, pos and offset must be on the points' "
                         "device")
    lib = _lib()
    nb = channels * columns
    # one allocation: the rows, the maxima, the coordinates, the keys
    buf = torch.empty(5 * nb + columns + (hi - lo) + Y + Z,
                      dtype=torch.float32, device=dev)
    beams = buf[:4 * nb].view(nb, 4)
    rest = buf[4 * nb:].split([columns, hi - lo, Y, Z, nb])
    rowmax, cx, cy, cz, keys = rest
    spacing = math.radians(vfov_deg) / (channels - 1)
    R = rotation.detach().to(device="cpu", dtype=torch.float32).reshape(9)
    consts = [*R.tolist(), math.radians(vfov_deg) / 2.0, spacing, math.pi,
              2 * math.pi, float(columns)]
    ints = [n, channels, columns, X, Y, Z, lo, hi, resolution,
            *_host_ints(scanner_voxel), tau // resolution // 2]
    assert (len(consts), len(ints)) == lib.table_sizes
    carr = (ctypes.c_float * len(consts))(*consts)
    iarr = (_I * len(ints))(*ints)
    rc = lib.ws_fusion_table(
        points.data_ptr(), mask.data_ptr(), pos.data_ptr(),
        offset.data_ptr(), keys.data_ptr(), beams.data_ptr(),
        rowmax.data_ptr(), cx.data_ptr(), cy.data_ptr(), cz.data_ptr(),
        ctypes.cast(carr, _VP), ctypes.cast(iarr, _VP),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "the fusion's table step")
    fusion_table.launches += 1
    return beams, rowmax, cx, cy, cz


fusion_table.launches = 0


def _window(value, weight) -> tuple[int, int, int]:
    """The window's extents; raises where K1 cannot take its planes."""
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
    return X, Y, Z


def fusion_sweep_merge(value, weight, cx, cy, cz, beams, rowmax, rotation,
                       *, tau, max_weight, resolution, channels, columns,
                       vfov_deg, level: bool) -> None:
    """Kernel K1 on prepared rows: sweep the (X, Y, Z) window given by
    per-axis scanner-relative coordinates ``cx, cy, cz`` (f32 mm, array
    order, as ``fusion_table`` or ``ops/tsdf_projective.relative_coords``
    give them: ``cz`` ascending up to the ring's rotation) against the
    beam rows ``beams`` and their maxima ``rowmax`` (``fusion_table``'s,
    or ``ops/tsdf_projective.beam_rows``') and merge the result into
    ``value``/``weight`` (int16) IN PLACE.

    ``level=True`` runs the level sweep (``level_kernel``), which requires
    ``rotation`` to be the identity; where its beam rows exceed the shared
    memory a block can opt into (``max_level_channels``), the general
    sweep runs at the identity instead, which gives the same bits
    (csrc/fusion.cu).  On the CPU the plain version,
    ``ops/tsdf_projective.sweep_rows_plain``.  ``launches`` counts every
    sweep that launched K1, ``general_launches`` those that ran the
    general sweep."""
    if level and not torch.equal(rotation.detach().cpu().to(torch.float32),
                                 torch.eye(3)):
        raise ValueError("level fusion needs the identity grid rotation")
    kw = dict(tau=tau, resolution=resolution, channels=channels,
              columns=columns, vfov_deg=vfov_deg)
    if value.device.type == "cpu":
        sweep_rows_plain(value, weight, cx, cy, cz, beams, rotation,
                         max_weight=max_weight, **kw)
        return
    if value.device.type != "cuda":
        raise ValueError(f"unsupported device {value.device}")
    X, Y, Z = _window(value, weight)
    coords = [c.to(torch.float32).contiguous() for c in (cx, cy, cz)]
    if [c.numel() for c in coords] != [X, Y, Z] or any(
            c.device != value.device for c in coords):
        raise ValueError("cx/cy/cz must match the window extents and device")
    if beams.shape != (channels * columns, 4) or rowmax.shape != (columns,) \
            or beams.dtype != torch.float32 or rowmax.dtype != torch.float32 \
            or not (beams.is_contiguous() and rowmax.is_contiguous()) \
            or beams.device != value.device or rowmax.device != value.device:
        raise ValueError("beams must be (channels * columns, 4) and rowmax "
                         "(columns,) contiguous float32 on the window's "
                         "device")
    lib = _lib()
    general = not level or channels > max_level_channels()
    # the general sweep's per-z rotation terms and its range limit
    zterm = (torch.empty((Z + 1, 4), dtype=torch.float32, device=value.device)
             if general else None)
    consts = fusion_consts(rotation, **kw)
    assert len(consts) == lib.ws_fusion_num_consts()
    carr = (ctypes.c_float * len(consts))(*consts)
    rc = lib.ws_fusion_sweep_merge(
        value.data_ptr(), weight.data_ptr(), coords[0].data_ptr(),
        coords[1].data_ptr(), coords[2].data_ptr(), beams.data_ptr(),
        rowmax.data_ptr(), None if zterm is None else zterm.data_ptr(),
        ctypes.cast(carr, _VP), X, Y, Z, channels, columns, int(max_weight),
        int(not general),
        torch.cuda.current_stream(value.device).cuda_stream)
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
