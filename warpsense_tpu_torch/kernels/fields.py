"""Wrapper of CUDA kernel K2 (``csrc/fields.cu``): packed registration
fields from the map window.

Replaces the TPU kernel ``warpsense_tpu/kernels/fields_pallas.py``
``_rolling_kernel`` in both modes (packed one-plane and exact two-plane).
A CUDA state launches the kernel (or raises); a CPU state runs the plain
PyTorch versions ``ops/registration.precompute_fields_packed{,2}``.
"""
from __future__ import annotations

import ctypes

import torch

from ..map.local_map import LocalMapState
from ..ops.registration import (PackedFields, PackedFields2,
                                packed_shifts, precompute_fields_packed,
                                precompute_fields_packed2)
from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("fields")
    fn = lib.ws_fields_packed
    if fn.argtypes is None:
        fn.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP]
        fn.restype = _I
    return lib


def fields_packed(state: LocalMapState, *, tau: int, exact: bool = False):
    """``PackedFields`` (or ``PackedFields2`` with ``exact=True``) of the
    window in ``state``; the planes are new int32 tensors."""
    value, weight = state.value, state.weight
    if value.device.type == "cpu":
        return (precompute_fields_packed2(state) if exact
                else precompute_fields_packed(state, tau=tau))
    if value.device.type != "cuda":
        raise ValueError(f"unsupported device {value.device}")
    if value.dtype != torch.int16 or weight.dtype != torch.int16:
        raise TypeError("value/weight must be int16")
    if weight.shape != value.shape or not (value.is_contiguous()
                                           and weight.is_contiguous()):
        raise ValueError("value/weight must be contiguous and of one shape")
    X, Y, Z = value.shape
    if X * Y * Z > _build.MAX_VOXELS:
        raise ValueError("window exceeds the kernel's 32-bit voxel index")
    vs, gs = packed_shifts(tau)
    a = torch.empty(value.shape, dtype=torch.int32, device=value.device)
    b = torch.empty_like(a) if exact else a
    rc = _lib().ws_fields_packed(
        value.data_ptr(), weight.data_ptr(), a.data_ptr(), b.data_ptr(),
        X, Y, Z, vs, gs, int(bool(exact)),
        torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(rc, "fields kernel K2")
    fields_packed.launches += 1
    return PackedFields2(plane_a=a, plane_b=b) if exact else PackedFields(
        plane=a)


fields_packed.launches = 0
