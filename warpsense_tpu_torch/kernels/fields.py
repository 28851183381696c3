"""Wrappers of CUDA kernel K2 (``csrc/fields.cu``): registration fields
from the map window.

``fields_packed`` replaces the TPU kernel
``warpsense_tpu/kernels/fields_pallas.py`` ``_rolling_kernel`` in both
modes (packed one-plane and exact two-plane); ``fields_parity`` computes
the parity mode's three planes (``RegistrationFields``), which the JAX
package leaves to XLA.  A CUDA state launches the kernel (or raises); a
CPU state runs the plain PyTorch versions
``ops/registration.precompute_fields_packed{,2}`` and
``precompute_fields``.  A weight plane at another offset from a 16-byte
boundary than the value plane is first copied to the value's offset
(each wrapper's ``staged_copies`` counts it).

``plan_neighbors`` is the plain model of the kernel's addressing (its tile
plan, the staged halo, the z counter and the three wrap rules);
``tests/test_torch_fields_tiles.py`` holds it against ``torch.roll``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..map.local_map import LocalMapState
from ..ops.registration import (PackedFields, PackedFields2,
                                RegistrationFields, packed_shifts,
                                precompute_fields, precompute_fields_packed,
                                precompute_fields_packed2)
from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int

# the kernel's tile plan: csrc/fields.cu kTile, kThreads, kRun, kSlots
TILE, THREADS, RUN, SLOTS = 2048, 256, 16, 4
# shared memory a block may take on an H100 (dynamic, opted in)
MAX_SMEM_BYTES = 232_448


def smem_bytes(Z: int) -> int:
    """Shared memory of one K2 block: ``SLOTS`` staged planes of 4 bytes a
    position (value and weight), each a tile with a halo of ``Z`` on both
    sides, room for the 16-byte misalignment and the last chunk's
    rounding."""
    span = (TILE + 2 * Z + 14 + 7) // 8 * 8
    return SLOTS * span * 4


def _lib():
    lib = _build.load("fields")
    if lib.ws_fields_packed.argtypes is None:
        lib.ws_fields_packed.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I,
                                         _I, _I, _VP]
        lib.ws_fields_packed.restype = _I
        lib.ws_fields_parity.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                         _VP]
        lib.ws_fields_parity.restype = _I
    return lib


def _kernel_planes(state: LocalMapState, wrapper):
    """The value and weight planes of a CUDA ``state`` as the kernel takes
    them: checked (int16, contiguous, one shape, within the 32-bit voxel
    index and the shared-memory stage), the weight copied to the value's
    offset from a 16-byte boundary where it lies at another (counted in
    ``wrapper.staged_copies``)."""
    value, weight = state.value, state.weight
    if value.device.type != "cuda":
        raise ValueError(f"unsupported device {value.device}")
    if value.dtype != torch.int16 or weight.dtype != torch.int16:
        raise TypeError("value/weight must be int16")
    if weight.shape != value.shape or not (value.is_contiguous()
                                           and weight.is_contiguous()):
        raise ValueError("value/weight must be contiguous and of one shape")
    if value.data_ptr() % 16 != weight.data_ptr() % 16:
        weight = _aligned_like(weight, value)
        wrapper.staged_copies += 1
    X, Y, Z = value.shape
    if X * Y * Z > _build.MAX_VOXELS:
        raise ValueError("window exceeds the kernel's 32-bit voxel index")
    if smem_bytes(Z) > MAX_SMEM_BYTES:
        raise ValueError(f"z extent {Z} exceeds the kernel's shared-memory "
                         "stage")
    return value, weight


def fields_packed(state: LocalMapState, *, tau: int, exact: bool = False):
    """``PackedFields`` (or ``PackedFields2`` with ``exact=True``) of the
    window in ``state``; the planes are new int32 tensors."""
    if state.value.device.type == "cpu":
        return (precompute_fields_packed2(state) if exact
                else precompute_fields_packed(state, tau=tau))
    value, weight = _kernel_planes(state, fields_packed)
    vs, gs = packed_shifts(tau)
    a = torch.empty(value.shape, dtype=torch.int32, device=value.device)
    b = torch.empty_like(a) if exact else a
    rc = _lib().ws_fields_packed(
        value.data_ptr(), weight.data_ptr(), a.data_ptr(), b.data_ptr(),
        *value.shape, vs, gs, int(bool(exact)),
        torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(rc, "fields kernel K2")
    fields_packed.launches += 1
    return PackedFields2(plane_a=a, plane_b=b) if exact else PackedFields(
        plane=a)


fields_packed.launches = 0
fields_packed.staged_copies = 0


def fields_parity(state: LocalMapState) -> RegistrationFields:
    """The parity mode's ``RegistrationFields`` of the window in ``state``
    (K2's parity mode on the card, ``precompute_fields`` on the CPU, the
    same bits); the planes are new int32 tensors."""
    if state.value.device.type == "cpu":
        return precompute_fields(state)
    value, weight = _kernel_planes(state, fields_parity)
    vw, gxy, gz = (torch.empty(value.shape, dtype=torch.int32,
                               device=value.device) for _ in range(3))
    rc = _lib().ws_fields_parity(
        value.data_ptr(), weight.data_ptr(), vw.data_ptr(), gxy.data_ptr(),
        gz.data_ptr(), *value.shape,
        torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(rc, "fields kernel K2 (parity)")
    fields_parity.launches += 1
    return RegistrationFields(vw=vw, gxy=gxy, gz=gz)


fields_parity.launches = 0
fields_parity.staged_copies = 0


def _aligned_like(weight: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """A copy of ``weight`` that starts at ``value``'s offset from a
    16-byte boundary: the kernel stages both planes by the same 16-byte
    copies, so a window whose planes were cut at different offsets (a view
    into a larger buffer) runs on this copy."""
    n = weight.numel()
    buf = torch.empty(n + 8, dtype=weight.dtype, device=weight.device)
    shift = (value.data_ptr() - buf.data_ptr()) % 16 // 2
    out = buf[shift:shift + n].view(weight.shape)
    out.copy_(weight)
    return out


class FieldsPlan(NamedTuple):
    """What ``plan_neighbors`` found: ``index`` (N,) the flat voxel each
    output write goes to, in the kernel's order; ``neighbors`` (N, 6) the
    flat voxels it reads as x+1, x-1, y+1, y-1, z+1, z-1 (-1 for a read of
    shared memory outside the staged range); ``planes`` every plane the
    blocks compute, in walk order (all planes, whatever ``planes`` asked)."""
    index: torch.Tensor
    neighbors: torch.Tensor
    planes: list


def plan_neighbors(shape, planes=None) -> FieldsPlan:
    """Plain model of K2's addressing: walks ``csrc/fields.cu``'s plan and
    returns, for every voxel it writes in the planes listed in ``planes``
    (all by default), the flat indices of the six neighbours it reads.

    The walk is the kernel's: tiles of ``TILE`` plane positions, runs of
    ``RUN`` planes, the ring of ``SLOTS`` slots (slice j+2 on its way while
    slice j is computed, into the slot slice j-2 left), the staged range
    ``[t0 - Z, t0 + TILE + Z)`` clipped to the plane, thread positions
    ``t0 + tid + k * THREADS`` with z from one modulo per thread and then a
    counter, the z wrap inside a row, the y wrap to global memory for rows
    0 and Y-1, and x from the slots."""
    X, Y, Z = (int(s) for s in shape)
    P = Y * Z
    tiles = -(-P // TILE)
    runs = -(-X // RUN)
    wanted = set(range(X)) if planes is None else set(planes)
    t0 = torch.arange(tiles, dtype=torch.int64)[:, None] * TILE
    tid = torch.arange(THREADS, dtype=torch.int64)[None, :]
    lo = torch.clamp(t0 - Z, min=0)
    hi = torch.clamp(t0 + TILE + Z, max=P)
    zstart = (t0 + tid) % Z
    zstep = THREADS % Z
    index, neighbors, walked = [], [], []

    for run in range(runs):
        x0, x1 = run * RUN, min(run * RUN + RUN, X)

        def plane(j):
            x = x0 + j
            return X - 1 if x == 0 else (x - 1 if x - 1 < X else x - 1 - X)

        nslices = x1 - x0 + 2
        slots = [None] * SLOTS               # the plane each slot holds
        for j in range(SLOTS - 1):
            slots[j % SLOTS] = plane(j)
        for j in range(1, nslices - 1):
            x = plane(j)
            walked.append(x)
            if j + 2 < nslices:          # on its way while j is computed
                slots[(j + 2) % SLOTS] = plane(j + 2)
            cur, prev, nxt = (slots[j % SLOTS], slots[(j - 1) % SLOTS],
                              slots[(j + 1) % SLOTS])
            if x not in wanted:
                continue

            def staged(p, q):
                ok = (q >= lo) & (q < hi)
                return torch.where(ok, p * P + q, torch.full_like(q, -1))

            z = zstart.clone()
            for k in range(TILE // THREADS):
                q = t0 + tid + k * THREADS
                live = q < P
                yn = torch.where(q + Z < P, staged(cur, q + Z),
                                 x * P + q + Z - P)
                yp = torch.where(q >= Z, staged(cur, q - Z),
                                 x * P + q + P - Z)
                zn = torch.where(z == Z - 1, q - (Z - 1), q + 1)
                zp = torch.where(z == 0, q + (Z - 1), q - 1)
                nb = torch.stack([staged(nxt, q), staged(prev, q), yn, yp,
                                  staged(cur, zn), staged(cur, zp)], dim=-1)
                index.append((x * P + q)[live])
                neighbors.append(nb[live])
                z = z + zstep
                z = torch.where(z >= Z, z - Z, z)
    if not index:
        return FieldsPlan(torch.zeros(0, dtype=torch.int64),
                          torch.zeros(0, 6, dtype=torch.int64), walked)
    return FieldsPlan(torch.cat(index), torch.cat(neighbors), walked)
