"""Ray-march TSDF fusion on tensors.

Counterpart of ``warpsense_tpu/ops/tsdf.py`` (re-design of the CUDA pair
``cu_min_tsdf_krnl`` + ``cu_avg_tsdf_krnl``, update_tsdf.cu:13-128): every
ray marches from the scanner to its point + tau in half-voxel steps; each
visited cell, and its vertical interpolation copies, emits one int32 ORDER
KEY whose minimum implements the deterministic combine lattice (a real
sample beats an interpolated one, then the smaller |value| wins); a
scatter-min collects the keys and a weighted-average merge folds them into
the map.

Semantics are the JAX function's, bit for bit against op-by-op JAX: every
float32 expression keeps the JAX evaluation order (``core.geometry.cross``
is ``jnp.cross``; sums of squares add x, y, then z) and sqrt is correctly
rounded (``tsdf_projective._sqrt``).  Jitted JAX on the CPU contracts some
multiply-adds into FMAs and differs in a few voxels (tests bound it).

What differs from the JAX loop, none of it visible in the result (min is
commutative and associative, and a key that can never be emitted changes
nothing):

* the ``fori_loop`` over ``max_steps`` runs in chunks of steps, one
  scatter-min each (``scatter_reduce_("amin")`` into a key map one slot
  longer, the last slot taking the dropped entries);
* points that can never emit (masked, at the scanner, outside the window
  grown by tau/2, or without an interpolation direction) are dropped
  first, and the march stops after the last step any ray still reaches;
* interpolation copies past a step's ``iter_steps`` (a per-step scalar)
  are not generated;
* the merge touches only the voxels that received a key (an untouched
  voxel merges to itself).

The map is updated IN PLACE (the JAX function donates the state).  Plain
PyTorch: the reference has no TPU kernel here.
"""
from __future__ import annotations

import torch

from ..core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from ..core.geometry import cross, div_trunc
from ..map.local_map import LocalMapState, in_bounds, ring_index
from .tsdf_projective import _merge_planes, _sqrt, dz_per_distance

# key = neg_flag<<23 | |value|<<8 | sign(value)<<7 | |weight|;
# lexicographic min == combine lattice; SENTINEL means "never written".
_SENTINEL = 2 ** 30

# (steps x points x interpolation copies) entries per scatter-min
_CHUNK_ENTRIES = 1 << 22


def encode_key(value: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    neg = (weight <= 0).to(torch.int32)
    sign = (value < 0).to(torch.int32)
    return (neg << 23) | (torch.abs(value) << 8) | (sign << 7) \
        | torch.abs(weight)


def decode_key(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    untouched = key >= _SENTINEL
    absv = (key >> 8) & 0x7FFF
    absw = key & 0x7F
    value = torch.where(((key >> 7) & 1) == 1, -absv, absv)
    weight = torch.where(((key >> 23) & 1) == 1, -absw, absw)
    zero = torch.zeros_like(key)
    return (torch.where(untouched, zero, value).to(torch.int32),
            torch.where(untouched, zero, weight).to(torch.int32))


def plan_raymarch(tau: int, resolution: int, max_range_mm: int,
                  channels: int = 128, vfov_deg: float = 45.0
                  ) -> tuple[int, int]:
    """Static loop bounds (max_steps, max_isteps) for a range budget."""
    step = max(resolution // 2, 1)
    max_steps = (max_range_mm + tau) // step + 1
    dzpd = dz_per_distance(channels, vfov_deg)
    dz_max = dzpd * (max_range_mm + tau) // MATRIX_RESOLUTION
    max_isteps = 2 * dz_max // resolution + 1
    return max_steps, max_isteps


def _floor_sqrt(s: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(s)) of a float32 tensor with the JAX function's +-1
    fixup against the float32 squares."""
    k = torch.floor(_sqrt(s)).to(torch.int32)
    kf = k.to(torch.float32)
    k = torch.where((kf + 1.0) * (kf + 1.0) <= s, k + 1, k)
    kf = k.to(torch.float32)
    return torch.where(kf * kf > s, k - 1, k)


def _sum_sq(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last (size-3) axis in XLA's order."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) \
        + v[..., 2] * v[..., 2]


def _floor_norm(v: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(sum v^2)) like the reference's int l2norm."""
    return _floor_sqrt(_sum_sq(v.to(torch.float32)))


def tsdf_update(state: LocalMapState, points: torch.Tensor,
                points_mask: torch.Tensor, scanner_pos: torch.Tensor,
                up: torch.Tensor, *, size: tuple[int, int, int], tau: int,
                max_weight: int, resolution: int, max_steps: int,
                max_isteps: int, pos_mode: str = "center",
                channels: int = 128, vfov_deg: float = 45.0,
                x_rows: tuple[int, int] | None = None) -> LocalMapState:
    """One ray-march fusion step, IN PLACE on ``state.value`` /
    ``state.weight``; returns ``state``.  ``x_rows=(lo, hi)``: the state
    holds only the window's array x-rows [lo, hi) (one rank's slab of the
    multi-GPU layer); every rank marches every ray, and only the cells of
    its own rows enter its scatter-min.

    points: (N, 3) int32 mm (map frame); points_mask: (N,) bool;
    scanner_pos: (3,) int32 voxel coords; up: (3,) int32 MR-scaled
    map-frame sensor up vector.  ``pos_mode``: rays start at the scanner
    voxel's "center" (the reference's GPU flavour) or its "corner" (its
    CPU flavour, cpu/update_tsdf.cpp:410), as the JAX function takes it;
    any other value raises."""
    if pos_mode not in ("center", "corner"):
        raise ValueError(f"unknown pos_mode {pos_mode!r}")
    lo, hi = (0, size[0]) if x_rows is None else x_rows
    if tuple(state.value.shape) != (hi - lo, *size[1:]):
        raise ValueError(f"state shape {tuple(state.value.shape)} != "
                         f"rows [{lo}, {hi}) of size {tuple(size)}")
    if not (state.value.is_contiguous() and state.weight.is_contiguous()):
        raise ValueError("value/weight must be contiguous")
    dev = state.value.device
    f32, i32 = torch.float32, torch.int32
    nvox = (hi - lo) * size[1] * size[2]     # voxels of the rows held
    base = lo * size[1] * size[2]
    dzpd = dz_per_distance(channels, vfov_deg)
    weight_epsilon = tau // 10
    step_mm = max(resolution // 2, 1)
    MR = MATRIX_RESOLUTION

    scanner_pos = scanner_pos.to(device=dev, dtype=i32)
    pos_mm = scanner_pos * resolution
    if pos_mode == "center":
        pos_mm = pos_mm + resolution // 2
    points = points.to(device=dev, dtype=i32)
    direction = points - pos_mm
    distance = _floor_norm(direction)
    cell = torch.div(points, resolution, rounding_mode="floor")
    point_ok = (points_mask.to(dev) & (distance > 0)
                & in_bounds(cell, state.pos, size, -(tau // resolution // 2)))

    dir_f = direction.to(f32)
    dist_f = torch.clamp(distance, min=1).to(f32)[:, None]
    normed = torch.trunc(dir_f / dist_f * MR)
    inner = torch.trunc(cross(normed, up.to(device=dev, dtype=f32)) / MR)
    interp = cross(normed, inner)
    interp_norm = _floor_sqrt(_sum_sq(interp)).to(f32)
    point_ok = point_ok & (interp_norm > 0)
    interp = torch.trunc(interp * MR / torch.clamp(interp_norm, min=1.0)
                         [:, None]).to(i32)

    # only rays that can emit take part (one host sync)
    keep = torch.nonzero(point_ok).squeeze(1)
    n = int(keep.numel())
    if n == 0:
        return state
    points, distance, interp = points[keep], distance[keep], interp[keep]
    dir_f, dist_f = dir_f[keep], dist_f[keep]
    # a step emits only while length = 1 + k*step <= distance + tau
    reach = (int(distance.max()) + tau - 1) // step_mm + 1
    n_steps = min(int(max_steps), reach)

    key_map = torch.full((nvox + 1,), _SENTINEL, dtype=i32, device=dev)

    def index_at(ks):
        length = (1 + ks * step_mm).to(i32)
        ratio = length.to(f32)[:, None] / dist_f[None, :, 0]
        proj = pos_mm + torch.trunc(dir_f[None] * ratio[..., None]).to(i32)
        return proj, torch.div(proj, resolution, rounding_mode="floor")

    def iter_steps(k):
        dz = dzpd * (1 + k * step_mm) // MR
        return 2 * dz // resolution + 1, dz

    k0 = 0
    while k0 < n_steps:
        isteps = min(int(max_isteps), iter_steps(n_steps - 1)[0])
        k1 = min(n_steps, k0 + max(1, _CHUNK_ENTRIES // (n * isteps)))
        ks = torch.arange(max(k0 - 1, 0), k1, dtype=i32, device=dev)
        proj, index = index_at(ks)
        if k0 > 0:                     # first row: the step before k0
            proj, prev, index = proj[1:], index[:-1], index[1:]
            ks = ks[1:]
        else:
            prev = torch.cat([index[:1], index[:-1]])
        length = (1 + ks * step_mm).to(i32)[:, None]            # (K, 1)
        dup = ((index[..., 0] == prev[..., 0])
               & (index[..., 1] == prev[..., 1]) & (ks > 0)[:, None])
        base_ok = ((length <= distance + tau) & ~dup
                   & in_bounds(index, state.pos, size))
        center = index * resolution + resolution // 2
        value = torch.clamp(_floor_norm(points - center), max=tau)
        value = torch.where(length > distance, -value, value)
        weight = torch.where(
            value < -weight_epsilon,
            torch.div(WEIGHT_RESOLUTION * (tau + value),
                      tau - weight_epsilon, rounding_mode="floor"),
            torch.full_like(value, WEIGHT_RESOLUTION))
        base_ok = base_ok & (weight != 0)

        steps = [iter_steps(k) for k in range(k0, k1)]
        n_iter = torch.tensor([s for s, _ in steps], dtype=i32, device=dev)
        dz = torch.tensor([d for _, d in steps], dtype=i32, device=dev)
        mid = (dz // resolution)[:, None]
        lowest = proj - div_trunc(dz[:, None, None] * interp, MR)
        flats, keys = [], []
        for s in range(min(int(max_isteps), max(st for st, _ in steps))):
            raw = lowest + div_trunc(s * resolution * interp, MR)
            widx = torch.div(raw, resolution, rounding_mode="floor")
            ok = (base_ok & (s < n_iter)[:, None]
                  & in_bounds(widx, state.pos, size))
            w = torch.where(mid == s, weight, -weight)
            flat = ring_index(widx, state.pos, state.offset, size)
            if x_rows is not None:
                flat = flat - base
                ok = ok & (flat >= 0) & (flat < nvox)
            flats.append(torch.where(ok, flat, nvox))
            keys.append(encode_key(value, w))
        key_map.scatter_reduce_(0, torch.cat(flats).reshape(-1).to(
            torch.int64), torch.cat(keys).reshape(-1), "amin")
        k0 = k1

    # merge: only voxels that received a key change
    hit = torch.nonzero(key_map[:nvox] < _SENTINEL).squeeze(1)
    new_v, new_w = decode_key(key_map[hit])
    flat_v, flat_w = state.value.view(-1), state.weight.view(-1)
    out_v, out_w = _merge_planes(flat_v[hit].to(i32), flat_w[hit].to(i32),
                                 new_v, new_w, max_weight)
    flat_v[hit] = out_v.to(torch.int16)
    flat_w[hit] = out_w.to(torch.int16)
    return state
