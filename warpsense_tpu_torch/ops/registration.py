"""Point-to-TSDF registration on tensors: parity mode (three-plane fields +
Gauss-Newton) and fast mode (packed fields + LM).

Counterpart of ``warpsense_tpu/ops/registration.py`` (re-design of
registration.cu:14-257 and tsdf_registration.cpp:28-105):

* parity mode (``precompute_fields`` + ``register_cloud_fields``): the
  reference's scheme — value/weight and the sign-change-rejecting
  central-difference gradient in three int32 planes, the un-normalized
  voxel gradient, the rotation centered on the initial translation and the
  linear Levenberg ramp; plain PyTorch (no TPU kernel in the reference
  either);
* fast mode: the map's value and per-axis gradient are precomputed once per map change
  into one int32 plane (byte layout v:8|gx:8|gy:8|gz:8, ``PackedFields``)
  or two exact planes (``PackedFields2``); CUDA kernel K2
  (``kernels/fields.py``) computes them on the card, the roll formulation
  here is its plain version;
* each LM iteration is one gather from that plane plus J^T J, J^T r on the
  device;
* the JAX ``lax.while_loop`` becomes a host loop: each iteration brings H,
  g, e and c to the host once (one sync, at most ``max_iterations``),
  where the 6x6 solve and the accept/reject logic run in float32 on the
  CPU with the same control flow, coarse phase and gather freeze included.

Numerics: the statistics are float32 sums whose order differs from XLA's,
and the 6x6 solve is LAPACK's rather than XLA's, so poses agree with the JAX
package within a tolerance (tests state it), not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.consts import MATRIX_RESOLUTION
from ..core.geometry import (cross, div_trunc, transform_point_fixed,
                             xi_to_transform)
from ..map.local_map import LocalMapState, in_bounds, ring_coords

# Parity-mode column scaling: cross terms ~ p[mm] * grad[mm] ~ 2e4 * 1e3;
# grad ~ 1e3.  D = diag([_SC]*3, [_SG]*3) keeps the float32 H and g O(1).
_SC = 1.0 / (1 << 24)
_SG = 1.0 / (1 << 10)


class RegistrationFields(NamedTuple):
    """Parity-mode fields (int32 planes, (X, Y, Z)):
    vw = weight<<16 | value;  gxy = gy<<16 | gx;  gz = gz (low half)."""
    vw: torch.Tensor
    gxy: torch.Tensor
    gz: torch.Tensor


def precompute_fields(state: LocalMapState) -> RegistrationFields:
    """Dense value/weight/gradient planes from the map window, bit-exact
    with the JAX function: per axis the C-trunc central difference where
    both ring neighbours have weight and the value does not change sign
    across the cell (registration.cu:225-246 hoisted to per voxel), else
    0.  One axis at a time, so the peak scratch is four rolled planes."""
    v = state.value.to(torch.int32)
    w = state.weight.to(torch.int32)
    grads = []
    for ax in range(3):
        nv, pv = torch.roll(v, -1, ax), torch.roll(v, 1, ax)
        ok = (torch.roll(w, -1, ax) != 0) & (torch.roll(w, 1, ax) != 0)
        sign_change = ((nv > 0) & (pv < 0)) | ((nv < 0) & (pv > 0))
        grads.append(torch.where(ok & ~sign_change, div_trunc(nv - pv, 2),
                                 torch.zeros_like(nv)))
        del nv, pv, ok, sign_change
    return RegistrationFields(vw=_pack16(v, w),
                              gxy=_pack16(grads[0], grads[1]),
                              gz=_pack16(grads[2], torch.zeros_like(v)))


def jacobian_stats_fields(fields: RegistrationFields, pos, offset, points,
                          mask, total_transform, *, size, resolution: int,
                          normalize_gradient: bool = False, index_fn=None):
    """One iteration's scaled normal-equation statistics from the parity
    fields: (Hs 6x6, gs 6, e, c) with Hs = D H D and gs = D g for
    D = diag([_SC]*3, [_SG]*3), all float32 on the device of ``points``.
    points: (N, 3) int32 mm; mask: (N,) bool; total_transform: 4x4.
    ``index_fn``: as in ``make_packed_stats``."""
    total = total_transform.to(torch.float32)
    int_mat = torch.trunc(total * MATRIX_RESOLUTION).to(torch.int32)
    center = total[:3, 3].to(torch.int32)          # C cast truncation
    pts = transform_point_fixed(points, int_mat)
    buf = torch.div(pts, resolution, rounding_mode="floor")
    p = (pts - center).to(torch.float32)
    valid = mask & in_bounds(buf, pos, size, 1)
    if index_fn is None:
        a = ring_coords(buf, pos, offset, size)
    else:
        a, owned = index_fn(buf)
        valid = valid & owned
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    vw = fields.vw[a0, a1, a2]
    valid = valid & (_unpack_hi(vw) != 0)
    gxy = fields.gxy[a0, a1, a2]
    gz = fields.gz[a0, a1, a2]
    grad = torch.stack([_unpack_lo(gxy), _unpack_hi(gxy), _unpack_lo(gz)],
                       dim=-1).to(torch.float32)
    if normalize_gradient:
        grad = grad / float(resolution)
    Js = torch.cat([cross(p, grad) * _SC, grad * _SG], dim=-1)
    vf = valid.to(torch.float32)
    Js = Js * vf[:, None]
    v = _unpack_lo(vw).to(torch.float32) * vf
    return Js.T @ Js, Js.T @ v, torch.sum(torch.abs(v)), torch.sum(vf)


def register_cloud(state: LocalMapState, points, mask, pretransform, *,
                   size, resolution: int, max_iterations: int,
                   it_weight_gradient: float, epsilon: float,
                   mode: str = "parity") -> torch.Tensor:
    """Full GN registration against a map state; the refined 4x4 pose
    (float32, on the device of ``pretransform``).  ``mode`` as in
    ``register_cloud_fields``."""
    return register_cloud_fields(
        precompute_fields(state), state.pos, state.offset, points, mask,
        pretransform, size=size, resolution=resolution,
        max_iterations=max_iterations, it_weight_gradient=it_weight_gradient,
        epsilon=epsilon, mode=mode)


def register_cloud_fields(fields: RegistrationFields, pos, offset, points,
                          mask, pretransform, *, size, resolution: int,
                          max_iterations: int, it_weight_gradient: float,
                          epsilon: float, mode: str = "parity",
                          return_iterations: bool = False):
    """GN registration against cached ``precompute_fields`` output.

    ``mode="parity"``: the reference's scheme — un-normalized voxel
    gradient and the rotation centered on the INITIAL translation;
    ``"fast"``: resolution-normalized gradient and per-iteration
    recentering.  Both are the JAX function's semantics.  Returns the pose
    (4x4 float32 on ``pretransform``'s device); with ``return_iterations``,
    ``(pose, iterations)``, the count of statistics evaluations."""
    def stats(total):
        return jacobian_stats_fields(
            fields, pos, offset, points, mask, total, size=size,
            resolution=resolution, normalize_gradient=mode == "fast")

    pose, iterations = _gn_loop(
        stats, pretransform, max_iterations=max_iterations,
        it_weight_gradient=it_weight_gradient, epsilon=epsilon, mode=mode)
    return (pose, iterations) if return_iterations else pose


def _gn_loop(stats, pretransform, *, max_iterations, it_weight_gradient,
             epsilon, mode):
    """The JAX ``lax.while_loop`` as a host loop over a ``stats(total) ->
    (H, g, e, c)`` closure: statistics on the device, one device->host
    copy of them per iteration, the damped 6x6 solve and the pose update
    in float32 on the CPU.  Keeps the reference's 4-error convergence
    window (tsdf_registration.cpp:81-93) and skips the step, without
    stopping, when the solve is not finite (a singular H before the
    damping has grown); an empty system stops the loop."""
    fast = mode == "fast"
    device = pretransform.device
    f32 = torch.float32
    D = torch.tensor([_SC] * 3 + [_SG] * 3, dtype=f32)
    eye6 = torch.eye(6, dtype=f32)
    total = pretransform.detach().to(device="cpu", dtype=f32)
    center = total[:3, 3].to(torch.int32)
    alpha = torch.tensor(0.0, dtype=f32)
    itw = torch.tensor(it_weight_gradient, dtype=f32)
    eps = torch.tensor(epsilon, dtype=f32)
    prev = torch.zeros(4, dtype=f32)
    iterations = 0
    for _ in range(max_iterations):
        iterations += 1
        H, g, e, c = _host_stats(*stats(total.to(device)))
        empty = bool(c <= 0.0)
        A = eye6 if empty else H + alpha * c * torch.diag(D * D)
        y = _solve6(A, -g)
        ok = not empty and bool(torch.all(torch.isfinite(y)))
        xi = D * y if ok else torch.zeros(6, dtype=f32)
        ctr = total[:3, 3].to(torch.int32) if fast else center
        if ok:
            total = xi_to_transform(xi, ctr) @ total
        err = e / torch.clamp(c, min=1.0)
        finished = (ok and bool(torch.abs(err - prev[2]) < eps)
                    and bool(torch.abs(err - prev[0]) < eps)) or empty
        prev = torch.cat([prev[1:], err.reshape(1)])
        alpha = alpha + itw
        if finished:
            break
    return total.to(device), iterations


class PackedFields(NamedTuple):
    """Single-plane packed fields (int32 (X, Y, Z)), byte layout (MSB..LSB)
    v:8 | gx:8 | gy:8 | gz:8; v byte 0 = invalid (weight 0)."""
    plane: torch.Tensor


class PackedFields2(NamedTuple):
    """Two-plane exact fields: a = v:16|gx:16, b = gy:16|gz:16; invalid
    (weight 0) is the sentinel v = -32768."""
    plane_a: torch.Tensor
    plane_b: torch.Tensor


def _pack16(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return ((hi.to(torch.int32) & 0xFFFF) << 16) | (lo.to(torch.int32)
                                                    & 0xFFFF)


def _unpack_lo(x: torch.Tensor) -> torch.Tensor:
    """Sign-extended low half (the JAX ``(x << 16) >> 16``)."""
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def _unpack_hi(x: torch.Tensor) -> torch.Tensor:
    return x >> 16


def _pack_shift(tau: int, limit: int) -> int:
    s = 0
    while (tau >> s) > limit:
        s += 1
    return s


def packed_shifts(tau: int) -> tuple[int, int]:
    """(vshift, gshift): minimal power-of-two quantization for tau."""
    return _pack_shift(tau, 126), _pack_shift(tau, 126)


def _rshift_round(x, s):
    # round-to-nearest quantization (plain >> floors: a -2^(s-1) bias)
    return (x + (1 << s >> 1)) >> s if s else x


def packed_plane_from_neighbors(v, w, neighbors, *, tau: int) -> torch.Tensor:
    """Pack (value, per-axis central-difference gradient) into the one-plane
    byte layout from int32 ``v``/``w`` and per-axis neighbour tuples
    ``[(nv, pv, nw, pw)] * 3``.  Weight-validity masking only, no
    sign-change rejection (the crossing cells carry the most informative
    gradient)."""
    vs, gs = packed_shifts(tau)
    codes = []
    for nv, pv, nw, pw in neighbors:
        ok = (nw != 0) & (pw != 0)
        g = torch.where(ok, div_trunc(nv - pv, 2), torch.zeros_like(nv))
        codes.append(torch.clamp(_rshift_round(g, gs) + 128, 1, 255))
    vcode = torch.where(w != 0, torch.clamp(_rshift_round(v, vs) + 128, 1, 255),
                        torch.zeros_like(v))
    return (vcode << 24) | (codes[0] << 16) | (codes[1] << 8) | codes[2]


def _roll_neighbors(v, w):
    return [(torch.roll(v, -1, ax), torch.roll(v, 1, ax),
             torch.roll(w, -1, ax), torch.roll(w, 1, ax)) for ax in range(3)]


def precompute_fields_packed(state: LocalMapState, *,
                             tau: int) -> PackedFields:
    """One-plane packed fields, roll formulation (plain version of K2)."""
    v = state.value.to(torch.int32)
    w = state.weight.to(torch.int32)
    return PackedFields(plane=packed_plane_from_neighbors(
        v, w, _roll_neighbors(v, w), tau=tau))


def precompute_fields_packed2(state: LocalMapState) -> PackedFields2:
    """Exact two-plane packing, roll formulation (plain version of K2)."""
    v = state.value.to(torch.int32)
    w = state.weight.to(torch.int32)
    grads = [torch.where((nw != 0) & (pw != 0), div_trunc(nv - pv, 2),
                         torch.zeros_like(nv))
             for nv, pv, nw, pw in _roll_neighbors(v, w)]
    vsent = torch.where(w != 0, v, torch.full_like(v, -32768))
    return PackedFields2(plane_a=_pack16(vsent, grads[0]),
                         plane_b=_pack16(grads[1], grads[2]))


def precompute_fields_packed_auto(state: LocalMapState, *, tau: int,
                                  exact: bool = False):
    """Kernel K2 for a CUDA state, its plain version for a CPU state."""
    from ..kernels.fields import fields_packed
    return fields_packed(state, tau=tau, exact=exact)


def _decode_packed(code: torch.Tensor, vs: int, gs: int):
    vcode = (code >> 24) & 0xFF
    valid = vcode != 0
    v = (vcode - 128) << vs
    gx = (((code >> 16) & 0xFF) - 128) << gs
    gy = (((code >> 8) & 0xFF) - 128) << gs
    gz = ((code & 0xFF) - 128) << gs
    return valid, v, torch.stack([gx, gy, gz], dim=-1)


_SCP = 1.0 / (1 << 15)   # cross columns ~ p[mm] * unit-grad


def register_cloud_packed(fields, pos, offset, points, mask, pretransform, *,
                          size: tuple[int, int, int], resolution: int,
                          tau: int, max_iterations: int,
                          it_weight_gradient: float, epsilon: float,
                          interp: bool = True, coarse_iterations: int = 0,
                          gather_freeze: bool = False):
    """Fast-mode LM registration against packed fields.

    Returns ``(pose 4x4 float32 on pretransform's device, iterations int,
    final_err float)``.
    Solver, convergence and ``gather_freeze`` are those of the JAX function
    (adaptive Levenberg-Marquardt with Marquardt scaling; stop on a step
    below the residual noise floor or on the 4-round error window)."""
    kw = dict(size=size, resolution=resolution, tau=tau, interp=interp)
    stats = make_packed_stats(fields, pos, offset, points, mask, **kw)
    stats_coarse = None
    if coarse_iterations > 0:
        # 1-in-4 deterministic subsample for the early iterations
        stats_coarse = make_packed_stats(fields, pos, offset, points[::4],
                                         mask[::4], **kw)
    split = (make_packed_stats_split(fields, pos, offset, points, mask, **kw)
             if gather_freeze else None)
    del it_weight_gradient   # parity-mode ramp; LM adapts alpha itself
    return _lm_loop(stats, pretransform, max_iterations=max_iterations,
                    epsilon=epsilon, stats_coarse=stats_coarse,
                    coarse_iterations=coarse_iterations, split=split,
                    freeze_step_mm=float(resolution))


def _gather_decode(fields, vs, gs, a):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    if isinstance(fields, PackedFields2):
        pa = fields.plane_a[a0, a1, a2]
        pb = fields.plane_b[a0, a1, a2]
        v = _unpack_lo(pa)
        grad = torch.stack([_unpack_hi(pa), _unpack_lo(pb), _unpack_hi(pb)],
                           dim=-1)
        return v != -32768, v, grad
    return _decode_packed(fields.plane[a0, a1, a2], vs, gs)


def _cells(points, mask, pos, offset, total, size, resolution,
           index_fn=None):
    """(pts, buf, valid, array coords) of the cloud under ``total``."""
    int_mat = torch.trunc(total * MATRIX_RESOLUTION).to(torch.int32)
    pts = transform_point_fixed(points, int_mat)
    buf = torch.div(pts, resolution, rounding_mode="floor")
    valid = mask & in_bounds(buf, pos, size, 1)
    if index_fn is None:
        a = ring_coords(buf, pos, offset, size)
    else:
        a, owned = index_fn(buf)
        valid = valid & owned
    a = torch.where(valid[:, None], a, torch.zeros_like(a))
    return pts, buf, valid, a


def _normal_equations(pts, total, gradf, vf32, valid):
    ctr = total[:3, 3]
    p = pts.to(torch.float32) - ctr
    cross = torch.linalg.cross(p, gradf, dim=-1)
    vfm = valid.to(torch.float32)
    Js = torch.cat([cross * _SCP, gradf], dim=-1) * vfm[:, None]
    r = vf32 * vfm
    return Js.T @ Js, Js.T @ r, torch.sum(torch.abs(r)), torch.sum(vfm)


def make_packed_stats(fields, pos, offset, points, mask, *, size, resolution,
                      tau, interp, index_fn=None):
    """``stats(total) -> (H, g, e, c)`` over packed fields; ``total`` is a
    4x4 float32 tensor on the device of ``points``.  ``index_fn(buf) ->
    (coords (N, 3), owned (N,))``: optional override of the plane indexing
    (the sharded path maps cells to rank-local array coords, in range for
    every point, and gates by ownership); the default is the full window's
    ring coords with every in-bounds cell owned."""
    vs, gs = packed_shifts(tau)

    def stats(total):
        pts, buf, valid, a = _cells(points, mask, pos, offset, total, size,
                                    resolution, index_fn)
        ok, v, grad = _gather_decode(fields, vs, gs, a)
        valid = valid & ok
        gradf = grad.to(torch.float32) / float(resolution)   # mm per mm
        vf32 = v.to(torch.float32)
        if interp:
            # continuous residual: value + gradient x within-cell offset
            cc = buf * resolution + resolution // 2
            dpos = (pts - cc).to(torch.float32)
            vf32 = vf32 + torch.sum(gradf * dpos, dim=-1)
        return _normal_equations(pts, total, gradf, vf32, valid)

    return stats


def make_packed_stats_split(fields, pos, offset, points, mask, *, size,
                            resolution, tau, interp, index_fn=None):
    """(gather_fn, eval_fn) split of ``make_packed_stats``:
    ``eval_fn(gather_fn(T), T)`` equals ``make_packed_stats(...)(T)``; the
    cache lets the LM tail iterate without re-gathering."""
    vs, gs = packed_shifts(tau)

    def gather_fn(total):
        pts, buf, valid, a = _cells(points, mask, pos, offset, total, size,
                                    resolution, index_fn)
        ok, v, grad = _gather_decode(fields, vs, gs, a)
        return dict(valid=valid & ok, v=v.to(torch.float32),
                    gradf=grad.to(torch.float32) / float(resolution),
                    cc=buf * resolution + resolution // 2)

    def eval_fn(cache, total):
        int_mat = torch.trunc(total * MATRIX_RESOLUTION).to(torch.int32)
        pts = transform_point_fixed(points, int_mat)
        vf32 = cache["v"]
        gradf = cache["gradf"]
        if interp:
            dpos = (pts - cache["cc"]).to(torch.float32)
            vf32 = vf32 + torch.sum(gradf * dpos, dim=-1)
        return _normal_equations(pts, total, gradf, vf32, cache["valid"])

    return gather_fn, eval_fn


def _host_stats(H, g, e, c):
    """One device->host copy of the 44 statistics (the loop's one sync)."""
    flat = torch.cat([H.reshape(-1), g.reshape(-1), e.reshape(1),
                      c.reshape(1)]).to(device="cpu", dtype=torch.float32)
    return flat[:36].reshape(6, 6), flat[36:42], flat[42], flat[43]


def _solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """6x6 float32 solve; a singular system yields NaN (like an LU that
    divides by a zero pivot) instead of raising."""
    y, info = torch.linalg.solve_ex(A, b)
    if int(info) != 0:
        return torch.full_like(b, float("nan"))
    return y


def _lm_loop(stats, pretransform, *, max_iterations, epsilon,
             stats_coarse=None, coarse_iterations: int = 0, split=None,
             freeze_step_mm: float = 0.0):
    """Adaptive-LM driver over a ``stats(total)`` closure: the JAX
    ``lax.while_loop`` as a host loop with exactly its control flow.

    ``stats_coarse``: cheaper closure for the first ``coarse_iterations``;
    ``split``: ``(gather_fn, eval_fn)`` enabling the gather freeze once an
    accepted step is below ``freeze_step_mm``."""
    device = pretransform.device
    f32 = torch.float32
    D = torch.tensor([_SCP] * 3 + [1.0] * 3, dtype=f32)
    eye6 = torch.eye(6, dtype=f32)

    def c32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=f32)

    p0 = pretransform.detach().to(device="cpu", dtype=f32)
    acc, accH, accg = p0, eye6, torch.zeros(6, dtype=f32)
    acc_err = torch.tensor(float("inf"), dtype=f32)
    alpha = torch.tensor(1e-3, dtype=f32)
    trial = p0
    prev = torch.full((4,), float("inf"), dtype=f32)
    if split is not None:
        gather_fn, eval_fn = split
        cache = gather_fn(p0.to(device))
        frozen = False

    i = 0
    while i < max_iterations:
        trial_dev = trial.to(device)
        coarse_now = stats_coarse is not None and i < coarse_iterations
        if split is None:
            dev_stats = (stats_coarse if coarse_now else stats)(trial_dev)
        else:
            # the initial cache was built at p0; with a coarse phase it is
            # stale by hand-off, so the first fine iteration re-gathers
            reuse = frozen or (i == 0 and coarse_iterations == 0)
            if not (reuse or coarse_now):
                cache = gather_fn(trial_dev)
            dev_stats = (stats_coarse(trial_dev) if coarse_now
                         else eval_fn(cache, trial_dev))
        H, g, e, c = _host_stats(*dev_stats)
        err = (e / torch.clamp(c, min=1.0) if c > 0.0
               else torch.tensor(float("inf"), dtype=f32))

        # the coarse->fine hand-off re-baselines the accepted state
        improved = bool(err <= acc_err)
        if stats_coarse is not None and i == coarse_iterations:
            improved = True
            err2 = err
        else:
            err2 = torch.minimum(err, acc_err)
        if improved:
            acc, accH, accg = trial, H, g
        alpha = torch.clamp(alpha / 3.0 if improved else alpha * 4.0,
                            1e-5, 1e5)

        dH = torch.diag(torch.diag(accH)) + 1e-12 * eye6
        y = _solve6(accH + alpha * dH, -accg)
        ok = bool(torch.isfinite(err2)) and bool(torch.all(torch.isfinite(y)))
        xi = D * y if ok else torch.zeros(6, dtype=f32)
        trial = xi_to_transform(xi, acc[:3, 3].to(torch.int32)) @ acc

        # thresholds compare in float32, as JAX compares a weak Python
        # float against a float32 value
        rot2 = torch.sum(xi[:3] * xi[:3])
        tr2 = torch.sum(xi[3:] * xi[3:])
        tiny = improved and bool(rot2 < c32(1e-7)) and bool(tr2 < c32(0.25))
        eps = c32(epsilon)
        window = bool((torch.abs(err2 - prev[2]) < eps)
                      & (torch.abs(err2 - prev[0]) < eps))
        finished = tiny or window or not ok
        prev = torch.cat([prev[1:], err2.reshape(1)])
        acc_err = err2
        if split is not None:
            frozen = frozen or (
                improved and i >= coarse_iterations
                and bool(tr2 < c32(freeze_step_mm * freeze_step_mm))
                and bool(rot2 < c32(1e-6)))
        i += 1
        if finished:
            break
    return acc.to(device), i, float(acc_err)
