"""Point-to-TSDF registration on tensors: parity mode (three-plane fields +
Gauss-Newton) and fast mode (packed fields + LM).

Counterpart of ``warpsense_tpu/ops/registration.py`` (re-design of
registration.cu:14-257 and tsdf_registration.cpp:28-105):

* parity mode (``precompute_fields`` + ``register_cloud_fields``): the
  reference's scheme — value/weight and the sign-change-rejecting
  central-difference gradient in three int32 planes, the un-normalized
  voxel gradient, the rotation centered on the initial translation and the
  linear Levenberg ramp; every caller computes the planes through
  ``kernels/fields.fields_parity`` (CUDA kernel K2's parity mode on the
  card), whose plain version, run for a CPU state, is the roll
  formulation here;
* fast mode: the map's value and per-axis gradient are precomputed once per map change
  into one int32 plane (byte layout v:8|gx:8|gy:8|gz:8, ``PackedFields``)
  or two exact planes (``PackedFields2``); CUDA kernel K2
  (``kernels/fields.py``) computes them on the card, the roll formulation
  here is its plain version;
* both loops run as the JAX ``lax.while_loop`` does: the loop's carry is
  one float32 state buffer (``S_*``) on the device of the fields.  On the
  card a whole registration is one launch of the loop kernel
  (``kernels/registration.reg_loop``, ``csrc/registration.cu``): a
  thread-block cluster whose iterations are a statistics pass (K3,
  ``reg_stats_plain`` its plain version) and a step (K4,
  ``reg_step_plain``: the damped 6x6 solve by LU, the pose update and the
  convergence tests), and the host reads the state's header once
  (``run_registration``).  On the CPU the plain loop (``loop_plain``)
  runs the same steps.  The sharded loop
  (``parallel/sharded.run_registration_sharded``) runs the halves apart on
  each rank's slab of the window (``RegProblem.x_lo``, ``x_rows``): K3's
  rows of every rank are all-gathered, and K4 steps on them on every rank
  alike; the host reads the header once every ``CHUNK`` iterations.

Numerics: the statistics are float32 sums whose order differs from XLA's,
and the 6x6 solve is an explicit LU rather than XLA's, so poses agree with
the JAX package within a tolerance (tests state it), not bit for bit.
The loop kernel's step and ``reg_step_plain`` run the same float32
operations in the same order.
"""
from __future__ import annotations

import time
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
    0.  One axis at a time, so the peak scratch is four rolled planes.
    The plain version of K2's parity mode (``kernels/fields.fields_parity``,
    which runs this for a CPU state)."""
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


def jacobian_stats(state: LocalMapState, points, mask, total_transform, *,
                   size, resolution: int, normalize_gradient: bool = False):
    """One iteration's statistics straight from the map state, as the JAX
    package's parity-test API takes them: the parity fields
    (``kernels/fields.fields_parity``), then ``jacobian_stats_fields`` (the
    hot path computes the fields once a map change and reuses them)."""
    from ..kernels.fields import fields_parity
    return jacobian_stats_fields(
        fields_parity(state), state.pos, state.offset, points, mask,
        total_transform, size=size, resolution=resolution,
        normalize_gradient=normalize_gradient)


def register_cloud(state: LocalMapState, points, mask, pretransform, *,
                   size, resolution: int, max_iterations: int,
                   it_weight_gradient: float, epsilon: float,
                   mode: str = "parity") -> torch.Tensor:
    """Full GN registration against a map state, on its parity fields
    (``kernels/fields.fields_parity``); the refined 4x4 pose (float32, on
    the device of ``pretransform``).  ``mode`` as in
    ``register_cloud_fields``."""
    from ..kernels.fields import fields_parity
    return register_cloud_fields(
        fields_parity(state), state.pos, state.offset, points, mask,
        pretransform, size=size, resolution=resolution,
        max_iterations=max_iterations, it_weight_gradient=it_weight_gradient,
        epsilon=epsilon, mode=mode)


def register_cloud_fields(fields: RegistrationFields, pos, offset, points,
                          mask, pretransform, *, size, resolution: int,
                          max_iterations: int, it_weight_gradient: float,
                          epsilon: float, mode: str = "parity",
                          return_iterations: bool = False):
    """GN registration against cached ``precompute_fields`` output, the
    loop on the device of ``fields`` (the loop kernel on the card).

    ``mode="parity"``: the reference's scheme — un-normalized voxel
    gradient and the rotation centered on the INITIAL translation;
    ``"fast"``: resolution-normalized gradient and per-iteration
    recentering.  Both are the JAX function's semantics.  Returns the pose
    (4x4 float32 on ``pretransform``'s device); with ``return_iterations``,
    ``(pose, iterations)``, the count of statistics evaluations."""
    prob = RegProblem(
        fields=fields, pos=pos, offset=offset, points=points, mask=mask,
        size=tuple(size), resolution=resolution, tau=0, layout=LAYOUT_PARITY,
        interp=False, normalize=mode == "fast", lm=False,
        recenter=mode == "fast", coarse_iterations=0, split=False,
        max_iterations=max_iterations, epsilon=epsilon,
        it_weight_gradient=it_weight_gradient, freeze_step_mm=0.0)
    state, head = run_registration(prob, pretransform)
    pose = state[S_TRIAL:S_TRIAL + 16].reshape(4, 4).to(pretransform.device)
    return (pose, int(head[S_I])) if return_iterations else pose


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
    below the residual noise floor or on the 4-round error window); the
    loop runs on the device of ``fields`` (the loop kernel on the
    card)."""
    del it_weight_gradient   # parity-mode ramp; LM adapts alpha itself
    prob = RegProblem(
        fields=fields, pos=pos, offset=offset, points=points, mask=mask,
        size=tuple(size), resolution=resolution, tau=tau,
        layout=LAYOUT_EXACT if isinstance(fields, PackedFields2)
        else LAYOUT_PACKED, interp=interp, normalize=False, lm=True,
        recenter=True, coarse_iterations=coarse_iterations,
        split=gather_freeze, max_iterations=max_iterations, epsilon=epsilon,
        it_weight_gradient=0.0, freeze_step_mm=float(resolution))
    state, head = run_registration(prob, pretransform)
    pose = state[S_ACC:S_ACC + 16].reshape(4, 4).to(pretransform.device)
    return pose, int(head[S_I]), head[S_ERR]


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
    vfm = valid.to(torch.float32)
    Js = torch.cat([cross(p, gradf) * _SCP, gradf], dim=-1) * vfm[:, None]
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


# ---------------------------------------------------------- the device loop
#
# The loop's carry, one float32 buffer (ints and flags as exact floats),
# as csrc/registration.cu's S_* enum: JAX's ``init`` of _lm_loop (i, acc,
# accH, accg, acc_err, alpha, trial, prev, frozen, finished) and of _gn_loop
# (i, total = trial, alpha, prev, finished, and the fixed center).  The
# header (the first S_HEAD floats) is what the host reads after the loop.

S_I, S_FIN, S_ERR, S_FROZEN, S_ALPHA, S_IMPROVED, S_OK = range(7)
S_HEAD = 8
S_PREV, S_CENTER, S_TRIAL, S_ACC, S_ACCH, S_ACCG = 8, 12, 16, 32, 48, 84
STATE_LEN = 96
# one row of statistics (the loop kernel sums one a CTA): H's upper
# triangle (row-major), g, e, c, zeros
PARTIALS, SUMS = 32, 29
# the step sums the rows in this many interleaved lanes, then the lanes
STEP_LANES = 8
LAYOUT_PARITY, LAYOUT_PACKED, LAYOUT_EXACT = 0, 1, 2
# the plain loop's iterations between two reads of its header: a finished
# state ignores the iterations after it, so the size changes no bit
CHUNK = 8
# the sharded loop's carry slot: the state, then PENDING (1.0: the rows of
# the state's iteration were computed and are being gathered; the next
# iteration steps on them first), then zeros
CARRY_LEN = STATE_LEN + 32
PENDING = STATE_LEN

_UPPER = torch.triu_indices(6, 6)
_FULL = torch.tensor([[k for k in range(21)
                       if {int(_UPPER[0, k]), int(_UPPER[1, k])} == {i, j}][0]
                      for i in range(6) for j in range(6)])


class RegProblem(NamedTuple):
    """What one registration reads besides its state: the fields (one of
    the three layouts), the window's ring, the cloud, and the loop's
    settings.  ``lm``: the fast LM loop (packed layouts), else the GN loop
    (parity layout; ``normalize`` and ``recenter`` in its fast mode)."""
    fields: tuple
    pos: torch.Tensor
    offset: torch.Tensor
    points: torch.Tensor
    mask: torch.Tensor
    size: tuple
    resolution: int
    tau: int
    layout: int
    interp: bool
    normalize: bool
    lm: bool
    recenter: bool
    coarse_iterations: int
    split: bool
    max_iterations: int
    epsilon: float
    it_weight_gradient: float
    freeze_step_mm: float
    x_lo: int = 0
    x_rows: int | None = None


def slab_of(prob: RegProblem) -> tuple[int, int]:
    """(x_lo, x_rows): the window's ring rows [x_lo, x_lo + x_rows) whose
    cells the problem owns and its fields hold (a rank's slab on a mesh;
    the whole window by default).  A point whose cell lies in another row
    adds nothing."""
    return prob.x_lo, prob.size[0] if prob.x_rows is None else prob.x_rows


def owned_index_fn(pos, offset, size, lo: int, hi: int):
    """``index_fn`` of the statistics for the rows [lo, hi) of the window:
    the slab-local array coords of each cell (zero where another row owns
    it) and ownership."""

    def index_fn(buf):
        a = ring_coords(buf, pos, offset, size)
        owned = (a[:, 0] >= lo) & (a[:, 0] < hi)
        local = torch.stack([a[:, 0] - lo, a[:, 1], a[:, 2]], dim=-1)
        return torch.where(owned[:, None], local,
                           torch.zeros_like(local)), owned

    return index_fn


def init_state(prob: RegProblem, pretransform, device, *,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The loop's initial carry on ``device``, made there: fills and
    device copies only (no host copy when ``pretransform`` is on it
    already; an indexed assignment of a Python number would be one).
    ``out``: a float32 tensor of at least STATE_LEN on ``device`` to write
    it into (zeroed past STATE_LEN)."""
    s = (torch.zeros(STATE_LEN, dtype=torch.float32, device=device)
         if out is None else out.zero_())
    p = pretransform.detach().to(device=device,
                                 dtype=torch.float32).reshape(16)
    s[S_TRIAL:S_TRIAL + 16].copy_(p)
    torch.trunc(p[3:12:4], out=s[S_CENTER:S_CENTER + 3])
    if prob.lm:
        s[S_ACC:S_ACC + 16].copy_(p)
        s[S_ACCH:S_ACCH + 36:7].fill_(1.0)
        s[S_ERR:S_ERR + 1].fill_(float("inf"))
        s[S_ALPHA:S_ALPHA + 1].fill_(1e-3)
        s[S_PREV:S_PREV + 4].fill_(float("inf"))
    return s


def pack_stats(H, g, e, c) -> torch.Tensor:
    """(H, g, e, c) as one row of partials, (1, PARTIALS) float32."""
    row = torch.zeros((1, PARTIALS), dtype=torch.float32, device=H.device)
    row[0, :21] = H[_UPPER[0], _UPPER[1]]
    row[0, 21:27] = g
    row[0, 27] = e
    row[0, 28] = c
    return row


def stopped(state: torch.Tensor, prob: RegProblem) -> bool:
    """Whether the loop on ``state`` has ended (finished flag or
    max_iterations); reads the state."""
    return bool(state[S_FIN] != 0) or int(state[S_I]) >= prob.max_iterations


def reg_stats_plain(state: torch.Tensor, prob: RegProblem,
                    cache: dict) -> torch.Tensor | None:
    """Plain version of K3: one iteration's statistics at the state's
    trial pose, as a (1, PARTIALS) row on the state's device; None once
    the loop stopped.  The mode is JAX's: every 4th point while ``i <
    coarse_iterations``; with ``split``, gather into ``cache`` and
    evaluate, or (``frozen``) evaluate from it.  The first fine iteration
    gathers at the trial pose, which at ``i == 0`` is the pretransform,
    where JAX's loop gathered its initial cache.  On a slab
    (``slab_of``) only the points whose cells it owns count."""
    if stopped(state, prob):
        return None
    i = int(state[S_I])
    total = state[S_TRIAL:S_TRIAL + 16].reshape(4, 4).to(prob.points.device)
    args = (prob.fields, prob.pos, prob.offset)
    lo, rows = slab_of(prob)
    index_fn = None if (lo, rows) == (0, prob.size[0]) else owned_index_fn(
        prob.pos, prob.offset, prob.size, lo, lo + rows)
    if prob.layout == LAYOUT_PARITY:
        stats = jacobian_stats_fields(
            *args, prob.points, prob.mask, total, size=prob.size,
            resolution=prob.resolution, normalize_gradient=prob.normalize,
            index_fn=index_fn)
        return pack_stats(*stats).to(state.device)
    kw = dict(size=prob.size, resolution=prob.resolution, tau=prob.tau,
              interp=prob.interp, index_fn=index_fn)
    if prob.coarse_iterations > 0 and i < prob.coarse_iterations:
        stats = make_packed_stats(*args, prob.points[::4], prob.mask[::4],
                                  **kw)(total)
    elif prob.split:
        gather_fn, eval_fn = make_packed_stats_split(
            *args, prob.points, prob.mask, **kw)
        if not bool(state[S_FROZEN] != 0):
            cache.clear()
            cache.update(gather_fn(total))
        stats = eval_fn(cache, total)
    else:
        stats = make_packed_stats(*args, prob.points, prob.mask, **kw)(total)
    return pack_stats(*stats).to(state.device)


def solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 float32 solve (..., 6, 6) x = (..., 6) by LU with
    partial pivoting (the first row of largest |pivot|), in K4's order of
    operations; a zero pivot makes the whole solution NaN (the step is
    then skipped), where LAPACK would report the singular system."""
    shape = b.shape
    A = A.reshape(-1, 6, 6).to(torch.float32).clone()
    b = b.reshape(-1, 6).to(torch.float32).clone()
    n = A.shape[0]
    rows = torch.arange(n, device=A.device)
    singular = torch.zeros(n, dtype=torch.bool, device=A.device)
    for k in range(6):
        p = torch.full((n,), k, dtype=torch.int64, device=A.device)
        best = A[:, k, k].abs()
        for r in range(k + 1, 6):
            v = A[:, r, k].abs()
            take = v > best
            best = torch.where(take, v, best)
            p = torch.where(take, torch.full_like(p, r), p)
        row_k, row_p = A[:, k].clone(), A[rows, p].clone()
        A[:, k], A[rows, p] = row_p, row_k
        b_k, b_p = b[:, k].clone(), b[rows, p].clone()
        b[:, k], b[rows, p] = b_p, b_k
        piv = A[:, k, k]
        singular |= piv == 0
        if k < 5:
            f = A[:, k + 1:, k] / piv[:, None]
            A[:, k + 1:, k + 1:] = (A[:, k + 1:, k + 1:]
                                    - f[:, :, None] * A[:, k:k + 1, k + 1:])
            b[:, k + 1:] = b[:, k + 1:] - f * b[:, k:k + 1]
    y = torch.empty_like(b)
    for r in range(5, -1, -1):
        s = b[:, r]
        for j in range(r + 1, 6):
            s = s - A[:, r, j] * y[:, j]
        y[:, r] = s / A[:, r, r]
    y = torch.where(singular[:, None], torch.full_like(y, float("nan")), y)
    return y.reshape(shape)


def _c32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant, as JAX rounds a weak Python float against a
    float32 value."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def xi_to_transform_plain(xi: torch.Tensor, center: torch.Tensor,
                          P: torch.Tensor) -> torch.Tensor:
    """``xi_to_transform(xi, center) @ P`` in K4's float32 operations and
    order: each product sum written out (no matmul, whose order and fused
    multiply-adds are the library's), sqrt, sin and cos rounded once from
    float64."""
    one = _c32(1.0, xi)
    a = xi[:3]
    th2 = (a[0] * a[0] + a[1] * a[1]) + a[2] * a[2]
    theta = torch.sqrt(th2.double()).float()
    eye = torch.eye(3, dtype=torch.float32, device=xi.device)
    if bool(theta < _c32(1e-12, xi)):
        R = eye
    else:
        u = a / theta
        zero = torch.zeros((), dtype=torch.float32, device=xi.device)
        L = torch.stack([zero, -u[2], u[1], u[2], zero, -u[0],
                         -u[1], u[0], zero]).reshape(3, 3)
        LL = (L[:, 0:1] * L[0:1, :] + L[:, 1:2] * L[1:2, :]) \
            + L[:, 2:3] * L[2:3, :]
        sn = torch.sin(theta.double()).float()
        c1 = one - torch.cos(theta.double()).float()
        R = (eye + sn * L) + c1 * LL
    rc = (R[:, 0] * -center[0] + R[:, 1] * -center[1]) + R[:, 2] * -center[2]
    T = torch.zeros((4, 4), dtype=torch.float32, device=xi.device)
    T[:3, :3] = R
    T[:3, 3] = (rc + center) + xi[3:]
    T[3, 3] = 1.0
    return ((T[:, 0:1] * P[0:1, :] + T[:, 1:2] * P[1:2, :])
            + T[:, 2:3] * P[2:3, :]) + T[:, 3:4] * P[3:4, :]


def sum_partials(partials: torch.Tensor) -> torch.Tensor:
    """K4's sum of the rows of statistics (the loop kernel's CTAs' rows):
    STEP_LANES interleaved lanes (rows l, l + STEP_LANES, ...) each summed
    in row order, then the lanes in order."""
    total = torch.zeros(PARTIALS, dtype=torch.float32,
                        device=partials.device)
    for lane in range(STEP_LANES):
        t = torch.zeros_like(total)
        for row in partials[lane::STEP_LANES]:
            t = t + row
        total = total + t
    return total


def reg_step_plain(state: torch.Tensor, partials, prob: RegProblem):
    """Plain version of K4: one step of the loop on ``state`` (in place)
    from one iteration's ``partials`` (rows of statistics); nothing once
    the loop stopped.  Returns the float32 values its tests compared
    (``err`` and the window's ``prev``; LM also ``acc_err``, ``err2``,
    ``rot2``, ``tr2``), or None when it did nothing.

    GN (``_gn_loop``): (H + alpha c diag(D^2)) y = -g (the identity for an
    empty system), xi = D y, the pose update about the fixed center (the
    current translation in fast mode) when the solve is finite, the
    4-error window, alpha += it_weight_gradient.  LM (``_lm_loop``):
    accept or reject against the accepted error (the coarse-to-fine
    hand-off re-baselines), alpha / 3 or * 4 in [1e-5, 1e5], the
    Marquardt-damped solve from the accepted state, the next trial, and
    the tests: tiny step, the 4-error window, a non-finite step; the
    gather freeze.  Thresholds compare in float32."""
    if partials is None or stopped(state, prob):
        return None
    s = state
    f32 = torch.float32
    i = int(s[S_I])
    tot = sum_partials(partials.to(device=s.device, dtype=f32))
    H = tot[_FULL.to(s.device)].reshape(6, 6)
    g, e, c = tot[21:27], tot[27], tot[28]
    eps = _c32(prob.epsilon, s)
    prev = s[S_PREV:S_PREV + 4].clone()
    diag = torch.arange(6, device=s.device)
    if not prob.lm:
        D = torch.tensor([_SC] * 3 + [_SG] * 3, dtype=f32, device=s.device)
        empty = bool(c <= 0.0)
        if empty:
            A = torch.eye(6, dtype=f32, device=s.device)
        else:
            A = H.clone()
            A[diag, diag] = H[diag, diag] + (s[S_ALPHA] * c) * (D * D)
        y = solve6(A, -g)
        ok = not empty and bool(torch.all(torch.isfinite(y)))
        T = s[S_TRIAL:S_TRIAL + 16].reshape(4, 4)
        ctr = (torch.trunc(T[:3, 3]) if prob.recenter
               else s[S_CENTER:S_CENTER + 3])
        if ok:
            s[S_TRIAL:S_TRIAL + 16] = xi_to_transform_plain(
                D * y, ctr, T).reshape(16)
        err = e / torch.maximum(c, _c32(1.0, s))
        fin = (ok and bool(torch.abs(err - prev[2]) < eps)
               and bool(torch.abs(err - prev[0]) < eps)) or empty
        s[S_PREV:S_PREV + 4] = torch.cat([prev[1:], err.reshape(1)])
        s[S_ERR] = err
        s[S_OK] = float(ok)
        s[S_FIN] = float(fin)
        s[S_ALPHA] = s[S_ALPHA] + _c32(prob.it_weight_gradient, s)
        s[S_I] = i + 1
        return dict(err=err, prev=prev)
    D = torch.tensor([_SCP] * 3 + [1.0] * 3, dtype=f32, device=s.device)
    acc_err = s[S_ERR].clone()
    err = (e / torch.maximum(c, _c32(1.0, s)) if bool(c > 0.0)
           else _c32(float("inf"), s))
    improved = bool(err <= acc_err)
    err2 = torch.minimum(err, acc_err)
    if prob.coarse_iterations > 0 and i == prob.coarse_iterations:
        improved, err2 = True, err
    if improved:
        s[S_ACC:S_ACC + 16] = s[S_TRIAL:S_TRIAL + 16]
        s[S_ACCH:S_ACCH + 36] = H.reshape(36)
        s[S_ACCG:S_ACCG + 6] = g
    alpha = (s[S_ALPHA] / _c32(3.0, s) if improved
             else s[S_ALPHA] * _c32(4.0, s))
    alpha = torch.minimum(torch.maximum(alpha, _c32(1e-5, s)),
                          _c32(1e5, s))
    accH = s[S_ACCH:S_ACCH + 36].reshape(6, 6)
    A = accH.clone()
    A[diag, diag] = accH[diag, diag] + alpha * (accH[diag, diag]
                                                + _c32(1e-12, s))
    y = solve6(A, -s[S_ACCG:S_ACCG + 6])
    ok = bool(torch.isfinite(err2)) and bool(torch.all(torch.isfinite(y)))
    xi = D * y if ok else torch.zeros(6, dtype=f32, device=s.device)
    acc = s[S_ACC:S_ACC + 16].reshape(4, 4)
    s[S_TRIAL:S_TRIAL + 16] = xi_to_transform_plain(
        xi, torch.trunc(acc[:3, 3]), acc).reshape(16)
    rot2 = (xi[0] * xi[0] + xi[1] * xi[1]) + xi[2] * xi[2]
    tr2 = (xi[3] * xi[3] + xi[4] * xi[4]) + xi[5] * xi[5]
    tiny = (improved and bool(rot2 < _c32(1e-7, s))
            and bool(tr2 < _c32(0.25, s)))
    window = (bool(torch.abs(err2 - prev[2]) < eps)
              and bool(torch.abs(err2 - prev[0]) < eps))
    if (prob.split and improved and i >= prob.coarse_iterations
            and bool(tr2 < _c32(prob.freeze_step_mm ** 2, s))
            and bool(rot2 < _c32(1e-6, s))):
        s[S_FROZEN] = 1.0
    s[S_PREV:S_PREV + 4] = torch.cat([prev[1:], err2.reshape(1)])
    s[S_ERR] = err2
    s[S_ALPHA] = alpha
    s[S_IMPROVED] = float(improved)
    s[S_OK] = float(ok)
    s[S_FIN] = float(tiny or window or not ok)
    s[S_I] = i + 1
    return dict(err=err, prev=prev, acc_err=acc_err, err2=err2, rot2=rot2,
                tr2=tr2)


def trace_width(rows: int) -> int:
    """Floats in a row of a loop trace with ``rows`` rows of statistics:
    the carry before the step, then the rows."""
    return STATE_LEN + rows * PARTIALS


def loop_plain(state: torch.Tensor, prob: RegProblem, stats_row, *,
               chunk: int = 1, trace=None) -> None:
    """The loop on ``state`` (in place) one iteration at a time:
    ``stats_row(state, cache)`` gives an iteration's row of statistics on
    the state's device, ``reg_step_plain`` takes the step; the header is
    read once every ``chunk`` iterations (a finished state ignores the
    rest of a chunk, so ``chunk`` changes no bit).  ``trace``: as
    ``kernels.registration.reg_loop`` takes it; row i gets the carry before
    step i, the row of statistics and zeros for the other rows."""
    cache: dict = {}
    while not stopped(state, prob):
        for _ in range(chunk):
            if stopped(state, prob):
                break
            row = stats_row(state, cache)
            if trace is not None:
                t = trace[int(state[S_I])]
                t.zero_()
                t[:STATE_LEN] = state
                t[STATE_LEN:STATE_LEN + PARTIALS] = row.reshape(PARTIALS)
            reg_step_plain(state, row, prob)


def fused_iteration_plain(src: torch.Tensor, dst: torch.Tensor,
                          rows_in: torch.Tensor, rows_out: torch.Tensor,
                          prob: RegProblem, cache: dict,
                          trace=None) -> None:
    """Plain version of the sharded loop's fused iteration
    (``shard_iter_kernel``): from the carry slot ``src`` into the slot
    ``dst`` (each CARRY_LEN floats).  When ``src``'s PENDING flag is set,
    first the step of its iteration on the world's gathered rows
    ``rows_in`` (``reg_step_plain``; with a trace, row i gets the carry
    before step i and the rows), then, unless the carry stopped, the
    statistics of the next iteration on the same carry
    (``reg_stats_plain``) into ``rows_out``, which sets PENDING in
    ``dst``."""
    state = src[:STATE_LEN].clone()
    if bool(src[PENDING] != 0):
        if trace is not None:
            t = trace[int(state[S_I])]
            t[:STATE_LEN] = state
            t[STATE_LEN:] = rows_in.reshape(-1)
        reg_step_plain(state, rows_in, prob)
    dst[:STATE_LEN] = state
    row = reg_stats_plain(state, prob, cache)
    if row is not None:
        rows_out.copy_(row.reshape(rows_out.shape))
    dst[PENDING] = float(row is not None)


def shard_reads(iterations: int, chunk: int = CHUNK) -> int:
    """Header reads of a sharded registration of ``iterations`` steps in
    chunks of ``chunk`` fused iterations: each launch steps on the rows
    of the one before, so the first chunk takes ``chunk - 1`` steps and
    the loop ends after ``iterations + 1`` launches."""
    return -(-(iterations + 1) // chunk)


def host_loop(prob: RegProblem, pretransform, stats_row, *,
              trace=None) -> torch.Tensor:
    """The loop with its state on the CPU (``loop_plain`` from
    ``init_state``): ``stats_row(state, cache)`` gives an iteration's
    partials on the CPU.  The loop the loop kernel is checked against
    (``run_registration(host=True)``)."""
    state = init_state(prob, pretransform, "cpu")
    loop_plain(state, prob, stats_row, trace=trace)
    return state


def replay_trace(trace: torch.Tensor, final: torch.Tensor,
                 prob: RegProblem):
    """Replay the trace of a loop from ``init_state`` with the plain step:
    for each traced iteration k, ``reg_step_plain`` from the carry traced
    before step k on the rows traced with it, held to the carry traced
    before step k + 1 (after the last step: ``final``, the loop's end
    state).  Returns (the replayed end state, the steps whose result
    differs in any bit, the values each step's tests compared, the largest
    absolute difference of a replayed carry from the traced one: 0 when
    every step is bit-equal, inf where they differ in a NaN or an
    infinity).  On the CPU."""
    trace, final = trace.cpu(), final.cpu()
    steps = int(final[S_I])
    out = final.clone()
    differ, tests, err = [], [], 0.0
    for k in range(steps):
        out = trace[k, :STATE_LEN].clone()
        tests.append(reg_step_plain(
            out, trace[k, STATE_LEN:].reshape(-1, PARTIALS), prob))
        want = trace[k + 1, :STATE_LEN] if k + 1 < steps else final
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            differ.append(k)
            d = (out.double() - want.double()).abs()
            d[out.view(torch.int32) == want.view(torch.int32)] = 0.0
            err = max(err, float(d.nan_to_num(nan=float("inf")).max()))
    return out, differ, tests, err


def trace_stats(trace: torch.Tensor, iterations: int, prob: RegProblem,
                rows: slice = slice(None)) -> list:
    """Each traced iteration's rows of statistics (``rows`` of them: on a
    mesh, one rank's, with ``prob`` that rank's slab), summed in the
    step's order (``sum_partials``), against ``reg_stats_plain`` at the
    traced carry (its cache gathered where the loop's was): a dict an
    iteration with its mode, c and the plain version's c, and H's, g's and
    e's largest difference relative to the plain version's largest
    entry."""
    cache: dict = {}
    host = trace[:iterations].cpu()
    out = []
    for k in range(iterations):
        if prob.lm and k < prob.coarse_iterations:
            mode = "coarse"
        elif prob.split:
            mode = "cached" if bool(host[k, S_FROZEN]) else "gather"
        else:
            mode = "full"
        got = sum_partials(
            host[k, STATE_LEN:].reshape(-1, PARTIALS)[rows]).double()
        want = reg_stats_plain(trace[k, :STATE_LEN].clone(), prob,
                               cache)[0].cpu().double()
        rel = {key: float((got[lo:hi] - want[lo:hi]).abs().max()
                          / max(float(want[lo:hi].abs().max()), 1e-30))
               for key, lo, hi in (("H_rel", 0, 21), ("g_rel", 21, 27),
                                   ("e_rel", 27, 28))}
        out.append(dict(mode=mode, c=float(got[28]), c_plain=float(want[28]),
                        **rel))
    return out


def run_registration(prob: RegProblem, pretransform, *, chunk: int = CHUNK,
                     host: bool = False, trace=None):
    """Run one registration loop; returns (final state, its header as a
    list of floats).

    The state lives on the device of ``prob.points`` and the loop is
    ``kernels.registration.reg_loop``: on a CUDA state one launch of the
    loop kernel (a build or launch failure raises) and one read of the
    header (``run_registration.syncs``), the pose left on the card; on a
    CPU state the plain loop, its header read once every ``chunk``
    iterations.  ``host``: the state on the CPU and the plain versions for
    any device (statistics where the fields lie, one copy each way an
    iteration): the loop the kernel is checked against.  ``trace``: as
    ``reg_loop`` takes it (with ``host``: on the CPU, one row of
    statistics)."""
    from ..kernels.registration import reg_loop
    t0 = time.perf_counter()
    if host:
        state = host_loop(prob, pretransform, lambda st, cache: (
            reg_stats_plain(st, prob, cache).cpu()), trace=trace)
    else:
        state = init_state(prob, pretransform, prob.points.device)
        reg_loop(state, prob, chunk=chunk, trace=trace)
    head = state[:S_HEAD].tolist()
    count_registration(head, 1 if state.is_cuda else 0, t0)
    return state, head


def count_registration(head: list, syncs: int, t0: float) -> None:
    """Add one registration that ended with ``head`` to
    ``run_registration``'s counts: its iterations, its ``syncs`` (header
    reads of a CUDA state) and the host clock since ``t0``."""
    run_registration.syncs += syncs
    run_registration.calls += 1
    run_registration.iterations += int(head[S_I])
    run_registration.seconds += time.perf_counter() - t0


def reset_registration_counts() -> None:
    """Zero ``run_registration``'s counts: ``calls`` (registrations),
    ``iterations`` (their sum), ``syncs`` (header reads of a CUDA state)
    and ``seconds`` (host clock from the launch to the header's read,
    which waits for the card)."""
    run_registration.syncs = 0
    run_registration.calls = 0
    run_registration.iterations = 0
    run_registration.seconds = 0.0


reset_registration_counts()
