"""Plain versions of the layers the benchmark's window drives.

Frozen copies of the plain PyTorch versions in ``warpsense_tpu_torch``
(``core/geometry``, ``ops/preprocess``, ``ops/tsdf_projective``,
``ops/registration``), which the port's tests hold bit for bit against
the JAX package: the fixed-point geometry, the voxel dedup, the beam
table and projective sweep with the weighted merge, the packed (K2) and
three-plane (parity) fields, and one registration's statistics (K3) and
step (K4).  They take plain tensors: the map is a box of voxels in global
order (``box_lo`` its lowest global voxel), where the program keeps a ring
buffer; every per-voxel quantity depends on global coordinates only, so
the two give the same values.  Nothing here imports the program.

``stats_dtype`` (registration): the statistics' working type; float32 is
the configuration's, bfloat16 the precision control's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MATRIX_RESOLUTION = 1 << 15
WEIGHT_RESOLUTION = 1 << 6

# --------------------------------------------------------------- geometry


def to_int_mat(pose: torch.Tensor) -> torch.Tensor:
    return (pose * MATRIX_RESOLUTION).to(torch.int32)


def div_trunc(a: torch.Tensor, b) -> torch.Tensor:
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    q = torch.div(torch.abs(a), torch.abs(b), rounding_mode="floor")
    return torch.where((a < 0) != (b < 0), -q, q)


def transform_point_fixed(points: torch.Tensor,
                          int_mat: torch.Tensor) -> torch.Tensor:
    """``(R*p + t) / MR`` in wrapping int32 arithmetic, C truncation."""
    p = points.to(torch.int32)
    m = int_mat.to(torch.int32)
    cols = []
    for j in range(3):
        acc = p[..., 0] * m[j, 0] + p[..., 1] * m[j, 1] + p[..., 2] * m[j, 2]
        cols.append(acc + m[j, 3])
    return div_trunc(torch.stack(cols, dim=-1), MATRIX_RESOLUTION)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def in_window(cells: torch.Tensor, pos: torch.Tensor, size,
              buffer: int = 0) -> torch.Tensor:
    """Per-cell bool: inside the window about ``pos`` shrunk (buffer > 0)
    or grown (< 0); floor convention on even axes."""
    d = cells - pos
    sz = torch.as_tensor(size, dtype=d.dtype, device=d.device)
    lo = -torch.div(sz, 2, rounding_mode="floor") + buffer
    hi = torch.div(sz - 1, 2, rounding_mode="floor") - buffer
    return torch.all((d >= lo) & (d <= hi), dim=-1)


# ------------------------------------------------------------- preprocess

def _lexsort3(cx, cy, cz):
    order = torch.argsort(cz, stable=True)
    order = order[torch.argsort(cy[order], stable=True)]
    return order[torch.argsort(cx[order], stable=True)]


def preprocess(points_m, valid, pose, *, resolution: int, capacity: int,
               snap: bool):
    """Voxel dedup (first point per voxel, or its centre with ``snap``)
    and the fixed-point pose transform; (points (capacity, 3) int32 mm,
    mask), valid first."""
    x, y, z = points_m[:, 0], points_m[:, 1], points_m[:, 2]
    near = (x < 0.3) & (y < 0.3) & (z < 0.3)
    keep = valid & ~near & torch.all(torch.isfinite(points_m), dim=-1)
    mm = points_m * 1000.0
    center = (torch.floor(mm / resolution) * resolution
              + resolution // 2).to(torch.int32)
    big = torch.tensor(2 ** 30, dtype=torch.int32, device=points_m.device)
    cx = torch.where(keep, center[:, 0], big)
    cy = torch.where(keep, center[:, 1], big)
    cz = torch.where(keep, center[:, 2], big)
    order = _lexsort3(cx, cy, cz)
    sc = center[order]
    skeep = keep[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool,
                                  device=points_m.device),
                       torch.any(sc[1:] != sc[:-1], dim=-1)])
    uniq = skeep & first
    if not snap:
        sc = torch.round(mm).to(torch.int32)[order]
    comp = torch.argsort((~uniq).to(torch.uint8), stable=True)[:capacity]
    out_pts = sc[comp]
    out_mask = uniq[comp]
    transformed = transform_point_fixed(out_pts, to_int_mat(pose))
    return torch.where(out_mask[:, None], transformed,
                       torch.zeros_like(transformed)), out_mask


# ----------------------------------------------------------------- fusion

_ATAN_COEFFS = (
    0.9999983562999126, -0.3332313212264718, 0.1985179587326387,
    -0.13379591763197257, 0.08200914681344318, -0.0354820989980964,
    0.0073824108965324904)
_SLAB_VOXELS = 1 << 22


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (a double sqrt rounded once)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def banded_atan(t):
    s = t * t
    p = _f32(_ATAN_COEFFS[-1], t)
    for c in reversed(_ATAN_COEFFS[:-1]):
        p = p * s + _f32(c, t)
    return p * t


def atan2_poly(y, x):
    ax_, ay_ = torch.abs(x), torch.abs(y)
    hi = torch.maximum(torch.maximum(ax_, ay_), _f32(1e-20, x))
    t = torch.minimum(ax_, ay_) / hi
    p = banded_atan(t)
    r = torch.where(ay_ > ax_, _f32(math.pi / 2, x) - p, p)
    r = torch.where(x < 0, _f32(math.pi, x) - r, r)
    return torch.where(y < 0, -r, r)


def dz_per_distance(channels: int, vfov_deg: float) -> int:
    angle = vfov_deg / channels
    return int(math.tan(angle / 180.0 * math.pi) / 2.0 * MATRIX_RESOLUTION)


def sensor_tilt_deg(pose_mm) -> float:
    import numpy as np
    R = np.asarray(pose_mm, np.float64)[:3, :3]
    return float(np.degrees(np.arccos(np.clip(R[2, 2], -1.0, 1.0))))


def grid_rotation(pose_mm) -> torch.Tensor:
    """The beam grid's attitude: level (identity) within 2 degrees of
    tilt, the sensor's attitude beyond."""
    import numpy as np
    if sensor_tilt_deg(pose_mm) <= 2.0:
        return torch.eye(3, dtype=torch.float32)
    return torch.as_tensor(np.asarray(pose_mm, np.float32)[:3, :3].copy())


def build_beam_table(points, mask, scanner_mm, R_sensor, *, channels,
                     columns, vfov_deg):
    """Nearest return per (column, ring) beam: (range (columns*channels,)
    f32 with +inf holes, endpoint (columns*channels, 3) f32 mm)."""
    dev = points.device
    p = (points - scanner_mm).to(torch.float32)
    R = R_sensor.to(torch.float32)
    d = [p[:, 0] * R[0, j] + p[:, 1] * R[1, j] + p[:, 2] * R[2, j]
         for j in range(3)]
    rng = _sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    ok = mask & (rng > 1.0)
    safe = torch.clamp(rng, min=1.0)
    az = torch.atan2(d[1], d[0])
    el = torch.asin(torch.clamp(d[2] / safe, -1.0, 1.0))
    spacing = math.radians(vfov_deg) / (channels - 1)
    half_v = math.radians(vfov_deg) / 2.0
    ring = torch.round((_f32(half_v, p) - el) / _f32(spacing, p)).to(
        torch.int32)
    col = torch.remainder(
        torch.round((az + _f32(math.pi, p)) / _f32(2 * math.pi, p)
                    * _f32(columns, p)).to(torch.int32), columns)
    ok = ok & (ring >= 0) & (ring < channels)
    nbeam = columns * channels
    flat = torch.where(ok, col * channels + ring,
                       torch.full_like(ring, nbeam))
    n = points.shape[0]
    big = 2 ** 30
    key = (torch.clamp(rng / 8.0, max=2.0 ** 14 - 1).to(torch.int32) << 17) \
        | torch.arange(n, dtype=torch.int32, device=dev)
    key = torch.where(ok, key, torch.full_like(key, big))
    table = torch.full((nbeam + 1,), big, dtype=torch.int32, device=dev)
    table = table.scatter_reduce(0, flat.to(torch.int64), key, "amin")
    table = table[:nbeam]
    hit = table < big
    idx = torch.where(hit, table & ((1 << 17) - 1), torch.zeros_like(table))
    endpoint = torch.where(hit[:, None], points[idx.to(torch.int64)].to(
        torch.float32), torch.zeros((), dtype=torch.float32, device=dev))
    rel = endpoint - scanner_mm.to(torch.float32)
    norm = _sqrt(rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]
                 + rel[:, 2] * rel[:, 2])
    return torch.where(hit, norm, torch.full_like(norm, math.inf)), endpoint


def _sweep(cx, cy, cz, rng_tab, endpoint, scanner_mm, rotation, *, tau,
           resolution, channels, columns, vfov_deg):
    """New (value, weight) int32 of every voxel of the box with per-axis
    scanner-relative coordinates ``cx``, ``cy``, ``cz`` (f32 mm)."""
    R = rotation.to(torch.float32)
    x = cx[:, None, None]
    y = cy[None, :, None]
    z = cz[None, None, :]
    dsx = x * R[0, 0] + y * R[1, 0] + z * R[2, 0]
    dsy = x * R[0, 1] + y * R[1, 1] + z * R[2, 1]
    dsz = x * R[0, 2] + y * R[1, 2] + z * R[2, 2]
    rho2 = dsx * dsx + dsy * dsy
    r_vox = _sqrt(rho2 + dsz * dsz)
    az = atan2_poly(dsy, dsx)
    inv_rho = _f32(1.0, cx) / torch.maximum(_sqrt(rho2), _f32(1e-20, cx))
    el = banded_atan(dsz * inv_rho)
    spacing = math.radians(vfov_deg) / (channels - 1)
    half_v = math.radians(vfov_deg) / 2.0
    ringf = torch.clamp((_f32(half_v, cx) - el) * _f32(1.0 / spacing, cx),
                        -1e4, 1e4)
    ring = torch.round(ringf).to(torch.int32)
    colf = (az + _f32(math.pi, cx)) * _f32(columns / (2 * math.pi), cx)
    col = torch.remainder(torch.round(colf).to(torch.int32), columns)
    ring_ok = (ring >= 0) & (ring < channels)
    flat = (col * channels + torch.clamp(ring, 0, channels - 1)).to(
        torch.int64)
    smm = scanner_mm.to(torch.float32)
    r_beam = rng_tab[flat]
    shape = r_vox.shape
    ex = x.expand(shape) - (endpoint[:, 0][flat] - smm[0])
    ey = y.expand(shape) - (endpoint[:, 1][flat] - smm[1])
    ez = z.expand(shape) - (endpoint[:, 2][flat] - smm[2])

    weight_epsilon = tau // 10
    f = r_vox
    value = _sqrt(ex * ex + ey * ey + ez * ez)
    value = torch.minimum(value, _f32(float(tau), f))
    value = torch.where(r_vox > r_beam, -value, value)
    dzpd = dz_per_distance(channels, vfov_deg)
    delta_z = _f32(dzpd, f) * r_vox * _f32(1.0 / MATRIX_RESOLUTION, f)
    v_res = r_vox * torch.abs(ringf - ring.to(torch.float32)) \
        * _f32(spacing, f)
    half_res = _f32(resolution * 0.5, f)
    vertical_ok = v_res <= torch.maximum(delta_z, half_res)
    col_res = torch.abs(colf - torch.round(colf))
    h_res = r_vox * col_res * _f32(2 * math.pi / columns, f)
    horizontal_ok = h_res <= half_res
    interp = v_res > half_res
    w = torch.where(
        value < -weight_epsilon,
        torch.floor((_f32(WEIGHT_RESOLUTION, f) * (_f32(tau, f) + value))
                    * _f32(1.0 / (tau - weight_epsilon), f)),
        _f32(float(WEIGHT_RESOLUTION), f)).to(torch.int32)
    ok = (ring_ok & torch.isfinite(r_beam) & vertical_ok & horizontal_ok
          & (r_vox <= r_beam + _f32(tau, f)) & (w != 0))
    w = torch.where(interp, -w, w)
    value_i = torch.trunc(value).to(torch.int32)
    zero = torch.zeros_like(value_i)
    return torch.where(ok, value_i, zero), torch.where(ok, w, zero)


def _merge(ev, ew, new_v, new_w, max_weight):
    """The weighted-average merge on int32 planes."""
    avg_case = (new_w > 0) & (ew > 0)
    over_case = (new_w != 0) & (ew <= 0)
    den = torch.where(avg_case, ew + new_w, torch.ones_like(ew))
    avg_v = torch.div(ev * ew + new_v * new_w, den, rounding_mode="trunc")
    out_v = torch.where(avg_case, avg_v, torch.where(over_case, new_v, ev))
    out_w = torch.where(avg_case, torch.clamp(ew + new_w, max=max_weight),
                        torch.where(over_case, new_w, ew))
    return out_v, out_w


def fuse(value, weight, box_lo, window_pos, size, points, mask, pose_mm, *,
         tau, max_weight, resolution, channels, columns, vfov_deg) -> None:
    """One projective fusion, in place on the int16 box ``value`` /
    ``weight`` (global voxel ``box_lo`` at index 0) of the window about
    ``window_pos``, from the map-frame cloud captured at ``pose_mm``."""
    import numpy as np
    dev = value.device
    pos_i = np.floor(np.asarray(pose_mm)[:3, 3] / resolution).astype(
        np.int32)
    scanner_mm = torch.as_tensor(pos_i * resolution + resolution // 2,
                                 device=dev)
    rotation = grid_rotation(pose_mm)
    cell = torch.div(points, resolution, rounding_mode="floor")
    mask = mask & in_window(cell, window_pos, size,
                            -(tau // resolution // 2))
    rng_tab, endpoint = build_beam_table(
        points, mask, scanner_mm, rotation, channels=channels,
        columns=columns, vfov_deg=vfov_deg)
    coords = [((box_lo[ax] + torch.arange(value.shape[ax], device=dev,
                                          dtype=torch.int32)) * resolution
               + resolution // 2 - scanner_mm[ax]).to(torch.float32)
              for ax in range(3)]
    X, Y, Z = value.shape
    step = max(1, _SLAB_VOXELS // (Y * Z))
    for x0 in range(0, X, step):
        sl = slice(x0, min(X, x0 + step))
        nv, nw = _sweep(coords[0][sl], coords[1], coords[2], rng_tab,
                        endpoint, scanner_mm, rotation, tau=tau,
                        resolution=resolution, channels=channels,
                        columns=columns, vfov_deg=vfov_deg)
        ov, ow = _merge(value[sl].to(torch.int32), weight[sl].to(torch.int32),
                        nv, nw, max_weight)
        value[sl] = ov.to(torch.int16)
        weight[sl] = ow.to(torch.int16)


# ----------------------------------------------------------------- fields

def _pack16(lo, hi):
    return ((hi.to(torch.int32) & 0xFFFF) << 16) | (lo.to(torch.int32)
                                                    & 0xFFFF)


def _unpack_lo(x):
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def _unpack_hi(x):
    return x >> 16


def _pack_shift(tau: int, limit: int) -> int:
    s = 0
    while (tau >> s) > limit:
        s += 1
    return s


def _rshift_round(x, s):
    return (x + (1 << s >> 1)) >> s if s else x


def packed_fields(value, weight, *, tau: int) -> torch.Tensor:
    """One int32 plane v:8|gx:8|gy:8|gz:8 (v byte 0: weight 0): value and
    central-difference gradient where both neighbours have weight,
    quantised by the least power of two that fits tau in 126; the
    neighbours wrap at the window's ends (its ring)."""
    vs = gs = _pack_shift(tau, 126)
    v = value.to(torch.int32)
    w = weight.to(torch.int32)
    codes = []
    for ax in range(3):
        nv, pv = torch.roll(v, -1, ax), torch.roll(v, 1, ax)
        ok = (torch.roll(w, -1, ax) != 0) & (torch.roll(w, 1, ax) != 0)
        g = torch.where(ok, div_trunc(nv - pv, 2), torch.zeros_like(nv))
        del nv, pv, ok
        codes.append(torch.clamp(_rshift_round(g, gs) + 128, 1, 255))
        del g
    vcode = torch.where(w != 0, torch.clamp(_rshift_round(v, vs) + 128, 1,
                                            255), torch.zeros_like(v))
    return (vcode << 24) | (codes[0] << 16) | (codes[1] << 8) | codes[2]


def parity_fields(value, weight):
    """Three int32 planes (vw = weight<<16|value, gxy, gz): the gradient
    where both neighbours have weight and the value does not change sign
    across the cell, else 0."""
    v = value.to(torch.int32)
    w = weight.to(torch.int32)
    grads = []
    for ax in range(3):
        nv, pv = torch.roll(v, -1, ax), torch.roll(v, 1, ax)
        ok = (torch.roll(w, -1, ax) != 0) & (torch.roll(w, 1, ax) != 0)
        sign_change = ((nv > 0) & (pv < 0)) | ((nv < 0) & (pv > 0))
        grads.append(torch.where(ok & ~sign_change, div_trunc(nv - pv, 2),
                                 torch.zeros_like(nv)))
        del nv, pv, ok, sign_change
    return (_pack16(v, w), _pack16(grads[0], grads[1]),
            _pack16(grads[2], torch.zeros_like(v)))


# ----------------------------------------------------------- registration

_SC = 1.0 / (1 << 24)
_SG = 1.0 / (1 << 10)
_SCP = 1.0 / (1 << 15)


def _box_index(buf, box_lo):
    return [buf[:, ax] - box_lo[ax] for ax in range(3)]


def gather_packed(plane, buf, valid, box_lo, tau):
    """(valid, value, gradient in mm per voxel) of the packed plane at
    the cells ``buf`` (zero index where not ``valid``)."""
    vs = gs = _pack_shift(tau, 126)
    a = [torch.where(valid, i, torch.zeros_like(i))
         for i in _box_index(buf, box_lo)]
    code = plane[a[0].long(), a[1].long(), a[2].long()]
    vcode = (code >> 24) & 0xFF
    v = (vcode - 128) << vs
    grad = torch.stack([(((code >> 16) & 0xFF) - 128) << gs,
                        (((code >> 8) & 0xFF) - 128) << gs,
                        ((code & 0xFF) - 128) << gs], dim=-1)
    return valid & (vcode != 0), v, grad


def lm_stats(plane, box_lo, pos, size, points, mask, total, cache, *,
             resolution, tau, gather: bool, dtype):
    """The fast LM's statistics [H, g, e, c] at ``total`` (4x4 float32)
    with the interpolated residual; ``gather`` re-reads the plane into
    ``cache`` (the gather freeze reuses it)."""
    total = torch.as_tensor(total, device=points.device)
    int_mat = torch.trunc(total * MATRIX_RESOLUTION).to(torch.int32)
    pts = transform_point_fixed(points, int_mat)
    if gather:
        buf = torch.div(pts, resolution, rounding_mode="floor")
        valid = mask & in_window(buf, pos, size, 1)
        ok, v, grad = gather_packed(plane, buf, valid, box_lo, tau)
        cache.clear()
        cache.update(valid=ok, v=v.to(torch.float32),
                     gradf=grad.to(torch.float32) / float(resolution),
                     cc=buf * resolution + resolution // 2)
    gradf = cache["gradf"]
    dpos = (pts - cache["cc"]).to(torch.float32)
    r = cache["v"] + torch.sum(gradf * dpos, dim=-1)
    p = pts.to(torch.float32) - total[:3, 3]
    vfm = cache["valid"].to(torch.float32)
    Js = torch.cat([cross(p, gradf) * _SCP, gradf], dim=-1) * vfm[:, None]
    r = r * vfm
    return _normal_equations(Js, r, vfm, dtype)


def gn_stats(fields, box_lo, pos, size, points, mask, total, *, resolution,
             dtype):
    """The parity GN's scaled statistics [D H D, D g, e, c] at ``total``,
    the rotation about its truncated translation."""
    vw_p, gxy_p, gz_p = fields
    total = torch.as_tensor(total, device=points.device)
    int_mat = torch.trunc(total * MATRIX_RESOLUTION).to(torch.int32)
    center = total[:3, 3].to(torch.int32)
    pts = transform_point_fixed(points, int_mat)
    buf = torch.div(pts, resolution, rounding_mode="floor")
    p = (pts - center).to(torch.float32)
    valid = mask & in_window(buf, pos, size, 1)
    a = [torch.where(valid, i, torch.zeros_like(i)).long()
         for i in _box_index(buf, box_lo)]
    vw = vw_p[a[0], a[1], a[2]]
    valid = valid & (_unpack_hi(vw) != 0)
    gxy = gxy_p[a[0], a[1], a[2]]
    gz = gz_p[a[0], a[1], a[2]]
    grad = torch.stack([_unpack_lo(gxy), _unpack_hi(gxy), _unpack_lo(gz)],
                       dim=-1).to(torch.float32)
    vf = valid.to(torch.float32)
    Js = torch.cat([cross(p, grad) * _SC, grad * _SG], dim=-1) * vf[:, None]
    v = _unpack_lo(vw).to(torch.float32) * vf
    return _normal_equations(Js, v, vf, dtype)


def _normal_equations(Js, r, vfm, dtype):
    """One row [H (36), g (6), e, c] of float32 statistics."""
    if dtype != torch.float32:
        Js, r = Js.to(dtype), r.to(dtype)
    H = (Js.T @ Js).float()
    g = (Js.T @ r).float()
    return torch.cat([H.reshape(36), g,
                      torch.sum(torch.abs(r)).float().reshape(1),
                      torch.sum(vfm).reshape(1)])


F = np.float32


def solve6(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """6x6 float32 solve by LU with partial pivoting (first row of
    largest |pivot|); a zero pivot gives NaN.  numpy float32, every
    operation rounded once, as the program's step orders them."""
    A = np.array(A, dtype=F)
    b = np.array(b, dtype=F)
    singular = False
    for k in range(6):
        p, best = k, abs(A[k, k])
        for r in range(k + 1, 6):
            if abs(A[r, k]) > best:
                best, p = abs(A[r, k]), r
        if p != k:
            A[[k, p]] = A[[p, k]]
            b[[k, p]] = b[[p, k]]
        piv = A[k, k]
        singular |= bool(piv == 0)
        if k < 5:
            with np.errstate(divide="ignore", invalid="ignore"):
                f = A[k + 1:, k] / piv
            A[k + 1:, k + 1:] = A[k + 1:, k + 1:] - f[:, None] * A[k, k + 1:]
            b[k + 1:] = b[k + 1:] - f * b[k]
    y = np.empty(6, dtype=F)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for r in range(5, -1, -1):
            acc = b[r]
            for j in range(r + 1, 6):
                acc = F(acc - A[r, j] * y[j])
            y[r] = acc / A[r, r]
    return np.full(6, np.nan, dtype=F) if singular else y


def xi_to_transform(xi: np.ndarray, center: np.ndarray,
                    P: np.ndarray) -> np.ndarray:
    """``exp(xi) about center @ P`` in float32, products written out,
    sqrt, sin and cos rounded once from float64."""
    a = xi[:3]
    th2 = F(F(a[0] * a[0] + a[1] * a[1]) + a[2] * a[2])
    theta = F(np.sqrt(np.float64(th2)))
    eye = np.eye(3, dtype=F)
    if theta < F(1e-12):
        R = eye
    else:
        u = a / theta
        z = F(0.0)
        L = np.array([[z, -u[2], u[1]], [u[2], z, -u[0]],
                      [-u[1], u[0], z]], dtype=F)
        LL = (L[:, 0:1] * L[0:1, :] + L[:, 1:2] * L[1:2, :]) \
            + L[:, 2:3] * L[2:3, :]
        sn = F(np.sin(np.float64(theta)))
        c1 = F(F(1.0) - F(np.cos(np.float64(theta))))
        R = (eye + sn * L) + c1 * LL
    rc = (R[:, 0] * -center[0] + R[:, 1] * -center[1]) + R[:, 2] * -center[2]
    T = np.zeros((4, 4), dtype=F)
    T[:3, :3] = R
    T[:3, 3] = (rc + center) + xi[3:]
    T[3, 3] = F(1.0)
    return ((T[:, 0:1] * P[0:1, :] + T[:, 1:2] * P[1:2, :])
            + T[:, 2:3] * P[2:3, :]) + T[:, 3:4] * P[3:4, :]


def _unpack_stats(row: torch.Tensor):
    """(H 6x6, g 6, e, c) float32 numpy from one row [H, g, e, c] read
    back in a single copy."""
    r = row.cpu().numpy()
    return r[:36].reshape(6, 6), r[36:42], r[42], r[43]


def register_lm(stats, pretransform, *, max_iterations, epsilon,
                freeze_step_mm):
    """The fast adaptive Levenberg-Marquardt loop: ``stats(total, gather)``
    gives the row [H, g, e, c] at a trial pose (4x4 float32 numpy);
    accept or reject against the accepted error, alpha / 3 or * 4 in
    [1e-5, 1e5], the Marquardt-damped solve, stop on a tiny accepted step,
    the 4-error window or a non-finite step, and freeze the gather below
    one voxel's step.  Returns (pose 4x4 float32, iterations, error)."""
    P = np.asarray(pretransform, dtype=F).reshape(4, 4)
    acc, trial = P.copy(), P.copy()
    accH = np.eye(6, dtype=F)
    accg = np.zeros(6, dtype=F)
    acc_err = F(np.inf)
    alpha = F(1e-3)
    prev = np.full(4, np.inf, dtype=F)
    frozen = False
    eps = F(epsilon)
    D = np.array([_SCP] * 3 + [1.0] * 3, dtype=F)
    d = np.arange(6)
    i = 0
    while i < max_iterations:
        H, g, e, c = _unpack_stats(stats(trial, not frozen))
        err = F(e / max(c, F(1.0))) if c > F(0.0) else F(np.inf)
        improved = bool(err <= acc_err)
        err2 = min(err, acc_err)
        if improved:
            acc, accH, accg = trial.copy(), H.copy(), g.copy()
        alpha = F(alpha / F(3.0)) if improved else F(alpha * F(4.0))
        alpha = min(max(alpha, F(1e-5)), F(1e5))
        A = accH.copy()
        A[d, d] = accH[d, d] + alpha * (accH[d, d] + F(1e-12))
        y = solve6(A, -accg)
        ok = bool(np.isfinite(err2)) and bool(np.all(np.isfinite(y)))
        xi = D * y if ok else np.zeros(6, dtype=F)
        trial = xi_to_transform(xi, np.trunc(acc[:3, 3]), acc)
        rot2 = F(F(xi[0] * xi[0] + xi[1] * xi[1]) + xi[2] * xi[2])
        tr2 = F(F(xi[3] * xi[3] + xi[4] * xi[4]) + xi[5] * xi[5])
        tiny = improved and rot2 < F(1e-7) and tr2 < F(0.25)
        window = (abs(F(err2 - prev[2])) < eps
                  and abs(F(err2 - prev[0])) < eps)
        if improved and tr2 < F(freeze_step_mm ** 2) and rot2 < F(1e-6):
            frozen = True
        prev = np.concatenate([prev[1:], np.array([err2], dtype=F)])
        acc_err = err2
        i += 1
        if tiny or window or not ok:
            break
    return acc, i, float(acc_err)


def register_gn(stats, pretransform, *, max_iterations, epsilon,
                it_weight_gradient):
    """The parity Gauss-Newton loop: (H + alpha c D^2) y = -g, xi = D y,
    the update about the initial translation, alpha += the ramp, stop on
    the 4-error window or an empty system.  Returns (pose, iterations)."""
    P = np.asarray(pretransform, dtype=F).reshape(4, 4)
    trial = P.copy()
    center = np.trunc(P[:3, 3])
    alpha = F(0.0)
    prev = np.zeros(4, dtype=F)
    eps = F(epsilon)
    D = np.array([_SC] * 3 + [_SG] * 3, dtype=F)
    DD = D * D
    d = np.arange(6)
    i = 0
    while i < max_iterations:
        H, g, e, c = _unpack_stats(stats(trial))
        empty = bool(c <= F(0.0))
        if empty:
            A = np.eye(6, dtype=F)
        else:
            A = H.copy()
            A[d, d] = H[d, d] + F(alpha * c) * DD
        y = solve6(A, -g)
        ok = not empty and bool(np.all(np.isfinite(y)))
        if ok:
            trial = xi_to_transform(D * y, center, trial)
        err = F(e / max(c, F(1.0)))
        fin = (ok and abs(F(err - prev[2])) < eps
               and abs(F(err - prev[0])) < eps) or empty
        prev = np.concatenate([prev[1:], np.array([err], dtype=F)])
        alpha = F(alpha + F(it_weight_gradient))
        i += 1
        if fin:
            break
    return trial, i
