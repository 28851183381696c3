"""Projective TSDF fusion on tensors.

Counterpart of ``warpsense_tpu/ops/tsdf_projective.py``: the scan becomes a
(columns, channels) beam table (nearest return per beam), every voxel of
the window bins its direction from the scanner into a beam, takes that
beam's endpoint, and the signed distance is folded into the map with the
weighted-average merge (update_tsdf.cu:13-128, re-derived projectively).

The eager sweep here is the plain version of CUDA kernel K1
(``kernels/fusion.py``): bit-exact with the JAX sweep, it walks the window
in x slabs so that a full-size window stays within a few GB of scratch.
Every float constant is a 0-dim float32 tensor made from the same Python
double the JAX code uses, and every expression keeps the JAX evaluation
order, so the float32 arithmetic rounds identically.
"""
from __future__ import annotations

import math
from contextlib import nullcontext

import torch

from ..core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from ..map.local_map import LocalMapState, in_bounds


def dz_per_distance(channels: int = 128, vfov_deg: float = 45.0) -> int:
    """Fixed-point half vertical angular pitch (update_tsdf.cu:49-50)."""
    angle = vfov_deg / channels
    return int(math.tan(angle / 180.0 * math.pi) / 2.0 * MATRIX_RESOLUTION)


def check_fusion_config(tau: int, max_weight: int, vfov_deg: float) -> None:
    """Static guard shared by every projective fusion entry.

    * ``2 * tau * max_weight < 2^24``: the reference's f32-exact merge
      division equals integer division only while the weighted sum stays
      exactly representable in f32; the port divides in integers and keeps
      the same bound so both stay equal.
    * ``vfov_deg <= 90``: ``banded_atan``'s out-of-band rejection only
      covers elevations a +-45-degree band can express."""
    if 2 * int(tau) * int(max_weight) >= (1 << 24):
        raise ValueError(
            f"2*tau*max_weight = {2 * int(tau) * int(max_weight)} >= 2^24: "
            "the f32-exact TSDF merge division would diverge from the "
            "integer reference (lower map.max_weight or max_distance)")
    if vfov_deg > 90.0:
        raise ValueError(
            f"vfov_deg = {vfov_deg} > 90: the banded-atan ring binning is "
            "only correct for vertical FOVs up to 90 degrees")


# ----------------------------------------------------------- shared angles
# Odd degree-13 polynomial for atan over [-1, 1], shared with the kernels
# (|err| < 3.8e-7 rad, far below the ring bin half-width).

_ATAN_COEFFS = (
    0.9999983562999126, -0.3332313212264718, 0.1985179587326387,
    -0.13379591763197257, 0.08200914681344318, -0.0354820989980964,
    0.0073824108965324904)

# voxels the plain sweep processes at once: its float32/int32 temporaries
# are sized by this slab, not by the whole window
_SLAB_VOXELS = 1 << 22


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python double rounded to a 0-dim float32 tensor (JAX weak-type
    promotion rounds the same way)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt.  PyTorch's vectorised CPU float32
    sqrt is not (it misses the nearest float for ~0.6% of inputs); a double
    sqrt rounded to float32 is (53 >= 2 * 24 + 2 bits), on every device."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def banded_atan(t: torch.Tensor) -> torch.Tensor:
    """atan(t) for |t| <= 1 (Horner); outside the band the raw polynomial
    blows up monotonically, so |elevation| > 45 deg is rejected exactly
    like a full atan would be."""
    s = t * t
    p = _f32(_ATAN_COEFFS[-1], t)
    for c in reversed(_ATAN_COEFFS[:-1]):
        p = p * s + _f32(c, t)
    return p * t


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Polynomial atan2 (f32), quadrant-correct; (0, 0) -> 0."""
    ax_, ay_ = torch.abs(x), torch.abs(y)
    hi = torch.maximum(torch.maximum(ax_, ay_), _f32(1e-20, x))
    t = torch.minimum(ax_, ay_) / hi
    p = banded_atan(t)
    r = torch.where(ay_ > ax_, _f32(math.pi / 2, x) - p, p)
    r = torch.where(x < 0, _f32(math.pi, x) - r, r)
    return torch.where(y < 0, -r, r)


# ------------------------------------------------------------- beam table

def build_beam_table(points: torch.Tensor, mask: torch.Tensor,
                     scanner_mm: torch.Tensor, R_sensor: torch.Tensor, *,
                     channels: int, columns: int, vfov_deg: float):
    """Scan -> nearest-return beam table.

    points: (N, 3) int32 mm (map frame); R_sensor: 3x3 f32 sensor->map.
    Returns (range_mm (columns*channels,) f32 with +inf holes,
    endpoint (columns*channels, 3) f32 mm).

    ``arctan2``/``arcsin`` are library calls whose last bit may differ
    between frameworks; callers that need two sweeps to agree build the
    table once and hand both the same one."""
    dev = points.device
    p = (points - scanner_mm).to(torch.float32)
    R = R_sensor.to(torch.float32)
    # d = p @ R, as explicit products (no library matmul)
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

    # nearest return per beam: scatter-min of (range/8mm << 17 | point
    # index) into a table one slot longer; the extra slot takes the
    # dropped points (the JAX scatter's mode="drop") and is sliced off
    n = points.shape[0]
    assert n < (1 << 17), "beam table supports at most 128K points"
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
    rng_tab = torch.where(hit, norm, torch.full_like(norm, math.inf))
    return rng_tab, endpoint


def beam_rows(rng_tab, endpoint, scanner_mm, *, columns: int):
    """Plain version of kernel K1's prepare step: the (columns*channels, 4)
    float32 rows (bx, by, bz, range), the endpoint relative to the scanner
    (the f32 subtraction the sweep does; a hole's endpoint is 0) beside the
    beam's range (+inf at a hole), and the (columns,) largest finite range
    of each azimuth column (-inf where it has none)."""
    rel = endpoint - scanner_mm.to(torch.float32)
    beams = torch.cat([rel, rng_tab[:, None]], dim=1)
    rows = rng_tab.reshape(columns, -1)
    rowmax = torch.where(torch.isfinite(rows), rows,
                         _f32(-math.inf, rows)).amax(dim=1)
    return beams, rowmax


# --------------------------------------------------------- projective sweep

def _global_coords(pos, offset, size):
    """Per-axis global voxel coordinates in ARRAY order (ring-aware:
    global = pos + ((a - offset + s/2) mod s) - s/2)."""
    out = []
    for ax in range(3):
        s = size[ax]
        a = torch.arange(s, dtype=torch.int32, device=pos.device)
        out.append(pos[ax] + torch.remainder(a - offset[ax] + s // 2, s)
                   - s // 2)
    return out


def relative_coords(pos, offset, size, scanner_mm, resolution):
    """Per-axis voxel-center coordinates relative to the scanner (f32 mm,
    array order): the separable inputs of the sweep and of kernel K1."""
    g = _global_coords(pos, offset, size)
    return [(g[ax] * resolution + resolution // 2 - scanner_mm[ax]).to(
        torch.float32) for ax in range(3)]


def _sensor_direction(cx, cy, cz, rotation):
    """The broadcast voxel offsets (x, y, z), the sensor-frame direction
    d_s = R^T d built from separable parts, its rho2 and its length r_vox."""
    R = rotation.to(torch.float32)
    x = cx[:, None, None]
    y = cy[None, :, None]
    z = cz[None, None, :]
    dsx = x * R[0, 0] + y * R[1, 0] + z * R[2, 0]
    dsy = x * R[0, 1] + y * R[1, 1] + z * R[2, 1]
    dsz = x * R[0, 2] + y * R[1, 2] + z * R[2, 2]
    rho2 = dsx * dsx + dsy * dsy
    return x, y, z, dsx, dsy, dsz, rho2, _sqrt(rho2 + dsz * dsz)


def _bins(cx, cy, cz, rotation, *, channels, columns, vfov_deg):
    """Each voxel's broadcast offsets (x, y, z), its length r_vox and its
    beam bin: the float ring and column (ringf, colf) and their integers
    (ring, unclamped; col, floor mod ``columns``)."""
    x, y, z, dsx, dsy, dsz, rho2, r_vox = _sensor_direction(cx, cy, cz,
                                                            rotation)
    az = atan2_poly(dsy, dsx)
    inv_rho = _f32(1.0, cx) / torch.maximum(_sqrt(rho2),
                                            _f32(1e-20, cx))
    el = banded_atan(dsz * inv_rho)
    spacing = math.radians(vfov_deg) / (channels - 1)
    half_v = math.radians(vfov_deg) / 2.0
    ringf = torch.clamp((_f32(half_v, cx) - el) * _f32(1.0 / spacing, cx),
                        -1e4, 1e4)
    ring = torch.round(ringf).to(torch.int32)
    colf = (az + _f32(math.pi, cx)) * _f32(columns / (2 * math.pi), cx)
    col = torch.remainder(torch.round(colf).to(torch.int32), columns)
    return x, y, z, r_vox, ringf, ring, colf, col


def _acceptance(r_vox, ringf, ring, colf, *, resolution, channels, columns,
                vfov_deg):
    """The beam-free acceptance tests: (v_res, vertical_ok,
    horizontal_ok).  Vertical: the ring-interpolation band; horizontal: the
    ray's own cell footprint (update_tsdf.cu:101-125)."""
    f = r_vox
    spacing = math.radians(vfov_deg) / (channels - 1)
    dzpd = dz_per_distance(channels, vfov_deg)
    delta_z = _f32(dzpd, f) * r_vox * _f32(1.0 / MATRIX_RESOLUTION, f)
    v_res = r_vox * torch.abs(ringf - ring.to(torch.float32)) \
        * _f32(spacing, f)
    half_res = _f32(resolution * 0.5, f)
    vertical_ok = v_res <= torch.maximum(delta_z, half_res)
    col_res = torch.abs(colf - torch.round(colf))
    h_res = r_vox * col_res * _f32(2 * math.pi / columns, f)
    return v_res, vertical_ok, h_res <= half_res


def projective_sweep_coords(cx, cy, cz, rng_tab, endpoint, scanner_mm,
                            rotation, *, tau, resolution, channels, columns,
                            vfov_deg):
    """The sweep over a box of voxels given by per-axis scanner-relative
    coordinates (f32 mm; any x slice of the window).  Returns the (new
    value, new weight) int32 planes of shape (len(cx), len(cy), len(cz)).

    (The JAX function takes global voxel coordinates; ``relative_coords``
    computes the same f32 values from them.)"""
    beams, _ = beam_rows(rng_tab, endpoint, scanner_mm, columns=columns)
    return _sweep_rows(cx, cy, cz, beams, rotation, tau=tau,
                       resolution=resolution, channels=channels,
                       columns=columns, vfov_deg=vfov_deg)


def _sweep_rows(cx, cy, cz, beams, rotation, *, tau, resolution, channels,
                columns, vfov_deg):
    """``projective_sweep_coords`` on the prepared rows ``beams``
    (``beam_rows``): each voxel gathers its beam's relative endpoint and
    range."""
    x, y, z, r_vox, ringf, ring, colf, col = _bins(
        cx, cy, cz, rotation, channels=channels, columns=columns,
        vfov_deg=vfov_deg)
    ring_ok = (ring >= 0) & (ring < channels)
    ring_c = torch.clamp(ring, 0, channels - 1)

    flat = (col * channels + ring_c).to(torch.int64)
    bx, by, bz, r_beam = (beams[:, k][flat] for k in range(4))
    shape = r_vox.shape
    return _projective_math(
        x.expand(shape), y.expand(shape), z.expand(shape), r_vox, ringf,
        ring, ring_ok, colf, r_beam, bx, by, bz, tau=tau,
        resolution=resolution, channels=channels, columns=columns,
        vfov_deg=vfov_deg)


def _projective_math(dx, dy, dz, r_vox, ringf, ring, ring_ok, colf, r_beam,
                     bx, by, bz, *, tau, resolution, channels, columns,
                     vfov_deg):
    """Per-voxel fusion math; positions relative to the scanner (mm, f32).
    Returns (value, weight) int32 planes."""
    weight_epsilon = tau // 10
    f = r_vox

    # Euclidean distance voxel-center -> beam endpoint (the march's value)
    ex, ey, ez = dx - bx, dy - by, dz - bz
    value = _sqrt(ex * ex + ey * ey + ez * ez)
    value = torch.minimum(value, _f32(float(tau), f))
    value = torch.where(r_vox > r_beam, -value, value)

    v_res, vertical_ok, horizontal_ok = _acceptance(
        r_vox, ringf, ring, colf, resolution=resolution, channels=channels,
        columns=columns, vfov_deg=vfov_deg)
    interp = v_res > _f32(resolution * 0.5, f)           # off-ray band
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


def _merge_planes(ev, ew, new_v, new_w, max_weight):
    """Elementwise weighted-averaging merge on int32 planes (parity
    cu_avg_tsdf_krnl, update_tsdf.cu:13-43).  Returns (value, weight).
    Integer trunc division equals the JAX f32-exact division below the
    ``check_fusion_config`` bound."""
    avg_case = (new_w > 0) & (ew > 0)
    over_case = (new_w != 0) & (ew <= 0)
    den = torch.where(avg_case, ew + new_w, torch.ones_like(ew))
    avg_v = torch.div(ev * ew + new_v * new_w, den, rounding_mode="trunc")
    out_v = torch.where(avg_case, avg_v, torch.where(over_case, new_v, ev))
    out_w = torch.where(avg_case, torch.clamp(ew + new_w, max=max_weight),
                        torch.where(over_case, new_w, ew))
    return out_v, out_w


def sweep_rows_plain(value, weight, cx, cy, cz, beams, rotation, *, tau,
                     max_weight, resolution, channels, columns,
                     vfov_deg) -> None:
    """Plain version of K1's sweep on the prepared rows ``beams``: sweep +
    merge, IN PLACE on the int16 planes, x slab by x slab (at most
    ``_SLAB_VOXELS`` voxels of scratch at once)."""
    X, Y, Z = value.shape
    step = max(1, _SLAB_VOXELS // (Y * Z))
    for x0 in range(0, X, step):
        sl = slice(x0, min(X, x0 + step))
        nv, nw = _sweep_rows(
            cx[sl], cy, cz, beams, rotation, tau=tau, resolution=resolution,
            channels=channels, columns=columns, vfov_deg=vfov_deg)
        ov, ow = _merge_planes(value[sl].to(torch.int32),
                               weight[sl].to(torch.int32), nv, nw,
                               max_weight)
        value[sl] = ov.to(torch.int16)
        weight[sl] = ow.to(torch.int16)


def z_rotation(cz: torch.Tensor) -> int:
    """Array index of the lowest global z: ``relative_coords`` gives ``cz``
    as ascending global z rotated by the window's ring offset."""
    return int(torch.argmin(cz))


def column_z_limits(cx, cy, cz, rng_tab, *, tau, resolution, channels,
                    columns):
    """Plain model of kernel K1's exact cull in the level sweep (R = I).

    A voxel can pass the sweep's ``ok`` only where its beam range is finite,
    ``r_vox <= range + tau`` and ``r_vox * col_res * colstep <= half_res``.
    Per (x, y) column, with ``m`` the largest finite range of the column's
    beam row, ``keep(dz) = r_vox <= m + tau and h_res <= half_res`` is a
    necessary condition that holds on one run of ascending global z (each
    float32 operation is monotone; see csrc/fusion.cu).  The run's ends are
    found by binary search with the sweep's own float32 expressions.

    Returns ``(skip, lo, hi, rot)``: ``skip`` (X, Y) bool, the row holds no
    finite range; ``lo``, ``hi`` (X, Y) int64, the run ``[lo, hi)`` of
    global z ranks (empty where ``skip``); ``rot``, the array index of global
    rank 0 (rank ``j`` lies at array index ``(j + rot) % Z``)."""
    X, Y, Z = len(cx), len(cy), len(cz)
    x = cx[:, None]
    y = cy[None, :]
    rho2 = x * x + y * y
    colf = (atan2_poly(y, x) + _f32(math.pi, cx)) \
        * _f32(columns / (2 * math.pi), cx)
    col = torch.remainder(torch.round(colf).to(torch.int32), columns)
    col_res = torch.abs(colf - torch.round(colf))
    rows = rng_tab.reshape(columns, channels)
    rmax = torch.where(torch.isfinite(rows), rows,
                       _f32(-math.inf, cx)).amax(dim=1)[col.to(torch.int64)]
    skip = ~torch.isfinite(rmax)
    lim = rmax + _f32(float(tau), cx)
    colstep = _f32(2 * math.pi / columns, cx)
    half_res = _f32(resolution * 0.5, cx)
    rot = z_rotation(cz)
    zg = torch.roll(cz, -rot)              # zg[j] = cz[(j + rot) % Z]

    def keep(j):
        dz = zg[j]
        r_vox = _sqrt(rho2 + dz * dz)
        return (r_vox <= lim) & (r_vox * col_res * colstep <= half_res)

    def first(lo, hi, pred):
        # first index in [lo, hi) where the monotone pred holds, else hi
        lo = torch.full((X, Y), lo, dtype=torch.int64, device=cx.device)
        hi = torch.full((X, Y), hi, dtype=torch.int64, device=cx.device)
        for _ in range(Z.bit_length()):
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            live = lo < hi
            p = pred(torch.clamp(mid, max=Z - 1)) & live
            hi = torch.where(p, mid, hi)
            lo = torch.where(live & ~p, mid + 1, lo)
        return hi

    mid = int((zg < 0).sum())              # ranks of dz < 0 come first
    lo = first(0, mid, keep)
    hi = first(mid, Z, lambda j: ~keep(j))
    return skip, lo, hi, rot


# the general sweep's early-outs, in its order (general_rejects)
GENERAL_STAGES = ("range", "ring", "vertical", "horizontal", "beam")


def general_rejects(cx, cy, cz, rng_tab, rotation, *, tau, resolution,
                    channels, columns, vfov_deg):
    """Plain model of the early-outs of kernel K1's general sweep.

    Returns, for each voxel ((X, Y, Z) int8, array order), the stage at
    which the sweep leaves it: ``k + 1`` for ``GENERAL_STAGES[k]``, or 0 for
    a voxel that passes every stage and reaches the value's math.  Each
    stage tests a necessary condition of the sweep's ``ok``, in the
    kernel's order (csrc/fusion.cu):

    1. range: ``r_vox <= M + tau``, M the table's largest finite range
       (any finite beam range is at most M, and rounding is monotone);
    2. ring: ``ring_ok``;
    3. vertical: ``vertical_ok``;
    4. horizontal: ``horizontal_ok``;
    5. beam: the voxel's beam range is finite and ``r_vox <= range + tau``.

    Each expression is the sweep's own (``_bins``, ``_acceptance``)."""
    X, Y, Z = len(cx), len(cy), len(cz)
    kw = dict(channels=channels, columns=columns, vfov_deg=vfov_deg)
    tau_f = _f32(float(tau), cx)
    finite = rng_tab[torch.isfinite(rng_tab)]
    lim = (finite.max() if finite.numel() else _f32(-math.inf, cx)) + tau_f
    out = torch.empty((X, Y, Z), dtype=torch.int8, device=cx.device)
    step = max(1, _SLAB_VOXELS // (Y * Z))
    for x0 in range(0, X, step):
        sl = slice(x0, min(X, x0 + step))
        _, _, _, r_vox, ringf, ring, colf, col = _bins(cx[sl], cy, cz,
                                                        rotation, **kw)
        _, vertical_ok, horizontal_ok = _acceptance(
            r_vox, ringf, ring, colf, resolution=resolution, **kw)
        r_beam = rng_tab[(col * channels
                          + torch.clamp(ring, 0, channels - 1)).to(
                              torch.int64)]
        passes = (r_vox <= lim, (ring >= 0) & (ring < channels), vertical_ok,
                  horizontal_ok,
                  torch.isfinite(r_beam) & (r_vox <= r_beam + tau_f))
        stage = torch.zeros(r_vox.shape, dtype=torch.int8, device=cx.device)
        for k in reversed(range(len(passes))):       # the first failure wins
            stage = torch.where(passes[k], stage,
                                torch.full_like(stage, k + 1))
        out[sl] = stage
    return out


def fusion_work(cx, cy, cz, rng_tab, endpoint, scanner_mm, rotation, *,
                level, tau, resolution, channels, columns, vfov_deg) -> dict:
    """What one K1 call has to do on these inputs, for its bound: the
    window's voxels and columns, ``fused_voxels`` (those whose ``ok``
    holds: the only ones whose map entries are read and written),
    ``swept_voxels`` (those that run the per-voxel math: inside
    ``column_z_limits``' runs for the level sweep, all of them otherwise),
    ``ranged_voxels`` (those whose ``r_vox`` is within tau of the
    table's largest finite range, a necessary condition of ``ok`` that
    needs no beam: the others are rejected by their length alone) and
    ``left_at``, the general sweep's voxels by the stage at which it
    leaves them (``general_rejects``; "none": they reach the value's
    math)."""
    X, Y, Z = len(cx), len(cy), len(cz)
    kw = dict(tau=tau, resolution=resolution, channels=channels,
              columns=columns, vfov_deg=vfov_deg)
    step = max(1, _SLAB_VOXELS // (Y * Z))
    fused = 0
    stages = torch.zeros(len(GENERAL_STAGES) + 1, dtype=torch.int64)
    for x0 in range(0, X, step):
        sl = slice(x0, x0 + step)
        fused += int((projective_sweep_coords(
            cx[sl], cy, cz, rng_tab, endpoint, scanner_mm, rotation,
            **kw)[1] != 0).sum())
        stages += torch.bincount(general_rejects(
            cx[sl], cy, cz, rng_tab, rotation, **kw).reshape(-1).to(
                torch.int64), minlength=len(stages)).cpu()
    swept = X * Y * Z
    if level:
        _, lo, hi, _ = column_z_limits(cx, cy, cz, rng_tab, tau=tau,
                                       resolution=resolution,
                                       channels=channels, columns=columns)
        swept = int((hi - lo).sum())
    left_at = dict(zip(("none", *GENERAL_STAGES), stages.tolist()))
    return dict(voxels=X * Y * Z, columns=X * Y, fused_voxels=fused,
                swept_voxels=swept,
                ranged_voxels=X * Y * Z - left_at["range"], left_at=left_at)


def fusion_inputs(state: LocalMapState, points, points_mask, scanner_pos,
                  rotation, *, size, tau, resolution, channels, columns,
                  vfov_deg, x_rows: tuple[int, int] | None = None):
    """Everything the sweep reads besides the map: (rng_tab, endpoint,
    scanner_mm, cx, cy, cz).  The march drops whole rays whose endpoint
    falls outside the window grown by tau/2 (update_tsdf.cu:69-75); the
    beam table gates points identically.  ``x_rows=(lo, hi)``: the state
    holds only the window's array x-rows [lo, hi) (one rank's slab of the
    multi-GPU layer), and ``cx`` covers those rows.  ``scanner_pos``: the
    scanner's voxel, a tensor or three ints."""
    _check_rows(state, size, x_rows)
    return _table_inputs(points, points_mask, state.pos, state.offset,
                         scanner_pos, rotation, size=size, tau=tau,
                         resolution=resolution, channels=channels,
                         columns=columns, vfov_deg=vfov_deg, x_rows=x_rows)


def _check_rows(state: LocalMapState, size, x_rows) -> None:
    """Raise where the state's planes are not the array x rows [lo, hi) of
    ``size`` (all of them without ``x_rows``)."""
    lo, hi = (0, size[0]) if x_rows is None else x_rows
    if tuple(state.value.shape) != (hi - lo, *size[1:]):
        raise ValueError(f"state shape {tuple(state.value.shape)} != "
                         f"rows [{lo}, {hi}) of size {tuple(size)}")


def _table_inputs(points, points_mask, pos, offset, scanner_pos, rotation,
                  *, size, tau, resolution, channels, columns, vfov_deg,
                  x_rows):
    """``fusion_inputs`` for the window centered at ``pos`` with ring
    ``offset``."""
    lo, hi = (0, size[0]) if x_rows is None else x_rows
    scanner_mm = torch.as_tensor(scanner_pos, dtype=torch.int32,
                                 device=points.device) * resolution \
        + resolution // 2
    cell = torch.div(points, resolution, rounding_mode="floor")
    points_mask = points_mask & in_bounds(cell, pos, size,
                                          -(tau // resolution // 2))
    rng_tab, endpoint = build_beam_table(
        points, points_mask, scanner_mm, rotation, channels=channels,
        columns=columns, vfov_deg=vfov_deg)
    cx, cy, cz = relative_coords(pos, offset, size, scanner_mm, resolution)
    return rng_tab, endpoint, scanner_mm, cx[lo:hi], cy, cz


def fusion_table_plain(points, points_mask, pos, offset, scanner_pos,
                       rotation, *, size, tau, resolution, channels, columns,
                       vfov_deg, x_rows: tuple[int, int] | None = None):
    """Plain version of the fusion's table step (``kernels/fusion.py``
    ``fusion_table``): (beams, rowmax, cx, cy, cz), the rows and maxima of
    ``beam_rows`` on ``fusion_inputs``' table and its coordinates, for the
    window centered at ``pos`` with ring ``offset``."""
    rng_tab, endpoint, scanner_mm, cx, cy, cz = _table_inputs(
        points, points_mask, pos, offset, scanner_pos, rotation, size=size,
        tau=tau, resolution=resolution, channels=channels, columns=columns,
        vfov_deg=vfov_deg, x_rows=x_rows)
    beams, rowmax = beam_rows(rng_tab, endpoint, scanner_mm, columns=columns)
    return beams, rowmax, cx, cy, cz


def tsdf_update_projective(state: LocalMapState, points: torch.Tensor,
                           points_mask: torch.Tensor, scanner_pos,
                           rotation: torch.Tensor, *,
                           size: tuple[int, int, int], tau: int,
                           max_weight: int, resolution: int,
                           channels: int = 128, columns: int = 1024,
                           vfov_deg: float = 45.0,
                           level: bool = False,
                           evaluator=None,
                           x_rows: tuple[int, int] | None = None
                           ) -> LocalMapState:
    """One projective fusion step, IN PLACE on ``state.value`` /
    ``state.weight`` (the JAX function donates ``state`` instead); returns
    the same state for call-chaining.

    scanner_pos: the scanner's VOXEL coords, three ints (a tensor on the
    card is read back, a sync: the app hands host ints); rotation: 3x3 f32
    sensor->map (kept on the CPU).  ``level=True`` requires the identity
    rotation and runs K1's level sweep on the card (bit-identical to the
    general one at R = I).  A CUDA state runs the table step and kernel
    K1; a CPU state runs their plain versions.  ``x_rows=(lo, hi)``: the
    state holds only the window's array x rows [lo, hi) (a rank's slab).
    ``evaluator``: an ``obs.profiler.RuntimeEvaluator`` that times the two
    parts as spans, "tsdf.table" (the table step: the beam rows and the
    sweep's coordinates, ``kernels/fusion.fusion_table``) and "tsdf.sweep"
    (K1, level or general, on those rows)."""
    from ..kernels.fusion import fusion_sweep_merge, fusion_table

    check_fusion_config(tau, max_weight, vfov_deg)
    _check_rows(state, size, x_rows)
    kw = dict(tau=tau, resolution=resolution, channels=channels,
              columns=columns, vfov_deg=vfov_deg)
    with _span(evaluator, "tsdf.table"):
        beams, rowmax, cx, cy, cz = fusion_table(
            points, points_mask, state.pos, state.offset, scanner_pos,
            rotation, size=size, x_rows=x_rows, **kw)
    with _span(evaluator, "tsdf.sweep"):
        fusion_sweep_merge(state.value, state.weight, cx, cy, cz, beams,
                           rowmax, rotation, max_weight=max_weight,
                           level=level, **kw)
    return state


def _span(evaluator, task: str):
    return nullcontext() if evaluator is None else evaluator.span(task)
