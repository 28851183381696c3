"""F-LOAM scan-to-map odometry on tensors.

Counterpart of ``warpsense_tpu/frontends/featsense/odometry.py``
(featsense's ``OdomEstimation`` + Ceres stack, odom_estimation.cpp and
lidar_optimization.cpp):

* the kd-trees become one brute-force 5-NN: a (queries x map) squared-
  distance matmul and an EXACT selection ordered by (distance, index), the
  order of ``jax.lax.top_k`` (ties go to the lowest index);
* per-point Ceres problems become batched closed-form fits (trigonometric
  3x3 eigen-solve for edge lines, adjugate 3x3 solve for planes);
* Ceres' Huber(0.1) LM becomes an IRLS Gauss-Newton over the analytic
  residual Jacobians with the quaternion left-increment update;
* PCL VoxelGrid / CropBox map maintenance becomes sort + segment-mean voxel
  centroids over fixed-capacity masked arrays (the segment sums run in a
  fixed order on the card, ``ops/segment.py``, so a run repeats its bits).

The JAX ``lax.scan``/``lax.cond`` loops are host loops with the same trip
counts; nothing in them syncs with the device.  The JAX host shell slices
the feature maps to power-of-4 buckets of their occupied prefix to bound
recompiles; here the maps are sliced to the occupied prefix itself, which
selects the same neighbours (masked entries are +inf).

Reference quirk kept: the surf map is voxel-filtered at ``edge_resolution``
(odom_estimation.cpp:27-28), overridable via ``surf_leaf``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...core import geometry
from ...core.geometry import cross
from ...ops.segment import segment_sum
from ...utils.device import resolve_device


class FeatureMapState(NamedTuple):
    """Fixed-capacity world-frame feature map (meters), valid entries
    first."""
    points: torch.Tensor   # (CAP, 3) float32
    mask: torch.Tensor     # (CAP,) bool


def empty_map(capacity: int, device="cpu") -> FeatureMapState:
    return FeatureMapState(
        points=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=device))


def _norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False):
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim))


# ------------------------------------------------------------------ primitives

def knn(query: torch.Tensor, map_pts: torch.Tensor, map_mask: torch.Tensor,
        k: int, *, exact: bool = False):
    """Exact brute-force k-NN: (Nq, k) indices and squared distances,
    nearest first, ties to the lowest map index (``jax.lax.top_k`` of the
    negated distances).  Masked map entries are +inf.

    The selection is always exact, so ``exact`` changes nothing: JAX's
    ``knn`` takes the same exact ``top_k`` off a TPU whatever ``exact``
    says, and only on a TPU without ``exact`` its approximate
    ``approx_max_k`` (recall ~0.95), which the port does not copy.

    Selection runs on one int64 key per pair, (float32 distance bits made
    order-preserving) << 32 | index, so ``topk`` has no ties to order."""
    d2 = (torch.sum(query * query, dim=-1)[:, None]
          - 2.0 * query @ map_pts.T
          + torch.sum(map_pts * map_pts, dim=-1)[None, :])
    d2 = torch.where(map_mask[None, :], d2,
                     torch.tensor(float("inf"), device=d2.device))
    bits = (d2 + 0.0).view(torch.int32)          # + 0.0: -0.0 -> +0.0
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.arange(map_pts.shape[0], dtype=torch.int64,
                       device=d2.device)
    key = ordered.to(torch.int64) * (1 << 32) + idx[None, :]
    del exact
    _, pos = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return pos, torch.gather(d2, 1, pos)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve via the adjugate."""
    a00, a01, a02 = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    a10, a11, a12 = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    a20, a21, a22 = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    x = (c00 * b[:, 0] + c10 * b[:, 1] + c20 * b[:, 2]) / det
    y = (c01 * b[:, 0] + c11 * b[:, 1] + c21 * b[:, 2]) / det
    z = (c02 * b[:, 0] + c12 * b[:, 1] + c22 * b[:, 2]) / det
    return torch.stack([x, y, z], dim=-1)


def _det3(b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 determinant by cofactors (JAX takes it through LU; the
    two differ in the last bits)."""
    return (b[:, 0, 0] * (b[:, 1, 1] * b[:, 2, 2] - b[:, 1, 2] * b[:, 2, 1])
            - b[:, 0, 1] * (b[:, 1, 0] * b[:, 2, 2] - b[:, 1, 2] * b[:, 2, 0])
            + b[:, 0, 2] * (b[:, 1, 0] * b[:, 2, 1] - b[:, 1, 1] * b[:, 2, 0]))


def _eigh3_top(cov: torch.Tensor):
    """Closed-form top of the spectrum of batched symmetric 3x3 matrices:
    (lambda_max, lambda_mid, principal unit eigenvector), from the
    trigonometric characteristic-root formula and the columns of
    (A - l2 I)(A - l3 I)."""
    a = cov
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    aq = a - q[:, None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(aq * aq, dim=(-2, -1)) / 6.0,
                               min=1e-30))
    r = torch.clamp(_det3(aq / p[:, None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)                        # max
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0)    # min
    l2 = 3.0 * q - l1 - l3                                   # mid
    c = (a - l2[:, None, None] * eye) @ (a - l3[:, None, None] * eye)
    best = torch.argmax(_norm(c, dim=1), dim=-1)             # column norms
    v = torch.gather(c, 2, best[:, None, None].expand(-1, 3, 1))[..., 0]
    v = v / torch.clamp(_norm(v, keepdim=True), min=1e-20)
    return l1, l2, v


def fit_lines(neighbors: torch.Tensor, ok: torch.Tensor):
    """Edge line fit (odom_estimation.cpp:146-177): (Nq, 5, 3) neighbour
    sets -> (point_a, point_b, valid); valid when lambda_max >
    3 lambda_mid; endpoints center +- 0.1 direction."""
    center = torch.mean(neighbors, dim=1)
    zm = neighbors - center[:, None, :]
    cov = torch.einsum("nki,nkj->nij", zm, zm)
    l1, l2, direction = _eigh3_top(cov)
    valid = ok & (l1 > 3.0 * l2)
    return center + 0.1 * direction, center - 0.1 * direction, valid


def fit_planes(neighbors: torch.Tensor, ok: torch.Tensor):
    """Surf plane fit (odom_estimation.cpp:207-235): solve A n = -1 with a
    relative jitter, gate on the 0.2 m inlier distance.  Returns
    (normal, d, valid)."""
    A = neighbors
    AtA = torch.einsum("nki,nkj->nij", A, A)
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    AtA = AtA + (1e-6 * tr + 1e-9) * torch.eye(3, device=A.device)
    n = _solve3(AtA, -torch.sum(A, dim=1))
    norm = _norm(n)
    safe = torch.clamp(norm, min=1e-12)
    d = 1.0 / safe
    n = n / safe[:, None]
    finite = torch.all(torch.isfinite(n), dim=-1) & torch.isfinite(d)
    n = torch.where(finite[:, None], n, torch.zeros_like(n))
    d = torch.where(finite, d, torch.zeros_like(d))
    resid = torch.abs(torch.einsum("nki,ni->nk", A, n) + d[:, None])
    valid = ok & finite & (norm > 1e-12) & torch.all(resid <= 0.2, dim=1)
    return n, d, valid


def edge_residuals(q, t, pts, point_a, point_b, valid):
    """Point-to-line residual and analytic Jacobian wrt (omega, upsilon)
    (EdgeAnalyticCostFunction, lidar_optimization.cpp:14-45)."""
    lp = geometry.quat_rotate(q, pts) + t
    nu = cross(lp - point_a, lp - point_b)
    de = point_a - point_b
    safe_de = torch.clamp(_norm(de), min=1e-12)
    safe_nu = torch.clamp(_norm(nu), min=1e-12)
    r = _norm(nu) / safe_de
    # dr/dlp = -(nhat x de)^T / |de| =: row / |de|; row^T (-skew(lp)) =
    # (lp x row)^T
    row = -cross(nu / safe_nu[:, None], de)
    J = torch.cat([cross(lp, row), row], dim=-1) / safe_de[:, None]
    # where-mask (not multiply): 0 * NaN from degenerate rows is NaN
    return (torch.where(valid, r, torch.zeros_like(r)),
            torch.where(valid[:, None], J, torch.zeros_like(J)))


def surf_residuals(q, t, pts, normal, d, valid):
    """Point-to-plane residual and analytic Jacobian
    (SurfNormAnalyticCostFunction, lidar_optimization.cpp:56-80)."""
    pw = geometry.quat_rotate(q, pts) + t
    r = torch.sum(normal * pw, dim=-1) + d
    J = torch.cat([cross(pw, normal), normal], dim=-1)
    return (torch.where(valid, r, torch.zeros_like(r)),
            torch.where(valid[:, None], J, torch.zeros_like(J)))


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(r)
    # a tensor numerator: PyTorch evaluates ``scalar / tensor`` as
    # ``tensor.reciprocal() * scalar``, which rounds twice
    return torch.where(a <= delta, torch.ones_like(a),
                       torch.full_like(a, delta) / torch.clamp(a, min=1e-12))


def gn_step(q, t, r, J, delta: float = 0.1, damping: float = 1e-6):
    """One Huber-IRLS Gauss-Newton step on the se3 left increment, on the
    device (no host sync: a singular system solves to non-finite values
    that the count gate or the next step absorbs, as in JAX)."""
    w = _huber_weights(r, delta)
    Jw = J * w[:, None]
    H = Jw.T @ J
    g = Jw.T @ r
    count = torch.sum((torch.sum(torch.abs(J), dim=-1) > 0).to(torch.float32))
    ok = count >= 6.0
    eye6 = torch.eye(6, dtype=torch.float32, device=J.device)
    A = torch.where(ok, H + damping * eye6, eye6)
    dx = torch.where(ok, torch.linalg.solve_ex(A, -g)[0],
                     torch.zeros_like(g))
    dq, dt = geometry.se3_exp(dx)
    # manifold plus (lidar_optimization.cpp:83-98): q <- dq q, t <- dq t + dt
    q_new = geometry.quat_mul(dq, q)
    q_new = q_new / _norm(q_new)
    return q_new, geometry.quat_rotate(dq, t[None, :])[0] + dt


# ------------------------------------------------------------- voxel centroid

def _lexsort(kx, ky, kz) -> torch.Tensor:
    """Stable order by (kx, ky, kz), kx the primary key."""
    order = torch.argsort(kz, stable=True)
    order = order[torch.argsort(ky[order], stable=True)]
    return order[torch.argsort(kx[order], stable=True)]


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf: float,
                     capacity: int):
    """PCL-VoxelGrid-style centroid downsample on fixed-shape arrays
    (downSizeFilterEdge/Surf, odom_estimation.cpp:118-127).  Returns
    (points (capacity, 3), mask (capacity,)), valid first."""
    N = points.shape[0]
    key = torch.floor(points / leaf).to(torch.int32)
    big = torch.tensor(2 ** 24, dtype=torch.int32, device=points.device)
    kx, ky, kz = (torch.where(mask, key[:, i], big) for i in range(3))
    order = _lexsort(kx, ky, kz)
    sk = torch.stack([kx, ky, kz], dim=-1)[order]
    sp = points[order]
    wf = mask[order].to(torch.float32)
    new_group = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=points.device),
                           torch.any(sk[1:] != sk[:-1], dim=-1)])
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    acc = segment_sum(torch.cat([sp * wf[:, None], wf[:, None]], dim=1),
                      gid, N)
    sums, cnts = acc[:, :3], acc[:, 3]
    centroid = sums / torch.clamp(cnts, min=1.0)[:, None]
    vmask = cnts > 0.0
    ordv = torch.argsort((~vmask).to(torch.uint8), stable=True)[:capacity]
    return centroid[ordv], vmask[ordv]


def merge_map(map_state: FeatureMapState, new_pts, new_mask, center, *,
              crop: float, leaf: float) -> FeatureMapState:
    """Append world-frame points, crop +-crop meters around ``center`` and
    voxel-centroid downsample back into the fixed capacity
    (addPointsToMap, odom_estimation.cpp:255-296)."""
    cap = map_state.points.shape[0]
    pts = torch.cat([map_state.points, new_pts])
    msk = torch.cat([map_state.mask, new_mask])
    inside = torch.all(torch.abs(pts - center[None, :]) <= crop, dim=-1)
    p, m = voxel_downsample(pts, msk & inside, leaf, cap)
    return FeatureMapState(points=p, mask=m)


# -------------------------------------------------------------------- solve

def odom_update(edge_map: FeatureMapState, surf_map: FeatureMapState,
                edge_pts, edge_mask, surf_pts, surf_mask, q0, t0,
                opt_count: int, *, inner_iters: int = 4):
    """(re-associate -> ``inner_iters`` GN steps) x ``opt_count`` (at most
    20, the initMapWithPoints bootstrap count, odom_estimation.cpp:46).
    Scan features are in the SENSOR frame, maps in the world frame
    (meters).  Returns the refined (q, t)."""
    q, t = q0, t0
    for _ in range(min(int(opt_count), 20)):
        ew = geometry.quat_rotate(q, edge_pts) + t
        eidx, ed2 = knn(ew, edge_map.points, edge_map.mask, 5)
        pa, pb, e_valid = fit_lines(edge_map.points[eidx],
                                    edge_mask & (ed2[:, 4] < 1.0))
        sw = geometry.quat_rotate(q, surf_pts) + t
        sidx, sd2 = knn(sw, surf_map.points, surf_map.mask, 5)
        nrm, d, s_valid = fit_planes(surf_map.points[sidx],
                                     surf_mask & (sd2[:, 4] < 1.0))
        for _ in range(inner_iters):
            re, Je = edge_residuals(q, t, edge_pts, pa, pb, e_valid)
            rs, Js = surf_residuals(q, t, surf_pts, nrm, d, s_valid)
            q, t = gn_step(q, t, torch.cat([re, rs]), torch.cat([Je, Js]))
    return q, t


# --------------------------------------------------------------- host shell

class OdomEstimation:
    """Host orchestration of the reference class: constant-velocity
    prediction, bootstrap init, the solve, map maintenance.  The pose is
    kept on the host in float64; the maps and the solve live on
    ``device`` (the card unless asked for the CPU; a CUDA device without
    a GPU raises, ``utils.device.resolve_device``)."""

    def __init__(self, *, edge_map_capacity: int = 8192,
                 surf_map_capacity: int = 16384, edge_leaf: float = 0.4,
                 surf_leaf: float | None = None, optimization_steps: int = 3,
                 crop: float = 100.0, inner_iters: int = 4, device="cuda"):
        self.device = resolve_device(device)
        self.edge_leaf = float(edge_leaf)
        self.surf_leaf = float(surf_leaf if surf_leaf is not None
                               else edge_leaf)
        self.optimization_steps = int(optimization_steps)
        self.crop = float(crop)
        self.inner_iters = int(inner_iters)
        self.edge_map = empty_map(edge_map_capacity, self.device)
        self.surf_map = empty_map(surf_map_capacity, self.device)
        self.odom = np.eye(4, dtype=np.float64)
        self.last_odom = np.eye(4, dtype=np.float64)
        self.optimization_count = 2
        self.initialized = False

    @staticmethod
    def _occupied(m: FeatureMapState, n: int) -> FeatureMapState:
        """The valid prefix (voxel_downsample orders valid entries
        first)."""
        return FeatureMapState(points=m.points[:n], mask=m.mask[:n])

    def _pose_qt(self):
        q = geometry.mat_to_quat(torch.as_tensor(self.odom[:3, :3],
                                                 dtype=torch.float32))
        t = torch.as_tensor(self.odom[:3, 3], dtype=torch.float32)
        return q.to(self.device), t.to(self.device)

    def _set_pose(self, q, t):
        self.odom = np.eye(4)
        self.odom[:3, :3] = geometry.quat_to_mat(q).cpu().numpy()
        self.odom[:3, 3] = t.cpu().numpy()

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(x, device=self.device).to(dtype)

    def update(self, edge_pts, edge_mask, surf_pts, surf_mask) -> np.ndarray:
        """One scan of sensor-frame features -> new world pose (4x4
        float64) (updatePointsToMap, odom_estimation.cpp:50-105)."""
        edge_pts, surf_pts = self._tensor(edge_pts), self._tensor(surf_pts)
        edge_mask = self._tensor(edge_mask, torch.bool)
        surf_mask = self._tensor(surf_mask, torch.bool)
        if not self.initialized:
            q, t = self._pose_qt()
            self._absorb(q, t, edge_pts, edge_mask, surf_pts, surf_mask)
            self.optimization_count = 20
            self.initialized = True
            return self.odom.copy()

        if self.optimization_count > self.optimization_steps:
            self.optimization_count -= 1
        # constant-velocity prediction (odom_estimation.cpp:59-61)
        prediction = self.odom @ (np.linalg.inv(self.last_odom) @ self.odom)
        self.last_odom = self.odom.copy()
        self.odom = prediction

        d_edge, m_edge = voxel_downsample(edge_pts, edge_mask, self.edge_leaf,
                                          edge_pts.shape[0])
        d_surf, m_surf = voxel_downsample(surf_pts, surf_mask, self.surf_leaf,
                                          surf_pts.shape[0])
        q, t = self._pose_qt()
        n_edge = int(self.edge_map.mask.sum())
        n_surf = int(self.surf_map.mask.sum())
        if n_edge > 10 and n_surf > 50:
            q, t = odom_update(self._occupied(self.edge_map, n_edge),
                               self._occupied(self.surf_map, n_surf),
                               d_edge, m_edge, d_surf, m_surf, q, t,
                               self.optimization_count,
                               inner_iters=self.inner_iters)
        self._set_pose(q, t)
        self._absorb(q, t, d_edge, m_edge, d_surf, m_surf)
        return self.odom.copy()

    def _absorb(self, q, t, edge_pts, edge_mask, surf_pts, surf_mask):
        self.edge_map = merge_map(
            self.edge_map, geometry.quat_rotate(q, edge_pts) + t, edge_mask,
            t, crop=self.crop, leaf=self.edge_leaf)
        self.surf_map = merge_map(
            self.surf_map, geometry.quat_rotate(q, surf_pts) + t, surf_mask,
            t, crop=self.crop, leaf=self.surf_leaf)
