"""Voxelized GICP (VGICP) refinement on tensors.

Counterpart of ``warpsense_tpu/frontends/featsense/vgicp.py`` (the
``FastVGICP`` refinement the reference wraps, vgicp.h:22-81):

* both clouds are voxelized at ``resolution``; each voxel keeps a mean and
  a plane-regularized covariance (eigenvalues -> (1e-3, 1, 1)).  Voxel
  tables are sorted int32 key arrays and lookup is ``torch.searchsorted``;
* each source point associates with the target voxel containing its
  transformed position (DIRECT1);
* the distribution-to-distribution Mahalanobis Gauss-Newton runs a fixed
  ``max_iterations`` on the device, with no host sync;
* above ``fitness_score_threshold`` the transform falls back to the
  identity (vgicp.h:59-63).

Keys bound the world to +-``KEY_RANGE`` voxels around the source centroid.
A voxel with fewer than three points has a degenerate covariance whose
eigenvectors are not unique, so its regularized covariance depends on the
eigensolver: there the port and JAX can differ.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...core import geometry
from ...ops.segment import segment_sum

KEY_BITS = 10
KEY_RANGE = 1 << (KEY_BITS - 1)          # +-512 voxels around the origin
_KEY_INVALID = 2 ** 30


class VoxelTable(NamedTuple):
    keys: torch.Tensor   # (V,) int32 ascending, invalid = _KEY_INVALID
    mean: torch.Tensor   # (V, 3) float32
    cov: torch.Tensor    # (V, 3, 3) float32, plane-regularized where mask
    mask: torch.Tensor   # (V,) bool


def _pack_keys(points, mask, origin, resolution: float) -> torch.Tensor:
    cell = torch.floor((points - origin) / resolution).to(torch.int32) \
        + KEY_RANGE
    ok = mask & torch.all((cell >= 0) & (cell < 2 * KEY_RANGE), dim=-1)
    key = (cell[:, 0] << (2 * KEY_BITS)) | (cell[:, 1] << KEY_BITS) \
        | cell[:, 2]
    return torch.where(ok, key, torch.full_like(key, _KEY_INVALID))


def _regularize(cov: torch.Tensor) -> torch.Tensor:
    """Plane regularization: eigenvalues -> (1e-3, 1, 1), ascending."""
    _, v = torch.linalg.eigh(cov)
    w_reg = torch.tensor([1e-3, 1.0, 1.0], dtype=cov.dtype,
                         device=cov.device)
    return torch.einsum("...ij,j,...kj->...ik", v, w_reg, v)


def build_voxel_table(points, mask, origin, resolution: float) -> VoxelTable:
    """Sorted voxel distribution table from a (N, 3) masked cloud."""
    N = points.shape[0]
    dev = points.device
    key = _pack_keys(points, mask, origin, resolution)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    sp = points[order]
    wf = (sk != _KEY_INVALID).to(torch.float32)
    new_group = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           sk[1:] != sk[:-1]])
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    outer = torch.einsum("ni,nj->nij", sp, sp) * wf[:, None, None]
    acc = segment_sum(torch.cat([wf[:, None], sp * wf[:, None],
                                 outer.reshape(N, 9)], dim=1), gid, N)
    cnt, psum, ppt = acc[:, 0], acc[:, 1:4], acc[:, 4:].reshape(N, 3, 3)
    n = torch.clamp(cnt, min=1.0)
    mean = psum / n[:, None]
    cov = ppt / n[:, None, None] - torch.einsum("ni,nj->nij", mean, mean)
    cov = cov + 1e-9 * torch.eye(3, device=dev)
    # regularize the occupied voxels only: an empty group's covariance is
    # never read (lookups mask it out), and one eigh batch per table entry
    # exceeds cuSOLVER's batched 3x3 limit at the featsense target size
    occupied = torch.nonzero(cnt > 0).squeeze(1)
    cov[occupied] = _regularize(cov[occupied])
    # representative key per group = the key of its first sorted row;
    # groups follow the sorted order, so the keys stay ascending
    first_row = torch.full((N,), N, dtype=torch.int64, device=dev)
    first_row.scatter_reduce_(0, gid, torch.arange(N, device=dev), "amin")
    first_row = torch.clamp(first_row, 0, N - 1)
    gkey = torch.where(cnt > 0, sk[first_row],
                       torch.full_like(sk, _KEY_INVALID))
    return VoxelTable(keys=gkey, mean=mean, cov=cov, mask=cnt > 0)


def lookup(table: VoxelTable, points, mask, origin, resolution: float):
    """Each point's containing voxel (DIRECT1): (index, found)."""
    key = _pack_keys(points, mask, origin, resolution)
    idx = torch.clamp(torch.searchsorted(table.keys, key), 0,
                      table.keys.shape[0] - 1)
    found = (table.keys[idx] == key) & (key != _KEY_INVALID) \
        & table.mask[idx]
    return idx, found


def vgicp_align(source_pts, source_mask, target_pts, target_mask, *,
                resolution: float = 1.0, max_iterations: int = 20,
                fitness_score_threshold: float = 6.0):
    """Align source onto target; returns (4x4 float32 transform, fitness),
    both on the device of the inputs.  The transform maps source-frame
    points into the target frame; identity when the fitness gate fails."""
    dev = source_pts.device
    f32 = torch.float32
    eye3 = torch.eye(3, dtype=f32, device=dev)
    wf = source_mask.to(f32)
    origin = (torch.sum(source_pts * wf[:, None], dim=0)
              / torch.clamp(torch.sum(wf), min=1.0))
    tgt = build_voxel_table(target_pts, target_mask, origin, resolution)
    src = build_voxel_table(source_pts, source_mask, origin, resolution)
    sidx, sfound = lookup(src, source_pts, source_mask, origin, resolution)
    src_cov = torch.where(sfound[:, None, None], src.cov[sidx], eye3)

    R = eye3.clone()
    t = torch.zeros(3, dtype=f32, device=dev)
    for _ in range(max_iterations):
        pw = source_pts @ R.T + t
        tidx, found = lookup(tgt, pw, source_mask, origin, resolution)
        found = found & sfound
        r = tgt.mean[tidx] - pw                                   # (N, 3)
        M = torch.linalg.inv_ex(tgt.cov[tidx] + R @ src_cov @ R.T
                                + 1e-6 * eye3)[0]
        M = torch.where(found[:, None, None], M, torch.zeros_like(M))
        r = torch.where(found[:, None], r, torch.zeros_like(r))
        # left increment T' = exp(xi) T: dr/domega = skew(pw), dr/dt = -I
        zeros = torch.zeros_like(pw[:, 0])
        Jrot = torch.stack([
            torch.stack([zeros, -pw[:, 2], pw[:, 1]], dim=-1),
            torch.stack([pw[:, 2], zeros, -pw[:, 0]], dim=-1),
            torch.stack([-pw[:, 1], pw[:, 0], zeros], dim=-1)], dim=-2)
        J = torch.cat([Jrot, -eye3.expand(Jrot.shape)], dim=-1)  # (N, 3, 6)
        MJ = M @ J
        H = torch.einsum("nij,nik->jk", J, MJ)
        g = torch.einsum("nij,ni->j", MJ, r)
        ok = torch.sum(found) > 6
        eye6 = torch.eye(6, dtype=f32, device=dev)
        A = torch.where(ok, H + 1e-6 * eye6, eye6)
        dx = torch.where(ok, torch.linalg.solve_ex(A, -g)[0],
                         torch.zeros_like(g))
        dq, dt = geometry.se3_exp(dx)
        dR = geometry.quat_to_mat(dq)
        R, t = dR @ R, (dR @ t[:, None])[:, 0] + dt

    # fitness: mean squared distance to the matched voxel means
    pw = source_pts @ R.T + t
    tidx, found = lookup(tgt, pw, source_mask, origin, resolution)
    d2 = torch.sum((tgt.mean[tidx] - pw) ** 2, dim=-1)
    nf = torch.clamp(torch.sum(found.to(f32)), min=1.0)
    fitness = torch.sum(torch.where(found, d2, torch.zeros_like(d2))) / nf
    fitness = torch.where(torch.sum(found) > 0, fitness,
                          torch.tensor(float("inf"), device=dev))
    T = geometry.pose_matrix(R, t)
    T = torch.where(fitness > fitness_score_threshold,
                    torch.eye(4, dtype=f32, device=dev), T)
    return T, fitness
