"""The fixed-order segment sum that featsense's voxel reductions use on the
card (``ops/segment.py``), run here on CPU tensors.

* ``segment_sum_fixed`` equals ``index_add_`` within the worst-case bound
  of two float32 summation orders, 2 n u sum|x| per group of n rows (u =
  2^-24), and two calls give the same bits;
* on the CPU ``segment_sum`` is ``index_add_``, so featsense's CPU results
  did not move: ``voxel_downsample`` and ``build_voxel_table`` equal the
  separate ``index_add_`` sums they made before, bit for bit.
"""
import numpy as np
import pytest
import torch

from warpsense_tpu_torch.frontends.featsense import odometry, vgicp
from warpsense_tpu_torch.ops.segment import segment_sum, segment_sum_fixed


def _groups(rng, n, groups, long_group=0):
    gid = rng.integers(0, groups, n)
    if long_group:                          # one group of many rows
        gid[:long_group] = groups // 2
    return torch.as_tensor(np.sort(gid))


@pytest.mark.parametrize("n,groups,long_group,width", [
    (1, 1, 0, 3), (50, 1, 0, 1), (1000, 5000, 0, 4), (5000, 300, 0, 13),
    (40_000, 64, 35_000, 3), (3000, 3000, 2500, 9)])
def test_fixed_order_sum_matches_index_add(n, groups, long_group, width):
    rng = np.random.default_rng(n + groups)
    gid = _groups(rng, n, groups, long_group)
    vals = torch.as_tensor((rng.normal(size=(n, width))
                            * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(
                                np.float32))
    want = torch.zeros((groups, width)).index_add_(0, gid, vals)
    got = segment_sum_fixed(vals, gid, groups)
    again = segment_sum_fixed(vals, gid, groups)
    assert torch.equal(got, again)
    counts = torch.bincount(gid, minlength=groups).to(torch.float32)
    mag = torch.zeros((groups, width)).index_add_(0, gid, vals.abs())
    bound = 2 * counts[:, None] * 2.0 ** -24 * mag
    assert bool(((got - want).abs() <= bound).all())
    assert torch.equal(got[counts == 0], torch.zeros_like(got[counts == 0]))
    # the CPU entry point is index_add_ itself
    assert torch.equal(segment_sum(vals, gid, groups), want)


def _cloud(seed, n=3000):
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-5, 5, (n, 3)).astype(np.float32))
    mask = torch.as_tensor(rng.random(n) < 0.8)
    return pts, mask


def test_voxel_downsample_unchanged_on_cpu():
    pts, mask = _cloud(0)
    got_p, got_m = odometry.voxel_downsample(pts, mask, 0.4, 2048)
    # the sums as index_add_ made them before segment_sum
    N = pts.shape[0]
    key = torch.floor(pts / 0.4).to(torch.int32)
    big = torch.tensor(2 ** 24, dtype=torch.int32)
    kx, ky, kz = (torch.where(mask, key[:, i], big) for i in range(3))
    order = odometry._lexsort(kx, ky, kz)
    sk = torch.stack([kx, ky, kz], dim=-1)[order]
    sp, wf = pts[order], mask[order].to(torch.float32)
    new = torch.cat([torch.ones(1, dtype=torch.bool),
                     torch.any(sk[1:] != sk[:-1], dim=-1)])
    gid = torch.cumsum(new.to(torch.int64), 0) - 1
    sums = torch.zeros((N, 3)).index_add_(0, gid, sp * wf[:, None])
    cnts = torch.zeros(N).index_add_(0, gid, wf)
    centroid = sums / torch.clamp(cnts, min=1.0)[:, None]
    vmask = cnts > 0.0
    ordv = torch.argsort((~vmask).to(torch.uint8), stable=True)[:2048]
    assert torch.equal(got_p, centroid[ordv])
    assert torch.equal(got_m, vmask[ordv])


def test_voxel_table_unchanged_on_cpu():
    pts, mask = _cloud(1)
    origin = torch.zeros(3)
    table = vgicp.build_voxel_table(pts, mask, origin, 1.0)
    N = pts.shape[0]
    key = vgicp._pack_keys(pts, mask, origin, 1.0)
    order = torch.argsort(key, stable=True)
    sk, sp = key[order], pts[order]
    wf = (sk != vgicp._KEY_INVALID).to(torch.float32)
    new = torch.cat([torch.ones(1, dtype=torch.bool), sk[1:] != sk[:-1]])
    gid = torch.cumsum(new.to(torch.int64), 0) - 1
    cnt = torch.zeros(N).index_add(0, gid, wf)
    psum = torch.zeros((N, 3)).index_add_(0, gid, sp * wf[:, None])
    ppt = torch.zeros((N, 3, 3)).index_add_(
        0, gid, torch.einsum("ni,nj->nij", sp, sp) * wf[:, None, None])
    mean = psum / torch.clamp(cnt, min=1.0)[:, None]
    assert torch.equal(table.mask, cnt > 0)
    assert torch.equal(table.mean, mean)
    occ = cnt > 0
    cov = (ppt / torch.clamp(cnt, min=1.0)[:, None, None]
           - torch.einsum("ni,nj->nij", mean, mean)) + 1e-9 * torch.eye(3)
    assert torch.equal(table.cov[~occ], cov[~occ])
    assert int(occ.sum()) > 100
