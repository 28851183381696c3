"""Featsense feature extraction on tensors.

Counterpart of ``warpsense_tpu/frontends/featsense/features.py`` (F-LOAM's
organized-cloud feature stage, lidar_processing.cpp:125-286):

* curvature over the 11-point row window and the occlusion / range /
  parallel-beam masks are vectorized sweeps over the (H, W) grid;
* per-(row, block) selection — up to ``max_edge_per_block`` highest-
  curvature edge points, then ``max_surf_per_block`` lowest-curvature surf
  points, each suppressing its +-5-column neighbourhood — runs ONE
  acceptance per block per round: every round, each of the H x 6 blocks
  takes its best still-available candidate (argmax, ties to the lowest
  position, as ``jnp.argmax``).  Suppression never leaves a block, so this
  equals the per-block sequential greedy.  The JAX ``while_loop`` becomes
  ``budget`` rounds of broadcast compares and reductions; a round in which
  no block accepts changes nothing, so all rounds run without a host sync;
* outputs are fixed-capacity, valid-first compacted point arrays.
"""
from __future__ import annotations

import torch

from ...ops.tsdf_projective import _sqrt
from .features_reference import FeatureParams, block_bounds


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x shifted so out[v] = x[v + k] along the last axis, edge-filled."""
    if k == 0:
        return x
    pad = torch.full(x.shape[:-1] + (abs(k),), fill, dtype=x.dtype,
                     device=x.device)
    if k > 0:
        return torch.cat([x[..., k:], pad], dim=-1)
    return torch.cat([pad, x[..., :k]], dim=-1)


def _band(W: int, device) -> torch.Tensor:
    cols = torch.arange(W, device=device)
    return (cols >= 5) & (cols < W - 6)


def curvature_and_ranges(cloud: torch.Tensor):
    """cloud: (H, W, 3) float32.  Returns (curvature, ranges), both (H, W);
    curvature is +inf outside the valid column band [5, W-6)."""
    W = cloud.shape[1]
    rows = cloud.transpose(-1, -2)                       # (H, 3, W)
    window = torch.zeros_like(cloud)
    for o in range(-5, 6):
        window = window + _shift(rows, -o, 0.0).transpose(-1, -2)
    diff = window - 11.0 * cloud
    sq = diff * diff
    curv = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    curv = torch.where(_band(W, cloud.device), curv,
                       torch.full_like(curv, float("inf")))
    c2 = cloud * cloud
    ranges = _sqrt((c2[..., 0] + c2[..., 1]) + c2[..., 2])
    return curv, ranges


def mark_occluded(ranges: torch.Tensor, p: FeatureParams) -> torch.Tensor:
    """(H, W) bool occlusion / range / parallel-beam mask
    (lidar_processing.cpp:136-188, vectorized)."""
    band = _band(ranges.shape[-1], ranges.device)
    # the reference fills ranges only inside the band, so the edge
    # comparisons at v-1 / v+1 see 0 there (lidar_processing.cpp:211)
    d = torch.where(band, ranges, torch.zeros_like(ranges))
    dn = _shift(d, 1, 0.0)         # d[v+1]
    dp = _shift(d, -1, 0.0)        # d[v-1]
    picked = band & ((d < p.min_distance) | (d > p.max_distance))
    c1 = band & (d - dn > 0.3)     # marks [v-5, v]
    c2 = band & (dn - d > 0.3)     # marks [v+1, v+6]
    for k in range(0, 6):
        picked = picked | _shift(c1, k, False)
    for k in range(1, 7):
        picked = picked | _shift(c2, -k, False)
    parallel = (torch.abs(dp - d) > 0.02 * d) & (torch.abs(dn - d) > 0.02 * d)
    return picked | (band & parallel)


def _compact(points, idx, valid, capacity: int):
    """Valid-first stable compaction to a fixed capacity."""
    take = torch.argsort((~valid).to(torch.uint8), stable=True)[:capacity]
    return points[take], valid[take], idx[take]


def extract_features(cloud: torch.Tensor, *,
                     params: FeatureParams = FeatureParams(),
                     edge_capacity: int = 2048, surf_capacity: int = 4096):
    """The feature stage on the device of ``cloud``.

    cloud: (H, W, 3) float32 meters, organized scan, invalid rays (0,0,0).
    Returns ((edge_pts, edge_mask, edge_idx), (surf_pts, surf_mask,
    surf_idx)), each valid-first at its capacity; idx are flat u*W+v."""
    H, W = cloud.shape[:2]
    dev = cloud.device
    bounds = block_bounds(W)
    nb = len(bounds)
    BLK = max(ep - sp for sp, ep in bounds)
    LOC = BLK + 10                # block-local columns sp-5 .. sp+BLK+4

    curv, ranges = curvature_and_ranges(cloud)
    picked = mark_occluded(ranges, params)

    sps = torch.tensor([sp for sp, _ in bounds], device=dev)
    lens = torch.tensor([ep - sp for sp, ep in bounds], device=dev)
    pos_in_block = torch.arange(BLK, device=dev)
    cols_c = torch.clamp(sps[:, None] + pos_in_block[None, :], 0, W - 1)
    in_block = pos_in_block[None, :] < lens[:, None]              # (nb, BLK)
    bcurv = curv[:, cols_c]                                       # (H,nb,BLK)
    bvalid = in_block[None] & torch.isfinite(bcurv)
    loc_cols = sps[:, None] - 5 + torch.arange(LOC, device=dev)[None, :]
    blocked0 = picked[:, torch.clamp(loc_cols, 0, W - 1)]         # (H,nb,LOC)
    loc_iota = torch.arange(LOC, device=dev)[None, None, :]
    blk_iota = torch.arange(BLK, device=dev)[None, None, :]
    neg_inf = torch.tensor(float("-inf"), device=dev)

    def run_pass(blocked, cand, keyvals, mark_lo, mark_hi, budget):
        span = mark_hi - mark_lo
        sel = torch.zeros((H, nb, BLK), dtype=torch.bool, device=dev)
        for _ in range(budget):
            avail = cand & ~blocked[..., 5:5 + BLK]
            key = torch.where(avail, keyvals, neg_inf)
            pos = torch.argmax(key, dim=-1)
            accept = torch.isfinite(torch.amax(key, dim=-1))[..., None]
            sel = sel | (accept & (blk_iota == pos[..., None]))
            lo = pos[..., None] + (5 + mark_lo)
            mark = (loc_iota >= lo) & (loc_iota < lo + span)
            blocked = blocked | (accept & mark)
        return blocked, sel

    edge_cand = bvalid & (bcurv >= params.edge_threshold)
    blocked, edge_sel = run_pass(blocked0, edge_cand, bcurv, -5, 5,
                                 params.max_edge_per_block)
    surf_cand = bvalid & (bcurv <= params.surf_threshold)
    _, surf_sel = run_pass(blocked, surf_cand, -bcurv, -5, 6,
                           params.max_surf_per_block)

    flat_idx = (torch.arange(H, device=dev)[:, None, None] * W
                + cols_c[None]).reshape(-1)
    pts = cloud.reshape(-1, 3)[flat_idx]
    return (_compact(pts, flat_idx, edge_sel.reshape(-1), edge_capacity),
            _compact(pts, flat_idx, surf_sel.reshape(-1), surf_capacity))
