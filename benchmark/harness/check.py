"""What decides ``correct``: the program's poses and window against the
plain reference's on the same scans.

The program's outputs are a pose for every scan and the map it carries
from scan to scan.  The reference replays the drive from the empty map,
fed the same scans, stamps and gyro samples and nothing the program
derived, over every scan of set-up and the first ``scans`` of the window
(the cell's ``benchmark/checks/<cell>.json``), twice:

* following the program step by step: after each scan it carries on from
  the pose the program returned (its gates, its fusion's position, the
  next scan's start), so that its own pose for a scan is the step from
  the program's last pose and a difference in one step does not compound
  over the drive;
* free, over the first ``free_scans`` of those scans: from the identity,
  on its own poses alone.  Its gaps to the program and both sides' ATE
  against the true poses are logged, not compared: a stop test that flips
  on the last bit of a sum parts the two by tens of millimetres in sound
  runs as often as the bfloat16 control does.

The numbers:

* ``pose_gap_median_mm``, ``pose_gap_p90_mm``: the median and the 90th
  percentile of the per-scan distance between the program's position and
  the following reference's over the checked scans (the largest,
  ``pose_gap_mm``, is logged: a stop test that flips on the last bit of a
  sum moves one scan by tens of millimetres in sound runs);
* ``shift_gap_median_mm``: the median of that distance over the scans
  that come right after a window shift, the first registered against the
  shifted window (NaN without a shift);
* ``start_gap_mm``: that distance at the first scan, the start;
* ``map_differ_share``: after the last checked scan, the share of the
  window's fused voxels (fused on either side) whose value or weight
  differ, the program's ring buffer unrolled to global order: the shift's
  evictions and load-backs included;
* ``window_differ``: components of the window's position and ring offset
  that differ there (exactly 0);
* ``failed_scans``: checked scans whose call raised or whose pose is not
  finite (exactly 0).

A cell's ``limits`` name the numbers it compares besides the last two.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

MARGIN_M = 3.0
NUMBERS = ("pose_gap_mm", "start_gap_mm", "pose_gap_median_mm",
           "pose_gap_p90_mm", "shift_gap_median_mm", "map_differ_share",
           "window_differ")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Snapshot:
    """The program's window, copied to host memory (pinned on the card)
    by an asynchronous copy in the stream that updates it."""

    def __init__(self, state, *, pinned: bool):
        def buf(t):
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
        self.bufs = [buf(t) for t in state]

    def take(self, state) -> None:
        for b, t in zip(self.bufs, state):
            b.copy_(t, non_blocking=True)

    def result(self):
        """(value, weight, pos, offset) as numpy, after a synchronize."""
        return tuple(b.numpy().copy() for b in self.bufs)


def unroll(ring: np.ndarray, offset) -> np.ndarray:
    """A ring-buffered window in global order: array index ``a`` holds the
    voxel ``pos + ((a - offset + s // 2) mod s) - s // 2``."""
    out = ring
    for ax in range(3):
        s = ring.shape[ax]
        out = np.roll(out, s // 2 - int(offset[ax]), axis=ax)
    return out


def world_box(cfg: dict, traffic, scans: int, follow=None):
    """(lowest global voxel, shape) of a box that holds every window about
    the true positions of the first ``scans`` scans and the finite poses
    of ``follow`` within 50 m of them, with ``MARGIN_M`` to spare."""
    res = int(cfg["map"]["resolution"])
    pts = [traffic.truth_mm(g)[:3, 3] for g in range(scans)]
    for g, p in enumerate(follow or []):
        if p is not None and np.all(np.isfinite(p)) and np.linalg.norm(
                np.asarray(p)[:3, 3] - pts[g]) < 50000.0:
            pts.append(np.asarray(p, np.float64)[:3, 3])
    vox = np.floor(np.stack(pts) / res).astype(np.int64)
    half = np.asarray(cfg["window_voxels"]) // 2
    margin = int(MARGIN_M * 1000 // res)
    lo = vox.min(axis=0) - half - margin
    hi = vox.max(axis=0) + half + margin
    return lo, hi - lo + 1


def replay(cfg: dict, traffic, scans: int, device, *,
           stats_dtype=torch.float32, follow=None):
    """The plain app over scans [0, scans); (app, its poses).  ``follow``:
    the poses to carry on from after each scan (the program's), where
    finite."""
    from reference.app import PlainApp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lo, shape = world_box(cfg, traffic, scans, follow)
    ref = PlainApp(cfg, world_lo=lo, world_shape=shape, device=device,
                   stats_dtype=stats_dtype)
    poses = []
    for g in range(scans):
        for stamp, w in traffic.imu(g):
            ref.imu(stamp, w)
        then = None if follow is None else follow[g]
        if then is not None and not np.all(np.isfinite(then)):
            then = None
        poses.append(ref.cloud(traffic.scan(g), traffic.stamp(g), then))
    return ref, poses


def gaps_mm(poses, ref_poses) -> list:
    """Per scan, the distance between the two positions (inf where the
    first pose is missing or not finite)."""
    out = []
    for p, r in zip(poses, ref_poses):
        if p is None or not np.all(np.isfinite(p)):
            out.append(math.inf)
        else:
            out.append(float(np.linalg.norm(
                np.asarray(p, np.float64)[:3, 3]
                - np.asarray(r, np.float64)[:3, 3])))
    return out


def ate_mm(traffic, poses) -> float:
    """Root mean square distance of the finite ``poses`` from the truth."""
    d = [np.linalg.norm(np.asarray(p, np.float64)[:3, 3]
                        - traffic.truth_mm(g)[:3, 3])
         for g, p in enumerate(poses)
         if p is not None and np.all(np.isfinite(p))]
    return float(np.sqrt(np.mean(np.square(d)))) if d else math.inf


def compare(poses, window, ref, ref_poses) -> dict:
    """The numbers (without their limits)."""
    gaps = gaps_mm(poses, ref_poses)
    after = [gaps[g + 1] for g in ref.shift_scans if g + 1 < len(gaps)]
    v, w, pos, offset = window
    rv, rw, rpos, roff = ref.window_box()
    differ = int(np.sum(pos != rpos) + np.sum(offset != roff))
    share = math.inf
    if differ == 0:
        pv, pw = unroll(v, offset), unroll(w, offset)
        rv, rw = rv.cpu().numpy(), rw.cpu().numpy()
        fused = max(1, int(np.count_nonzero((pw != 0) | (rw != 0))))
        share = float(np.count_nonzero((pv != rv) | (pw != rw)) / fused)
    inf, nan = math.inf, math.nan
    return {"pose_gap_mm": max(gaps) if gaps else inf,
            "start_gap_mm": gaps[0] if gaps else inf,
            "pose_gap_median_mm": float(np.median(gaps)) if gaps else inf,
            "pose_gap_p90_mm": float(np.percentile(gaps, 90)) if gaps else inf,
            "shift_gap_median_mm": float(np.median(after)) if after else nan,
            "map_differ_share": share, "window_differ": differ}


def reference_numbers(cfg, traffic, poses, window, *, device,
                      free_scans: int = 0) -> dict:
    """The numbers of ``poses`` and ``window`` (the program's, or the
    control's in its place) against the reference that follows them over
    every scan of ``poses``; the free reference over the first
    ``free_scans`` is logged.  A reference that cannot follow the drive
    (its window leaves the box the true drive needs) gives inf for every
    number."""
    if free_scans:
        try:
            _, free_poses = replay(cfg, traffic, free_scans, device)
            free = gaps_mm(poses, free_poses)
            apart = [g for g, d in enumerate(free) if d > 1.0]
            log(f"[check] free stretch of {free_scans} scans: gaps mm to "
                f"the program: median {float(np.median(free))!r}, largest "
                f"{max(free)!r}, first over 1 mm at scan "
                f"{apart[0] if apart else None}; ATE mm against the truth: "
                f"the program {ate_mm(traffic, poses[:free_scans])!r}, the "
                f"free reference {ate_mm(traffic, free_poses)!r}")
        except RuntimeError as e:
            log(f"[check] the free reference failed: {e}")
    try:
        ref, ref_poses = replay(cfg, traffic, len(poses), device,
                                follow=poses)
    except RuntimeError as e:
        log(f"[check] the reference failed: {e}")
        return {k: math.inf for k in NUMBERS}
    nums = compare(poses, window, ref, ref_poses)
    gaps = [g for g in gaps_mm(poses, ref_poses) if math.isfinite(g)]
    last = poses[-1]
    log(f"[check] the reference fused {ref.fusions} and shifted "
        f"{len(ref.shift_scans)} times (after scans {ref.shift_scans}) over "
        f"{len(poses)} scans; pose gaps mm: median "
        f"{float(np.median(gaps)) if gaps else math.nan!r}, largest "
        f"{max(gaps) if gaps else math.nan!r} at scan "
        f"{int(np.argmax(gaps)) if gaps else -1}; ATE mm against the truth "
        f"{ate_mm(traffic, poses)!r}; the last position "
        f"{np.round(last[:3, 3], 1).tolist() if last is not None else None}, "
        f"the truth's "
        f"{np.round(traffic.truth_mm(len(poses) - 1)[:3, 3], 1).tolist()}")
    return nums


def judge(nums: dict, limits: dict, failed: int) -> dict:
    """Each number a cell compares, with its limit and whether it holds
    (a NaN holds no limit)."""
    nums = dict(nums, failed_scans=failed)
    log("[check] every number: " + ", ".join(
        f"{k} {v!r}" for k, v in nums.items()))
    lim = dict(limits, window_differ=0, failed_scans=0)
    return {k: {"value": nums[k], "limit": lim[k],
                "ok": bool(nums[k] <= lim[k])} for k in lim}


def run_check(cfg, traffic, poses, window, *, failed, device, limits,
              free_scans: int = 0) -> dict:
    """The program's numbers, judged by the cell's limits."""
    nums = reference_numbers(cfg, traffic, poses, window, device=device,
                             free_scans=free_scans)
    return judge(nums, limits, len(failed))


def passed(numbers: dict) -> bool:
    return all(v["ok"] for v in numbers.values())
