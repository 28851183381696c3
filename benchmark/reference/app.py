"""A plain warpsense app: the per-scan step the benchmark holds the program to.

The same semantics as ``WarpsenseApp.cloud_callback`` with a synchronous
shift, written without the program: the IMU's gyro smoothing and
accumulation, the random subsample to the point capacity, preprocess,
the update-distance gate (parity fuses before registering, at the stale
pose; fast after, at the refined pose), the cached fields (packed or
parity), the LM or GN registration with the velocity prior and the
sane-step gate, and the window shift once the pose has moved ``shift``
metres.

The map is a world box of voxels in global order that holds every window
the drive can reach, its cells at (tau, 0) until fused.  The window is a
slice of it about ``pos``: a voxel that leaves the window keeps its
value, and one that comes back finds it, which is what the program's
evict-to-global-map and load-back give.  ``offset`` is kept only to be
compared (the program's ring offset moves by each shift's voxels).
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from . import ops


class GyroFilter:
    """Sliding-window mean of the gyro (window 10): samples pass through
    until the window fills, then the running mean moves by
    (newest - oldest) / window."""

    def __init__(self, window: int = 10):
        self.window = float(window)
        self.buffer: deque = deque()
        self.mean = None

    def update(self, value):
        value = np.asarray(value, dtype=np.float64)
        if self.mean is None:
            self.mean = np.zeros_like(value)
        self.buffer.append(value)
        if len(self.buffer) <= self.window:
            self.mean = self.mean + value / self.window
            return value
        self.mean = self.mean + (self.buffer[-1] - self.buffer[0]) / self.window
        self.buffer.popleft()
        return self.mean


def _axis_rotations(w: np.ndarray) -> np.ndarray:
    rx, ry, rz = w
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


class GyroAccumulator:
    """Integrates the buffered gyro samples up to a scan's stamp into a
    rotation (each sample's rate times the time since the one before, as
    X, Y, Z axis rotations, left-multiplied); the first sample only sets
    the clock."""

    def __init__(self):
        self.samples: deque = deque()
        self.first = True
        self.last_stamp = 0.0

    def transform(self, stamp: float) -> np.ndarray:
        acc = np.eye(4, dtype=np.float64)
        while self.samples and stamp - self.samples[0][0] >= 0:
            t, w = self.samples.popleft()
            if self.first:
                self.last_stamp = t
                self.first = False
                continue
            dt = abs(t - self.last_stamp)
            acc[:3, :3] = _axis_rotations(np.asarray(w) * dt) @ acc[:3, :3]
            self.last_stamp = t
        return acc


class PlainApp:
    """``cfg``: the harness's resolved configuration (``params`` groups
    and the app keys); ``world_lo`` / ``world_shape``: the world box in
    global voxels; ``stats_dtype``: the registration statistics' type."""

    def __init__(self, cfg: dict, *, world_lo, world_shape, device,
                 stats_dtype=torch.float32):
        m, r, lid = cfg["map"], cfg["registration"], cfg["lidar"]
        self.fast = r["mode"] == "fast"
        self.res = int(m["resolution"])
        self.tau = int(m["max_distance"] * 1000.0)
        self.max_weight = int(m["max_weight"]) * ops.WEIGHT_RESOLUTION
        self.update_distance = float(m["update_distance"])
        self.shift_m = float(m["shift"])
        self.size = tuple(int(s) for s in cfg["window_voxels"])
        self.reg = r
        if int(r.get("coarse_iterations", 0)) != 0 or not r.get(
                "gather_freeze", True):
            raise ValueError("the plain app runs the LM without coarse "
                             "iterations and with the gather freeze")
        self.lidar = lid
        self.capacity = int(cfg["capacity"])
        self.device = torch.device(device)
        self.stats_dtype = stats_dtype
        self.world_lo = np.asarray(world_lo, np.int64)
        self.value = torch.full(tuple(world_shape), self.tau,
                                dtype=torch.int16, device=self.device)
        self.weight = torch.zeros(tuple(world_shape), dtype=torch.int16,
                                  device=self.device)
        self.pos = np.zeros(3, np.int64)
        self.offset = np.asarray([s // 2 for s in self.size], np.int64)
        self.pose = np.eye(4, dtype=np.float32)
        self.prev_pose = None
        self.healthy = False
        self.initialized = False
        self.shifted = False
        self.last_tsdf_pose = self.pose.copy()
        self.last_shift_pose = self.pose.copy()
        self.fields = None
        self.rng = np.random.default_rng(0)
        self.gyro_filter = GyroFilter(10)
        self.gyro = GyroAccumulator()
        self.scans = 0
        self.shift_scans: list = []     # the scans after which it shifted
        self.fusions = 0

    # ---------------------------------------------------------------- map
    def window(self):
        """(value, weight) views of the window, and its lowest voxel."""
        half = np.asarray(self.size) // 2
        lo = self.pos - half
        a = lo - self.world_lo
        if np.any(a < 0) or np.any(a + self.size > self.value.shape):
            raise RuntimeError(f"window at {self.pos.tolist()} leaves the "
                               "reference's world box")
        sl = tuple(slice(int(a[i]), int(a[i]) + self.size[i])
                   for i in range(3))
        return self.value[sl], self.weight[sl], lo

    def _pos_t(self):
        return torch.as_tensor(self.pos.astype(np.int32), device=self.device)

    def _fuse(self, pts, mask, pose) -> None:
        v, w, lo = self.window()
        ops.fuse(v, w, [int(x) for x in lo], self._pos_t(), self.size, pts,
                 mask, pose, tau=self.tau, max_weight=self.max_weight,
                 resolution=self.res, channels=int(self.lidar["channels"]),
                 columns=int(self.lidar["hresolution"]),
                 vfov_deg=float(self.lidar["vfov"]))
        self.fields = None
        self.fusions += 1

    # ------------------------------------------------------------ callbacks
    def imu(self, stamp: float, angular_velocity) -> None:
        filtered = self.gyro_filter.update(angular_velocity)
        self.gyro.samples.append((stamp, np.asarray(filtered)))

    def cloud(self, cloud_m: np.ndarray, stamp: float,
              follow: np.ndarray | None = None) -> np.ndarray:
        """One scan; returns the reference's pose.  ``follow``: the pose the
        program returned for this scan; the reference then carries on from
        it (its gates, its fusion's scanner position, the next scan's
        start), so that its own pose is the step from the program's last
        one and a difference does not compound over the drive."""
        flat = np.ascontiguousarray(cloud_m.reshape(-1, 3), np.float32)
        if len(flat) > self.capacity:
            keep = self.rng.choice(len(flat), self.capacity, replace=False)
            flat = flat[np.sort(keep)]
        pad = np.zeros((self.capacity - len(flat), 3), np.float32)
        cloud = torch.as_tensor(np.concatenate([flat, pad]),
                                device=self.device)
        valid = torch.as_tensor(
            np.concatenate([np.any(flat != 0.0, axis=1),
                            np.zeros(len(pad), bool)]), device=self.device)
        pts, mask = ops.preprocess(
            cloud, valid, torch.as_tensor(self.pose, device=self.device),
            resolution=self.res, capacity=self.capacity, snap=not self.fast)

        dist = np.linalg.norm(
            (self.last_tsdf_pose[:3, 3] - self.pose[:3, 3]) / 1000.0)
        want_fuse = (not self.initialized or dist > self.update_distance
                     or self.shifted)
        if want_fuse and (not self.fast or not self.initialized):
            self.initialized = True
            self.shifted = False
            self.last_tsdf_pose = self.pose.copy()
            self._fuse(pts, mask, self.pose)
            want_fuse = False

        pre = self.gyro.transform(stamp).astype(np.float32)
        dR = pre[:3, :3]
        pre[:3, 3] += (np.eye(3, dtype=np.float32) - dR) @ self.pose[:3, 3]
        imu_only = pre.copy()
        if (self.fast and self.reg.get("velocity_prior", True)
                and self.prev_pose is not None and self.healthy):
            pre[:3, 3] += self.pose[:3, 3] - self.prev_pose[:3, 3]
        self.prev_pose = self.pose.copy()

        transform = self._register(pts, mask, pre)
        if self.fast:
            sane = float(self.reg.get("sane_step_m", 2.0))
            delta = (transform @ self.pose)[:3, 3] - self.pose[:3, 3]
            if sane > 0 and float(np.linalg.norm(delta)) > sane * 1000.0:
                transform = imu_only.astype(np.float32)
                self.healthy = False
            else:
                self.healthy = not np.array_equal(transform,
                                                  pre.astype(np.float32))
        own = (transform @ self.pose).astype(np.float32)
        if follow is not None:
            transform = self._program_step(
                np.asarray(follow, np.float32), own, transform,
                pre.astype(np.float32), imu_only.astype(np.float32))
        self.pose = own if follow is None else np.asarray(follow,
                                                          np.float32)
        if want_fuse:
            self.initialized = True
            self.shifted = False
            self.last_tsdf_pose = self.pose.copy()
            pts_ref = ops.transform_point_fixed(pts, ops.to_int_mat(
                torch.as_tensor(transform, device=self.device)))
            self._fuse(pts_ref, mask, self.pose)
        self._maybe_shift()
        self.scans += 1
        return own.copy()

    def _program_step(self, follow, own, transform, pre, imu_only):
        """The program's step to ``follow`` and, in fast mode, its health,
        read from its pose: a pose that is the prior applied
        (``pre @ pose``, or the IMU's alone after the sane-step gate) is a
        registration that accepted no step, and the program then drops
        the velocity prior, as ``self.healthy`` does; the step is then
        known exactly.  Otherwise it is this registration's own step where
        the poses agree within a micrometre (its fixed-point matrix is then
        the program's but for a unit or so), else the one the two poses
        give, as near as float32 poses hold it."""
        kept = None
        for prior in (pre, imu_only):
            if np.array_equal(follow, (prior @ self.pose).astype(np.float32)):
                kept = prior
                break
        if self.fast:
            self.healthy = kept is None
        if kept is not None:
            return kept
        if np.abs(follow - own).max() <= 1e-3:
            return transform
        return (follow.astype(np.float64) @ np.linalg.inv(
            self.pose.astype(np.float64))).astype(np.float32)

    def _register(self, pts, mask, pre) -> np.ndarray:
        v, w, lo = self.window()
        if self.fields is None:
            self.fields = (ops.packed_fields(v, w, tau=self.tau) if self.fast
                           else ops.parity_fields(v, w))
        fields, r = self.fields, self.reg
        pos = self._pos_t()
        lo = [int(x) for x in lo]
        if self.fast:
            cache: dict = {}

            def stats(total, gather):
                return ops.lm_stats(fields, lo, pos, self.size, pts, mask,
                                    total, cache, resolution=self.res,
                                    tau=self.tau, gather=gather,
                                    dtype=self.stats_dtype)
            pose, _, _ = ops.register_lm(
                stats, pre, max_iterations=int(r["max_iterations"]),
                epsilon=float(r["epsilon"]), freeze_step_mm=float(self.res))
        else:
            def stats(total):
                return ops.gn_stats(fields, lo, pos, self.size, pts, mask,
                                    total, resolution=self.res,
                                    dtype=self.stats_dtype)
            pose, _ = ops.register_gn(
                stats, pre, max_iterations=int(r["max_iterations"]),
                epsilon=float(r["epsilon"]),
                it_weight_gradient=float(r["it_weight_gradient"]))
        return pose

    def _maybe_shift(self) -> None:
        dist = np.linalg.norm(
            (self.last_shift_pose[:3, 3] - self.pose[:3, 3]) / 1000.0)
        if dist < self.shift_m:
            return
        self.last_shift_pose = self.pose.copy()
        new_pos = np.floor(self.pose[:3, 3] / self.res).astype(np.int64)
        self.offset = (self.offset + (new_pos - self.pos)) % np.asarray(
            self.size)
        self.pos = new_pos
        self.window()                       # the new window must fit
        self.shifted = True
        self.fields = None
        self.shift_scans.append(self.scans)

    def window_box(self):
        """The window's (value, weight) as contiguous tensors in global
        order, with pos and offset."""
        v, w, _ = self.window()
        return v.contiguous(), w.contiguous(), self.pos.copy(), \
            self.offset.copy()
