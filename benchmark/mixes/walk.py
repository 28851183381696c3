"""The generator of ``"kind": "walk"`` traffic mixes: a handheld sensor
carried round a lap at walking pace.

A mix file gives what a ``"kind": "lap"`` mix gives (``scene``, ``lap``,
the sensor's range noise and maximum range, the scan and IMU rates) and
the gait (``gait``), which is laid on top of the lap's yaw in the
sensor's frame:

* pitch ``pitch_deg`` + ``pitch_amp_deg`` x sin, at the step frequency
  ``step_hz`` (positive: the sensor's x axis tilts down);
* roll ``roll_deg`` + ``roll_amp_deg`` x sin, at the stride frequency
  ``stride_hz``;
* height: the lap's ``z`` + ``height_amp_m`` x sin, at the step
  frequency.

Each frequency is the nearest to its value that closes the lap in whole
cycles, so the pose after the lap's last scan is its first again.  Every
seed starts at the lap's first scan, at phase 0.

The gyro is given in the sensor's own frame, as a sensor's built-in IMU
reports it: the angular velocity that turns one scan's attitude into the
next, about the axes of the first of the two (the rotation vector of
``R_{k-1}^T R_k`` over the scan interval).  The app applies the rates in
its map frame, the first scan's (it does no gravity alignment): on a
sensor that only yaws about that frame's z axis the two frames give the
same rotation, but after a U-turn the walk's pitch rate reaches the app
about the opposite axis, and registration removes the difference.  Scans,
stamps and IMU samples are served as ``lap.LapTraffic`` serves them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from harness import discover, scene

LapTraffic = discover.generator("lap").LapTraffic


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def gait_cycles(hz: float, scans: int, scan_ms: int) -> int:
    """Whole cycles of a frequency over a lap: the nearest to ``hz``."""
    return max(1, int(round(hz * scans * scan_ms / 1000.0)))


def gait(spec: dict, k: int, scans: int, scan_ms: int):
    """(pitch rad, roll rad, height offset m) at the lap's scan ``k``."""
    step = 2 * math.pi * gait_cycles(spec["step_hz"], scans, scan_ms) \
        * k / scans
    stride = 2 * math.pi * gait_cycles(spec["stride_hz"], scans, scan_ms) \
        * k / scans
    pitch = spec["pitch_deg"] + spec["pitch_amp_deg"] * math.sin(step)
    roll = spec["roll_deg"] + spec["roll_amp_deg"] * math.sin(stride)
    return (math.radians(pitch), math.radians(roll),
            spec["height_amp_m"] * math.sin(step))


def walk_poses(mix: dict) -> np.ndarray:
    """(N, 4, 4) world poses of the mix's lap with its gait on top."""
    path = scene.lap_poses(mix["lap"])
    n, scan_ms = len(path), int(mix["scan_ms"])
    out = path.copy()
    for k in range(n):
        pitch, roll, dz = gait(mix["gait"], k, n, scan_ms)
        out[k, :3, :3] = path[k, :3, :3] @ _rot_y(pitch) @ _rot_x(roll)
        out[k, 2, 3] += dz
    return out


def body_gyro(truth: np.ndarray, scan_ms: int) -> np.ndarray:
    """(N, 3) gyro in the sensor's frame: row ``k`` turns lap scan
    ``k - 1``'s attitude into scan ``k``'s about scan ``k - 1``'s axes
    (row 0 from the lap's last scan, where the lap replays)."""
    eye = np.eye(4)
    return np.stack([scene.gyro_between(
        eye, np.linalg.inv(truth[k - 1]) @ truth[k], scan_ms / 1000.0)
        for k in range(len(truth))])


class WalkTraffic(LapTraffic):
    """Scans, stamps and gyro samples of a walk, by global scan index."""

    def __init__(self, mix: dict, seed: int, lidar: dict, device,
                 *, lap_scans: int | None = None):
        self.mix = mix
        self.truth = walk_poses(mix)
        if lap_scans is not None:                 # tiny rehearsals only
            self.truth = self.truth[:lap_scans]
        self.scan_ms = int(mix["scan_ms"])
        self.imu_per_scan = int(mix["imu_hz"]) * self.scan_ms // 1000
        boxes = torch.as_tensor(scene.car_park(mix["scene"]),
                                device=device)
        dirs = torch.as_tensor(scene.ray_directions(
            int(lidar["channels"]), int(lidar["hresolution"]),
            float(lidar["vfov"])), device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        poses = torch.as_tensor(self.truth, device=device)
        n = len(self.truth)
        self.scans = np.empty((n, *dirs.shape), np.float32)
        for k in range(n):
            self.scans[k] = scene.render_scans(
                boxes, poses[k:k + 1], dirs,
                max_range=float(mix["max_range_m"]),
                noise_std=float(mix["range_noise_m"]),
                generator=gen)[0].cpu().numpy()
        self.gyro = body_gyro(self.truth, self.scan_ms)


def make(mix: dict, seed: int, lidar: dict, device, **kw) -> WalkTraffic:
    return WalkTraffic(mix, seed, lidar, device, **kw)
