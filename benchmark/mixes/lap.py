"""The general generator of ``"kind": "lap"`` traffic mixes.

A mix file gives the scene (``scene``, see ``harness.scene.car_park``),
the lap (``lap``: its ``shape`` in ``harness.scene.LAPS`` and that
function's arguments), the sensor (range noise, maximum range) and the
clocks (scan and IMU rates).  ``--seed`` sets the range noise; the scene
and the lap are the mix's, so every seed drives the same path through the
same scene, from the lap's first scan.

The scans of one lap are rendered on the card in set-up and held in host
memory as float32 metres; a window that outlasts the lap replays it.
Scan ``g`` (0 the first scan of set-up) is the lap's scan
``g % len(lap)`` at stamp ``g * scan_ms / 1000``; before it come
the IMU samples of the interval since scan ``g - 1``: the gyro that turns
one scan's attitude into the next, at ``imu_hz``.
"""
from __future__ import annotations

import numpy as np
import torch

from harness import scene


class LapTraffic:
    """Scans, stamps and gyro samples of a lap, by global scan index."""

    def __init__(self, mix: dict, seed: int, lidar: dict, device,
                 *, lap_scans: int | None = None):
        self.mix = mix
        self.truth = scene.lap_poses(mix["lap"])
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
        self.gyro = np.stack([
            scene.gyro_between(self.truth[k - 1], self.truth[k],
                               self.scan_ms / 1000.0)
            for k in range(n)])        # gyro[k]: from lap scan k - 1 to k

    def __len__(self) -> int:
        return len(self.truth)

    def lap_index(self, g: int) -> int:
        return g % len(self.truth)

    def stamp(self, g: int) -> float:
        return g * self.scan_ms / 1000.0

    def scan(self, g: int) -> np.ndarray:
        return self.scans[self.lap_index(g)]

    def imu(self, g: int) -> list:
        """[(stamp, angular velocity)] of the interval before scan ``g``."""
        if g == 0:
            return []
        w = self.gyro[self.lap_index(g)]
        step = self.scan_ms // self.imu_per_scan
        t0 = (g - 1) * self.scan_ms
        return [((t0 + (k + 1) * step) / 1000.0, w)
                for k in range(self.imu_per_scan)]

    def truth_mm(self, g: int) -> np.ndarray:
        """Scan ``g``'s true pose in the first scan's frame (mm), the
        frame the app's poses are in."""
        first = self.truth[self.lap_index(0)]
        rel = np.linalg.inv(first) @ self.truth[self.lap_index(g)]
        rel[:3, 3] *= 1000.0
        return rel


def make(mix: dict, seed: int, lidar: dict, device, **kw) -> LapTraffic:
    return LapTraffic(mix, seed, lidar, device, **kw)
