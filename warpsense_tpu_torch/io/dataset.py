"""Scan-sequence datasets: the replacement for rosbag playback.

Counterpart of ``warpsense_tpu/io/dataset.py``.  A dataset is anything
iterable of ``Frame``s:

* ``SyntheticDataset`` — analytic OS1 scans from io/synthetic.py with
  ground-truth poses (the test and evaluation driver);
* ``PcdDirectoryDataset`` — a directory of numbered .pcd/.ply clouds (the
  output of io/pcl_writer.py) with an optional TUM ground-truth file;
* ``io.rosbag.RosbagDataset`` — a rosbag1 file.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from .pcd import read_pcd, read_ply
from .synthetic import BoxWorld, render_scan, walk_trajectory
from .trajectory import read_tum


@dataclass
class Frame:
    stamp: float
    cloud: np.ndarray                 # (..., 3) float32 meters, sensor frame
    ground_truth: np.ndarray | None = None   # 4x4 sensor-to-world (meters)


class SyntheticDataset:
    """Analytic box-world OS1 sequence with ground truth."""

    def __init__(self, n_frames: int = 20, *, channels: int = 128,
                 columns: int = 1024, rate_hz: float = 10.0,
                 world: BoxWorld | None = None,
                 poses: np.ndarray | None = None, noise_std: float = 0.003,
                 seed: int = 0):
        self.world = world or BoxWorld.default()
        self.poses = (poses if poses is not None
                      else walk_trajectory(n_frames))
        self.channels = channels
        self.columns = columns
        self.dt = 1.0 / rate_hz
        self.noise_std = noise_std
        self.seed = seed

    def __len__(self) -> int:
        return len(self.poses)

    def __iter__(self) -> Iterator[Frame]:
        rng = np.random.default_rng(self.seed)
        for i, pose in enumerate(self.poses):
            cloud = render_scan(self.world, pose, channels=self.channels,
                                columns=self.columns,
                                noise_std=self.noise_std, rng=rng)
            yield Frame(stamp=i * self.dt, cloud=cloud,
                        ground_truth=np.asarray(pose))


class PcdDirectoryDataset:
    """Numbered point-cloud files + optional TUM ground truth."""

    def __init__(self, directory: str | Path, *, pattern: str = "*.pcd",
                 rate_hz: float = 10.0,
                 tum_ground_truth: str | Path | None = None):
        self.files = sorted(Path(directory).glob(pattern))
        if not self.files:
            raise FileNotFoundError(f"no {pattern} files in {directory}")
        self.dt = 1.0 / rate_hz
        self.gt: np.ndarray | None = None
        if tum_ground_truth is not None:
            _, self.gt = read_tum(tum_ground_truth)

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[Frame]:
        for i, path in enumerate(self.files):
            cloud = (read_ply(path) if path.suffix == ".ply"
                     else read_pcd(path))[:, :3]
            gt = self.gt[i] if self.gt is not None and i < len(self.gt) else None
            yield Frame(stamp=i * self.dt, cloud=cloud, ground_truth=gt)
