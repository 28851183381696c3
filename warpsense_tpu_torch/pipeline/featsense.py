"""Featsense pipeline on tensors: F-LOAM odometry + VGICP refinement + the
shared TSDF back end.

Counterpart of ``warpsense_tpu/pipeline/featsense.py`` (the reference's
4-stage featsense node, featsense.cpp and mapping.cpp):

* stage 1 LidarProcessing -> ``frontends.featsense.features``;
* stage 2 OdomEstimation  -> ``frontends.featsense.odometry``;
* stage 3 Mapping         -> VGICP refinement gated on pose distance, then
  the fusion backend shared with warpsense (``fusion="auto"`` runs kernel
  K1 on a CUDA device; ``"raymarch"``, the default as in JAX, the ray
  march);
* stage 4 Visualization   -> trajectory buffers and pose writing.

``FeatsenseApp.process_scan`` runs the stages in order;
``ThreadedFeatsenseRunner`` runs them on four host threads joined by ring
buffers (featsense.cpp:52-75).  With ``mesh`` (a ``parallel.sharded.Mesh``)
the TSDF back end is x-sharded over the ranks of a process group (kernel K1
on each rank's slab) while the front end runs on every rank.
"""
from __future__ import annotations

import threading
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ..core.config import Params
from ..frontends.featsense.features import extract_features
from ..frontends.featsense.features_reference import FeatureParams
from ..frontends.featsense.odometry import OdomEstimation, voxel_downsample
from ..frontends.featsense.vgicp import vgicp_align
from ..io.trajectory import _mat_from_quat, _quat_from_mat
from ..map.global_map import GlobalMap
from ..map.local_map import LocalMap
from ..obs.profiler import RuntimeEvaluator
from ..ops.tsdf import plan_raymarch
from ..utils.device import resolve_device
from ..utils.ring_buffer import ConcurrentRingBuffer
from .fusion_backend import fuse_cloud


class FeatsenseMapping:
    """TSDF back end with VGICP refinement (Mapping stage,
    mapping.cpp:39-152): consumes sensor-frame clouds (meters) and F-LOAM
    poses; produces refined poses and the fused TSDF map on ``device``
    ("cuda", the default, or "cpu"; a CUDA device without a GPU raises).

    ``fusion``: "raymarch" (the default), "auto", "projective-level",
    "pallas" (the same path) or "projective"
    (pipeline/fusion_backend.py).  ``resume=True`` reopens the
    map, reloads the window around the last persisted pose and applies that
    pose as a world-frame offset to the restarted odometry.
    ``in_memory_map=True`` keeps the global map in memory (no h5py).

    ``mesh``: a ``parallel.sharded.Mesh``; the O(voxels) fusion then runs
    x-sharded over its ranks (the projective update on the level grid
    inside the tilt envelope, the attitude grid beyond it: kernel K1 on
    each rank's slab, whatever ``fusion`` says) and the window's x extent
    is rounded up to a multiple of the world size; ``device`` is the
    mesh's.  With more than one rank each rank shifts and persists only
    its own rows, into ``<map>.p<rank>.h5``.  ``window_size`` overrides
    the window (and skips odd-forcing), as in ``WarpsenseApp``."""

    def __init__(self, params: Params, map_path: str | Path | None = None,
                 capacity: int = 32768, max_range_mm: int = 50000,
                 fusion: str = "raymarch", resume: bool = False,
                 device="cuda", in_memory_map: bool = False, mesh=None,
                 window_size: tuple[int, int, int] | None = None):
        self.params = params
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.capacity = int(capacity)
        self.fusion = fusion
        m = params.map
        self._slab_rows = None
        if mesh is not None:
            from ..map.local_map import make_odd
            from ..parallel.sharded import slab_rows
            if window_size is None:
                sv = m.size_voxels
                n = mesh.world
                window_size = (-(-sv[0] // n) * n, make_odd(sv[1]),
                               make_odd(sv[2]))
            rows = slab_rows(mesh, window_size[0])    # validates the extent
            if mesh.world > 1:
                self._slab_rows = rows
                if not in_memory_map:
                    map_path = Path(map_path if map_path is not None
                                    else m.h5_path()).with_suffix(
                        f".p{mesh.rank}.h5")
        if in_memory_map:
            path = None
        else:
            path = Path(map_path) if map_path is not None else m.h5_path()
        self.global_map = GlobalMap(path, m.tau, m.initial_weight,
                                    truncate=not resume, meta={
            "tau": m.tau, "map_resolution": m.resolution,
            "max_weight": m.max_weight_scaled,
            "max_distance": m.max_distance,
            "map_size_x": m.size_voxels[0], "map_size_y": m.size_voxels[1],
            "map_size_z": m.size_voxels[2],
        })
        if window_size is not None:
            self.local_map = LocalMap(window_size, self.global_map,
                                      force_odd=False)
        else:
            self.local_map = LocalMap(m.size_voxels, self.global_map)
        # world-frame offset applied to every incoming F-LOAM pose
        self.pose_offset = np.eye(4)
        if resume:
            poses = self.global_map.read_poses()
            if len(poses):
                last = poses[-1]
                self.pose_offset[:3, :3] = _mat_from_quat(
                    last[3:7].astype(np.float64))
                self.pose_offset[:3, 3] = last[:3]          # stored meters
                self.local_map.load_window(np.floor(
                    last[:3] * 1000.0 / m.resolution).astype(np.int64))
        self.state = self._device_state()
        self.max_steps, self.max_isteps = plan_raymarch(
            m.tau, m.resolution, max_range_mm, params.lidar.channels,
            params.lidar.vfov)

        self.last_pcls: deque = deque()      # enrich queue, world frame (m)
        self.last_gicp_pose = np.eye(4)
        self.last_floam_pose = np.eye(4)
        self.last_shift_pose = self._to_mm(self.pose_offset)
        self.initialized = False
        self.gicp_path: list[np.ndarray] = []

    # ------------------------------------------------------------------ utils
    def _device_state(self):
        """The window on the device; with a mesh, this rank's slab."""
        if self.mesh is None:
            return self.local_map.device_state(self.device)
        from ..parallel.sharded import shard_state
        return shard_state(self.local_map.state, self.mesh)

    def _subsample(self, pts: np.ndarray, mask: np.ndarray):
        """Map-resolution voxel subsample onto the fixed capacity (vgicp.h
        subsample + the 1M-point cap, update_tsdf.h:33)."""
        res_m = self.params.map.resolution / 1000.0
        if len(pts) > self.capacity:
            stride = int(np.ceil(len(pts) / self.capacity))
            pts, mask = pts[::stride], mask[::stride]
        pad = self.capacity - len(pts)
        pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
        return voxel_downsample(
            torch.as_tensor(pts, dtype=torch.float32, device=self.device),
            torch.as_tensor(mask, device=self.device), res_m, self.capacity)

    def _tensor(self, pts_m: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pts_m, np.float32),
                               device=self.device)

    def _update_tsdf(self, pts_world_m, mask, pose_mm: np.ndarray) -> None:
        pts_mm = torch.round(pts_world_m * 1000.0).to(torch.int32)
        if self.mesh is not None:
            from ..parallel.sharded import tsdf_update_projective_sharded
            from .fusion_backend import grid_rotation_for
            m = self.params.map
            grid_rot, level = grid_rotation_for(pose_mm,
                                                self.params.lidar.vfov)
            tsdf_update_projective_sharded(
                self.state, pts_mm, mask,
                np.floor(np.asarray(pose_mm)[:3, 3] / m.resolution)
                .astype(np.int32),
                grid_rot, mesh=self.mesh, size=self.local_map.size,
                tau=m.tau, max_weight=m.max_weight_scaled,
                resolution=m.resolution,
                channels=self.params.lidar.channels,
                columns=self.params.lidar.hresolution,
                vfov_deg=self.params.lidar.vfov, level=level)
            return
        fuse_cloud(self.state, pts_mm, mask, pose_mm, params=self.params,
                   size=self.local_map.size, fusion=self.fusion,
                   max_steps=self.max_steps, max_isteps=self.max_isteps)

    def _maybe_shift(self, pose_mm: np.ndarray) -> None:
        """Synchronous shift, as the JAX back end does it; only the evicted
        and loaded slabs cross between device and host."""
        m = self.params.map
        dist = np.linalg.norm(
            (self.last_shift_pose[:3, 3] - pose_mm[:3, 3]) / 1000.0)
        if dist < m.shift:
            return
        self.last_shift_pose = pose_mm.copy()
        self.local_map.attach_device(self.state, x_rows=self._slab_rows)
        self.local_map.shift(
            np.floor(pose_mm[:3, 3] / m.resolution).astype(np.int64))
        self.state = self.local_map.detach_device()

    @staticmethod
    def _to_mm(pose_m: np.ndarray) -> np.ndarray:
        p = np.asarray(pose_m, np.float64).copy()
        p[:3, 3] *= 1000.0
        return p.astype(np.float32)

    # ------------------------------------------------------------------- step
    def process(self, cloud_m: np.ndarray, valid: np.ndarray,
                floam_pose: np.ndarray) -> np.ndarray | None:
        """One scan (sensor frame, meters) + its F-LOAM pose (meters).
        Returns the refined world pose (meters) when the TSDF update ran,
        None when gated away (mapping.cpp:78-80)."""
        floam_pose = self.pose_offset @ np.asarray(floam_pose, np.float64)
        fl = self.params.floam

        if not self.initialized:
            pts, mask = self._subsample(cloud_m, valid)
            world = self._tensor(pts.cpu().numpy() @ floam_pose[:3, :3].T
                                 + floam_pose[:3, 3])
            self.last_pcls.appendleft((world, mask))
            self.last_gicp_pose = floam_pose.copy()
            self.last_floam_pose = floam_pose.copy()
            self._update_tsdf(world, mask, self._to_mm(floam_pose))
            self.initialized = True
            return floam_pose.copy()

        distance = np.linalg.norm(self.last_floam_pose[:3, 3]
                                  - floam_pose[:3, 3])
        if distance <= self.params.map.update_distance:
            return None

        # initial transform: last gicp pose advanced by the floam delta
        # (mapping.cpp:82-96: rotate by dR on the right, pretranslate dt)
        dR = floam_pose[:3, :3] @ self.last_floam_pose[:3, :3].T
        dt = floam_pose[:3, 3] - self.last_floam_pose[:3, 3]
        initial = np.eye(4)
        initial[:3, :3] = self.last_gicp_pose[:3, :3] @ dR
        initial[:3, 3] = self.last_gicp_pose[:3, 3] + dt

        pts, mask = self._subsample(cloud_m, valid)
        transformed = self._tensor(pts.cpu().numpy() @ initial[:3, :3].T
                                   + initial[:3, 3])
        # enrich target from the last N world-frame clouds (mapping.cpp:
        # 22-37), padded to the enrich count like the JAX back end
        pcls = list(self.last_pcls)
        while len(pcls) < fl.enrich:
            pcls.append((torch.zeros_like(pcls[0][0]),
                         torch.zeros_like(pcls[0][1])))
        T, _ = vgicp_align(
            transformed, mask, torch.cat([p for p, _ in pcls]),
            torch.cat([m for _, m in pcls]), resolution=1.0,
            max_iterations=20, fitness_score_threshold=fl.vgicp_fitness_score)
        T = T.cpu().numpy().astype(np.float64)
        gicp_pose = T @ initial
        aligned = self._tensor(transformed.cpu().numpy() @ T[:3, :3].T
                               + T[:3, 3])
        self._update_tsdf(aligned, mask, self._to_mm(gicp_pose))

        self.last_gicp_pose = gicp_pose.copy()
        self.last_floam_pose = floam_pose.copy()
        self.last_pcls.appendleft((aligned, mask))
        if len(self.last_pcls) > fl.enrich:
            self.last_pcls.pop()

        pose_mm = self._to_mm(gicp_pose)
        # poses persist in METERS, like the warpsense pipeline
        self.global_map.write_pose(pose_mm[:3, 3], _quat_from_mat(gicp_pose[:3, :3]),
                                   scale=1000.0)
        self.gicp_path.append(gicp_pose.copy())
        self._maybe_shift(pose_mm)
        return gicp_pose.copy()

    def terminate(self) -> None:
        """Persist map + poses (mapping.cpp:157-194); with a mesh, this
        rank's rows of the map."""
        if self._slab_rows is None:
            self.local_map.absorb(self.state)
            self.local_map.write_back()
        else:
            self.local_map.attach_device(self.state, x_rows=self._slab_rows)
            self.local_map.write_back()
            self.local_map.detach_device()
        self.global_map.close()


class FeatsenseApp:
    """Full featsense loop: features -> odometry -> VGICP + TSDF mapping,
    all on ``device`` ("cuda", the default, or "cpu").  ``fusion``,
    ``in_memory_map``, ``mesh`` and ``window_size`` go to
    ``FeatsenseMapping`` (with a mesh, the device is the mesh's)."""

    def __init__(self, params: Params, map_path: str | Path | None = None,
                 feature_params: FeatureParams | None = None,
                 edge_capacity: int = 2048, surf_capacity: int = 4096,
                 cloud_capacity: int = 32768, profile: bool = False,
                 odom_kwargs: dict | None = None, fusion: str = "raymarch",
                 resume: bool = False, device="cuda",
                 in_memory_map: bool = False, mesh=None,
                 window_size: tuple[int, int, int] | None = None):
        self.params = params
        self.device = resolve_device(device if mesh is None else mesh.device)
        fl = params.floam
        self.feature_params = feature_params or FeatureParams(
            min_distance=fl.min_distance, max_distance=fl.max_distance,
            edge_threshold=fl.edge_threshold,
            surf_threshold=fl.surf_threshold)
        self.edge_capacity = edge_capacity
        self.surf_capacity = surf_capacity
        self.profile = profile
        self.eval = RuntimeEvaluator.get_instance()
        if profile:
            self.eval.use_device(self.device)
        kwargs = dict(edge_leaf=fl.edge_resolution,
                      optimization_steps=fl.optimization_steps)
        kwargs.update(odom_kwargs or {})
        self.odom = OdomEstimation(device=self.device, **kwargs)
        self.mapping = FeatsenseMapping(
            params, map_path, capacity=cloud_capacity, fusion=fusion,
            resume=resume, device=self.device, in_memory_map=in_memory_map,
            mesh=mesh, window_size=window_size)
        self.floam_path: list[np.ndarray] = []

    def features(self, cloud_m: np.ndarray):
        """Stage 1 on one organized (H, W, 3) scan in meters."""
        return extract_features(
            torch.as_tensor(np.asarray(cloud_m, np.float32),
                            device=self.device),
            params=self.feature_params, edge_capacity=self.edge_capacity,
            surf_capacity=self.surf_capacity)

    def process_scan(self, cloud_m: np.ndarray, stamp: float = 0.0
                     ) -> np.ndarray:
        """One organized scan (H, W, 3) float32 meters -> F-LOAM pose (m)."""
        prof = self.eval if self.profile else None
        if prof:
            prof.start("total")
            prof.start("features")
        (e_pts, e_mask, _), (s_pts, s_mask, _) = self.features(cloud_m)
        if prof:
            prof.stop("features")
            prof.start("odometry")
        floam_pose = self.odom.update(e_pts, e_mask, s_pts, s_mask)
        if prof:
            prof.stop("odometry")
            prof.start("mapping")
        flat = np.ascontiguousarray(cloud_m.reshape(-1, 3), dtype=np.float32)
        self.mapping.process(flat, np.any(flat != 0.0, axis=1), floam_pose)
        if prof:
            prof.stop("mapping")
            prof.stop("total")
        self.floam_path.append(floam_pose.copy())
        return floam_pose

    def trajectory(self) -> np.ndarray:
        return (np.stack(self.floam_path) if self.floam_path
                else np.zeros((0, 4, 4)))

    def terminate(self, csv_path: str | Path | None = None) -> None:
        self.mapping.terminate()
        if csv_path is not None:
            self.eval.export_results(csv_path)


class ThreadedFeatsenseRunner:
    """Pipeline-parallel featsense: the reference's four background threads
    joined by ring buffers (featsense.cpp:52-75), around the same stages.

    Stage threads: features -> odometry -> mapping -> visualization (the
    last drains ``pose_buffer`` into ``path`` and optionally appends a TUM
    trajectory file, the stand-in for the reference's TF broadcast,
    visualization.cpp:16-67).  Each stage owns its state, so the result
    equals ``FeatsenseApp.process_scan`` run in order."""

    def __init__(self, app: FeatsenseApp, queue_depth: int = 8,
                 viz_path: str | None = None):
        self.app = app
        self.cloud_buffer = ConcurrentRingBuffer(queue_depth)
        self.feature_buffer = ConcurrentRingBuffer(queue_depth)
        self.odom_buffer = ConcurrentRingBuffer(queue_depth)
        self.pose_buffer = ConcurrentRingBuffer(1024)
        self.viz_path = viz_path
        self.path: list[tuple[float, np.ndarray]] = []
        self.running = False
        self._threads: list[threading.Thread] = []

    def _upstream_alive(self, stage: int) -> bool:
        # a stage keeps draining while any earlier stage thread may still
        # push, not just while its own buffer is non-empty
        return any(t.is_alive() for t in self._threads[:stage])

    def _features_stage(self):
        while self.running or len(self.cloud_buffer):
            item = self.cloud_buffer.pop(timeout=0.05)
            if item is None:
                continue
            cloud, stamp = item
            feats = self.app.features(cloud)
            flat = np.ascontiguousarray(cloud.reshape(-1, 3),
                                        dtype=np.float32)
            self.feature_buffer.push((feats, flat, stamp))

    def _odometry_stage(self):
        app = self.app
        while (self.running or self._upstream_alive(1)
               or len(self.feature_buffer)):
            item = self.feature_buffer.pop(timeout=0.05)
            if item is None:
                continue
            ((e_pts, e_mask, _), (s_pts, s_mask, _)), flat, stamp = item
            pose = app.odom.update(e_pts, e_mask, s_pts, s_mask)
            app.floam_path.append(pose.copy())
            self.odom_buffer.push((flat, pose, stamp))

    def _mapping_stage(self):
        app = self.app
        while (self.running or self._upstream_alive(2)
               or len(self.odom_buffer)):
            item = self.odom_buffer.pop(timeout=0.05)
            if item is None:
                continue
            flat, pose, stamp = item
            refined = app.mapping.process(flat, np.any(flat != 0.0, axis=1),
                                          pose)
            self.pose_buffer.push_nb(
                (stamp, pose if refined is None else refined), force=True)

    def _viz_stage(self):
        fh = open(self.viz_path, "a") if self.viz_path else None
        try:
            while (self.running or self._upstream_alive(3)
                   or len(self.pose_buffer)):
                item = self.pose_buffer.pop(timeout=0.05)
                if item is None:
                    continue
                stamp, pose = item
                pose = np.asarray(pose)
                self.path.append((stamp, pose.copy()))
                if fh is not None:
                    q = _quat_from_mat(pose[:3, :3])
                    fh.write("%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n"
                             % (stamp, *pose[:3, 3], *q))
        finally:
            if fh is not None:
                fh.close()

    def start(self) -> None:
        self.running = True
        self._threads = [
            threading.Thread(target=self._features_stage, daemon=True),
            threading.Thread(target=self._odometry_stage, daemon=True),
            threading.Thread(target=self._mapping_stage, daemon=True),
            threading.Thread(target=self._viz_stage, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def submit(self, cloud_m: np.ndarray, stamp: float) -> None:
        self.cloud_buffer.push((cloud_m, stamp))

    def drain(self) -> None:
        """Stop accepting work and join once all queues are empty."""
        self.running = False
        for t in self._threads:
            t.join()
