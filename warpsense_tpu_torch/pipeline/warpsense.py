"""Warpsense pipeline: the per-scan SLAM step on tensors.

Counterpart of ``warpsense_tpu/pipeline/warpsense.py`` (reference
orchestration: src/warpsense/app.cpp:65-176, tsdf_mapping.cpp).  Per scan,
with ``registration.mode="fast"``:

preprocess -> (bootstrap) fusion -> packed fields (cached per map change)
-> adaptive-LM registration -> fusion at the refined pose -> ring-window
shift against the chunked global map.

With ``registration.mode="parity"`` (the config default) the step is the
reference's: voxel-center snapped preprocess -> gated fusion BEFORE
registration -> three-plane fields -> Gauss-Newton with the linear damping
ramp -> synchronous window shift; no velocity prior and no sane-step
gate.

The map lives on ``device`` as a ``LocalMapState``; fusion and shifts update
its value/weight tensors IN PLACE (the JAX app swaps in new immutable
states instead).  On a CUDA device fusion runs kernel K1 and, in fast
mode, the fields kernel K2; on the CPU their plain versions run.
"""
from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..core.config import Params
from ..core.geometry import to_int_mat, transform_point_fixed
from ..io.trajectory import _mat_from_quat, _quat_from_mat
from ..kernels.fields import fields_parity
from ..map.global_map import GlobalMap
from ..map.local_map import LocalMap, clone_state
from ..obs.profiler import RuntimeEvaluator
from ..ops.preprocess import preprocess
# precompute_fields, which the app no longer calls, stays a name of this
# module: benchmark/harness/cell.py's tracer wraps it by name
from ..ops.registration import (precompute_fields,  # noqa: F401
                                precompute_fields_packed_auto,
                                register_cloud_fields, register_cloud_packed)
from ..ops.tsdf import plan_raymarch
from ..utils.device import resolve_device
from ..utils.filter import SlidingWindowFilter
from ..utils.imu import ImuAccumulator, ImuSample
from ..utils.ring_buffer import ConcurrentRingBuffer
from .fusion_backend import fuse_cloud


class WarpsenseApp:
    """Single-GPU warpsense loop fed by ``cloud_callback``/``imu_callback``.

    ``device``: "cuda" (the default) or "cpu"; a CUDA device without a
    GPU raises.  ``map_path``: HDF5 output (default params.map.h5_path());
    ``in_memory_map=True`` keeps the global map in memory instead (no
    h5py needed, nothing persisted).  ``capacity``: static preprocessed-
    cloud capacity.  ``max_range_mm``: the ray march's range budget
    (``plan_raymarch``).  ``fusion``: "auto", "projective-level",
    "pallas" (the same path), "projective" or "raymarch" (see
    pipeline/fusion_backend.py).
    ``sync_shift=True`` shifts the window at the triggering scan instead
    of on a worker thread (bitwise-reproducible runs; parity mode always
    shifts synchronously).  ``resume=True`` reopens the map file and
    continues from its last pose.  ``monitor``: an optional
    ``obs.live.LiveMonitor`` that receives the pose (with the scan's host
    time) and a copy of the map after each scan, and each window shift
    before it happens.  ``profile=True`` times the scan's layers as spans
    of ``self.eval`` (``obs.profiler.RuntimeEvaluator``): "total", "glue"
    (subsample, pad, the copies to the device), "preprocessing", "tsdf",
    "registration" and its "fields", "shift" and its phases (see
    ``map.local_map.LocalMap``), each until the work it launched is done,
    with no synchronisation of its own.  The fields-cache counters
    (``fields_cache_hit``, ``fields_cache_miss``) always count.
    """

    def __init__(self, params: Params, map_path: str | Path | None = None,
                 capacity: int = 32768, max_range_mm: int = 50000,
                 profile: bool = False, fusion: str = "auto",
                 resume: bool = False, exact_fields: bool = False,
                 force_odd: bool = True,
                 window_size: tuple[int, int, int] | None = None,
                 sync_shift: bool = False, device="cuda",
                 in_memory_map: bool = False, monitor=None):
        if params.registration.mode not in ("fast", "parity"):
            raise ValueError(
                f"unknown registration.mode {params.registration.mode!r}")
        self.device = resolve_device(device)
        self.eval = RuntimeEvaluator.get_instance()
        if profile:
            self.eval.use_device(self.device)
        prof = self.eval if profile else None
        self._scans = 0            # cloud_callback calls: the scan ids
        self.params = params
        self._sync_shift = bool(sync_shift)
        self.capacity = int(capacity)
        self.profile = profile
        self.monitor = monitor
        self.fusion = fusion
        self.exact_fields = exact_fields
        self._fields = None      # cached registration fields (per map epoch)
        self.last_reg_iters = 0
        self.last_reg_err = float("nan")
        m = params.map
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
        }, evaluator=prof)
        self.local_map = LocalMap(window_size or m.size_voxels,
                                  self.global_map, force_odd=force_odd,
                                  evaluator=prof)

        self.pose = np.eye(4, dtype=np.float32)  # mm translation
        self._prev_pose = None     # previous scan's pose (velocity prior)
        self._reg_healthy = False  # last registration made a real step
        self.initialized = False
        if resume:
            poses = self.global_map.read_poses()
            if len(poses):
                last = poses[-1]
                self.pose[:3, :3] = _mat_from_quat(
                    last[3:7].astype(np.float64)).astype(np.float32)
                self.pose[:3, 3] = last[:3] * 1000.0     # stored in meters
                self.local_map.load_window(
                    np.floor(self.pose[:3, 3] / m.resolution).astype(np.int64))
                self.initialized = True
        self.state = self._device_state()
        self.last_tsdf_pose = self.pose.copy()
        self.last_shift_pose = self.pose.copy()
        self.shifted = False
        self.path: list[np.ndarray] = []

        self._shift_thread = None
        self._shift_error: BaseException | None = None
        self._pending_fusion: list = []
        self._rng = np.random.default_rng(0)
        self.imu_buffer = ConcurrentRingBuffer(1000)
        self.imu_filter = SlidingWindowFilter(10)
        self.imu_acc = ImuAccumulator(self.imu_buffer)
        self.max_steps, self.max_isteps = plan_raymarch(
            m.tau, m.resolution, max_range_mm, params.lidar.channels,
            params.lidar.vfov)

    def _device_state(self):
        """The window on the device (a seam: the sharded app places its
        slab)."""
        return self.local_map.device_state(self.device)

    # ------------------------------------------------------------- callbacks
    def imu_callback(self, sample: ImuSample) -> None:
        """Gyro smoothing (window 10) + buffering; parity app.cpp:54-63."""
        filtered = self.imu_filter.update(sample.angular_velocity)
        self.imu_buffer.push_nb(
            ImuSample(sample.stamp, np.asarray(filtered)), force=True)

    def cloud_callback(self, cloud_m: np.ndarray, stamp: float) -> np.ndarray:
        """One scan: preprocess -> gated fusion -> register -> pose.

        ``cloud_m``: (..., 3) float32 meters in the SENSOR frame (organized
        scans are flattened); zero rows are invalid.  Returns the updated
        4x4 pose (mm)."""
        t0 = time.perf_counter()
        prof = self.eval if self.profile else None
        self._scans += 1
        if prof:
            prof.set_scan(self._scans - 1)
            prof.start("total")
        self._collect_shift()
        m = self.params.map
        fast = self.params.registration.mode == "fast"
        if prof:
            prof.start("glue")
        flat = np.ascontiguousarray(cloud_m.reshape(-1, 3), np.float32)
        if len(flat) > self.capacity:
            # static-shape budget: uniform random subsample (a stride on an
            # organized scan would alias azimuth columns systematically)
            keep = self._rng.choice(len(flat), self.capacity, replace=False)
            flat = flat[np.sort(keep)]
        pad = np.zeros((self.capacity - len(flat), 3), np.float32)
        cloud = torch.as_tensor(np.concatenate([flat, pad]),
                                device=self.device)
        valid = torch.as_tensor(
            np.concatenate([np.any(flat != 0.0, axis=1),
                            np.zeros(len(pad), bool)]), device=self.device)
        if prof:
            prof.stop("glue")
            prof.start("preprocessing")
        # fast mode keeps TRUE point coordinates through dedup; parity
        # mode snaps them to voxel centers like the reference
        pts, mask = preprocess(cloud, valid,
                               torch.as_tensor(self.pose, device=self.device),
                               resolution=m.resolution,
                               capacity=self.capacity, snap=not fast)
        if prof:
            prof.stop("preprocessing")

        # parity mode fuses BEFORE registering, at the stale pose, like the
        # reference (app.cpp:65-117); fast mode fuses AFTER registration at
        # the refined pose, and only the bootstrap (first scan) fuses
        # first — there is nothing to register against yet
        dist_tsdf = np.linalg.norm(
            (self.last_tsdf_pose[:3, 3] - self.pose[:3, 3]) / 1000.0)
        want_fuse = (not self.initialized or dist_tsdf > m.update_distance
                     or self.shifted)
        if want_fuse and (not fast or not self.initialized):
            self.initialized = True
            self.shifted = False
            self.last_tsdf_pose = self.pose.copy()
            self._timed_fuse(prof, pts, mask)
            want_fuse = False

        pretransform = self.imu_acc.acc_transform(stamp).astype(np.float32)
        # the IMU delta rotates about the CURRENT sensor position
        dR = pretransform[:3, :3]
        pretransform[:3, 3] += (np.eye(3, dtype=np.float32) - dR) \
            @ self.pose[:3, 3]
        imu_only = pretransform.copy()
        if (fast and self.params.registration.velocity_prior
                and self._prev_pose is not None and self._reg_healthy):
            # constant-velocity translation seed, only after a HEALTHY
            # registration (else extrapolation is a ballistic runaway)
            pretransform[:3, 3] += self.pose[:3, 3] - self._prev_pose[:3, 3]
        self._prev_pose = self.pose.copy()

        if prof:
            prof.start("registration")
        transform = self._register(pts, mask, pretransform, prof)
        if prof:
            prof.stop("registration")
        if fast:     # the reference (parity mode) has no sane-step gate
            sane = self.params.registration.sane_step_m
            delta = (transform @ self.pose)[:3, 3] - self.pose[:3, 3]
            if sane > 0 and float(np.linalg.norm(delta)) > sane * 1000.0:
                # implausible per-scan motion: keep the IMU-only prior
                transform = imu_only.astype(np.float32)
                self._reg_healthy = False
            else:
                # a bit-exact pretransform return means no accepted step
                self._reg_healthy = not np.array_equal(
                    transform, pretransform.astype(np.float32))

        # pose <- transform @ pose (full SE3 composition)
        self.pose = (transform @ self.pose).astype(np.float32)
        if want_fuse:
            # fuse at the REFINED pose: re-transform the map-frame points
            # by the registration delta first
            self.initialized = True
            self.shifted = False
            self.last_tsdf_pose = self.pose.copy()
            pts_ref = transform_point_fixed(
                pts, to_int_mat(torch.as_tensor(transform,
                                                device=self.device)))
            if self._shift_thread is not None:
                # window swap in flight: queue with the capture pose
                self._pending_fusion.append((pts_ref, mask, self.pose.copy()))
            else:
                self._timed_fuse(prof, pts_ref, mask)
        self.path.append(self.pose.copy())
        self.global_map.write_pose(
            self.pose[:3, 3],
            _quat_from_mat(self.pose[:3, :3]),
            scale=1000.0)
        self._maybe_shift(prof)
        if prof:
            prof.stop("total")
        self._publish(stamp, (time.perf_counter() - t0) * 1e3)
        return self.pose.copy()

    def _publish(self, stamp: float, scan_ms: float) -> None:
        """The reference's per-scan TF/path publish and marker cloud
        (app.cpp:150-170, publish.h:11-93), to the monitor if any (a seam:
        the sharded app gathers the window from its ranks); ``scan_ms``:
        the scan's host time so far."""
        if self.monitor is None:
            return
        m = self.params.map
        self.monitor.publish_pose(stamp, self.pose, timing_ms=scan_ms)
        self.monitor.publish_map(self.state, resolution=m.resolution,
                                 tau=m.tau)

    # -------------------------------------------------------------- internals
    def _timed_fuse(self, prof, pts, mask) -> None:
        if prof:
            prof.start("tsdf")
        self._update_tsdf(pts, mask)
        if prof:
            prof.stop("tsdf")

    def _register(self, pts, mask, pretransform, prof=None) -> np.ndarray:
        """Cached fields + GN/LM loop; the refining 4x4 as numpy.  With
        ``prof``, the fields precompute is also timed on its own
        ("fields", nested in "registration")."""
        m = self.params.map
        reg = self.params.registration
        fast = reg.mode == "fast"
        if self._fields is None:
            self.eval.count("fields_cache_miss")
            if prof:
                prof.start("fields")
            self._fields = (precompute_fields_packed_auto(
                self.state, tau=m.tau, exact=self.exact_fields) if fast
                else fields_parity(self.state))
            if prof:
                prof.stop("fields")
        else:
            self.eval.count("fields_cache_hit")
        if not fast:
            transform = register_cloud_fields(
                self._fields, self.state.pos, self.state.offset, pts, mask,
                torch.as_tensor(pretransform, device=self.device),
                size=self.local_map.size, resolution=m.resolution,
                max_iterations=reg.max_iterations,
                it_weight_gradient=reg.it_weight_gradient,
                epsilon=reg.epsilon, mode=reg.mode)
            return transform.cpu().numpy()
        transform, iters, err = register_cloud_packed(
            self._fields, self.state.pos, self.state.offset, pts, mask,
            torch.as_tensor(pretransform, device=self.device),
            size=self.local_map.size, resolution=m.resolution, tau=m.tau,
            max_iterations=reg.max_iterations,
            it_weight_gradient=reg.it_weight_gradient,
            epsilon=reg.epsilon,
            coarse_iterations=reg.coarse_iterations,
            gather_freeze=reg.gather_freeze)
        self.last_reg_iters = iters
        self.last_reg_err = err
        return transform.cpu().numpy()

    def _update_tsdf(self, pts, mask, pose: np.ndarray | None = None) -> None:
        """Fuse a map-frame cloud captured at ``pose`` (default: the current
        pose), in place."""
        if pose is None:
            pose = self.pose
        fuse_cloud(self.state, pts, mask, pose, params=self.params,
                   size=self.local_map.size, fusion=self.fusion,
                   max_steps=self.max_steps, max_isteps=self.max_isteps)
        self._fields = None      # map changed: registration fields stale

    def _collect_shift(self) -> None:
        """Swap in a completed async shift; fuse the scans queued while it
        was in flight (mapping.cpp:115-129)."""
        t = self._shift_thread
        if t is None or t.is_alive():
            return
        t.join()
        self._shift_thread = None
        if self._shift_error is not None:
            err, self._shift_error = self._shift_error, None
            self.last_shift_pose = self._pre_shift_pose
            raise RuntimeError("async map shift failed") from err
        self.state = self._finish_async_shift()
        self.shifted = True
        self._fields = None      # window moved: registration fields stale
        pending, self._pending_fusion = self._pending_fusion, []
        for pts, mask, pose in pending:
            self._update_tsdf(pts, mask, pose=pose)

    def _finish_async_shift(self):
        """The post-shift device state of a completed async shift (a seam:
        the sharded app finishes its staged shift here)."""
        return self.local_map.detach_device()

    def _maybe_shift(self, prof=None) -> None:
        """Shift the ring window once the pose wandered >= map.shift meters
        from the last shift pose (tsdf_mapping.cpp:97-136).

        Async (fast-mode default): a worker thread shifts a CLONE of the
        window while registration keeps using the current one; only the
        evicted/loaded slabs cross between device and host.
        ``sync_shift`` and parity mode: shift the current window in place,
        now, through the same slab path (the reference's synchronous
        shift; its window contents, pos and offset are the same as a
        whole-window host round trip gives)."""
        m = self.params.map
        if self._shift_thread is not None:
            return                     # one shift in flight at a time
        dist = np.linalg.norm(
            (self.last_shift_pose[:3, 3] - self.pose[:3, 3]) / 1000.0)
        if dist < m.shift:
            return
        self._pre_shift_pose = self.last_shift_pose
        self.last_shift_pose = self.pose.copy()
        new_pos = np.floor(self.pose[:3, 3] / m.resolution).astype(np.int64)
        if self.monitor is not None:
            self.monitor.publish_shift(new_pos)   # the skeleton publish
        if self.params.registration.mode != "fast" or self._sync_shift:
            if prof:
                prof.start("shift")
            self.local_map.attach_device(self.state)
            self.local_map.shift(new_pos)
            self.state = self.local_map.detach_device()
            self.shifted = True
            self._fields = None
            if prof:
                prof.stop("shift")
            return
        self.local_map.attach_device(clone_state(self.state))
        scan = self._scans - 1

        def work():
            if prof:      # the worker's spans belong to the scan that began it
                prof.set_scan(scan)
            try:
                self.local_map.shift(new_pos)
            except BaseException as e:      # surfaced in _collect_shift
                self._shift_error = e
        self._shift_thread = threading.Thread(target=work, daemon=True)
        self._shift_thread.start()

    # --------------------------------------------------------------- shutdown
    def terminate(self, csv_path: str | Path | None = None) -> None:
        """Persist map + poses; parity with App::terminate (app.cpp:190-225)."""
        self.imu_buffer.clear()
        if self._shift_thread is not None:
            self._shift_thread.join()
        self._collect_shift()
        self.local_map.absorb(self.state)
        self.local_map.write_back()
        if csv_path is not None:
            self.eval.export_results(csv_path)
        self.global_map.close()

    def trajectory(self) -> np.ndarray:
        return np.stack(self.path) if self.path else np.zeros((0, 4, 4))
