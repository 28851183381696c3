"""Fastsense pipeline: the reference's third SLAM app, on tensors.

Counterpart of ``warpsense_tpu/pipeline/fastsense.py`` (behavioral parity
with the reference's ``src/cpu/fastsense.cpp``, whose distinguishing
features against warpsense are its orchestration, not its math):

* registration runs EVERY scan against the currently published map while
  TSDF update + map shift + visualization run in a side thread over a
  copy of the map, triggered every ``update_frequency`` scans or
  ``update_distance_m`` meters (fastsense.cpp:88-118, 239-254);
* the IMU pretransform is the *orientation difference* of
  (Madgwick-)filtered absolute orientations (fastsense.cpp:181-212);
* ``terminate`` joins the side thread and persists map + poses
  (fastsense.cpp:58-86).

Copy-on-write.  The JAX worker builds a new immutable state; here
``tsdf_update_projective`` fuses IN PLACE, so the worker fuses a private
copy and swaps the new (state, fields) pair in under ``_snap_lock``: a
registration in flight keeps reading its snapshot, which nothing writes.
After a shift the copy is the fresh window ``LocalMap.device_state``
builds; an update without a voxel move clones the published state
(``map.local_map.clone_state``).

Streams.  On a CUDA device the worker runs on a stream of its own, so the
update overlaps the registration on the caller's stream.  Before the swap
it synchronizes that stream, and it marks every published tensor as used
on the caller's stream (``record_stream``), so the caching allocator does
not hand a dropped snapshot's memory to the worker while the caller's
kernels may still read it.

Every fusion bins with the sensor attitude (``level=False``): on the card
it is a launch of kernel K1's general sweep.  Registration is
``register_cloud_fields`` on the three-plane fields in
``params.registration.mode``, as in the JAX app.
"""
from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..core.config import Params
from ..io.trajectory import _quat_from_mat
from ..kernels.fields import fields_parity
from ..map.global_map import GlobalMap
from ..map.local_map import LocalMap, clone_state
from ..obs.profiler import RuntimeEvaluator
from ..ops.preprocess import preprocess
from ..ops.registration import register_cloud_fields
from ..ops.tsdf_projective import tsdf_update_projective
from ..utils.device import resolve_device
from ..utils.imu import ImuOrientationDiff, ImuSample, MadgwickFilter
from ..utils.ring_buffer import ConcurrentRingBuffer


class FastsenseApp:
    """Single-process fastsense loop: inline registration, async mapping.

    ``update_frequency`` / ``update_distance_m``: the shift-update-visualize
    gate (every 100 scans or 0.25 m in the reference, fastsense.cpp:239-243).
    ``viz_dir``: when set, the worker exports a TSDF PLY per update (the
    reference's RViz marker publish, fastsense.cpp:112-116).
    ``device``: "cuda" (the default) or "cpu"; a CUDA device without a GPU
    raises.  ``in_memory_map=True`` keeps the global map in memory (no
    h5py needed, nothing persisted).  ``profile=True`` times the
    "total" and "registration" spans (``RuntimeEvaluator``), records each
    scan's GN iterations (``gn_iterations``) and times each published
    update's steps (``update_ms``: shift or clone, fusion, fields).
    """

    def __init__(self, params: Params, map_path: str | Path | None = None,
                 capacity: int = 32768, update_frequency: int = 100,
                 update_distance_m: float = 0.25,
                 viz_dir: str | Path | None = None, profile: bool = False,
                 device="cuda", in_memory_map: bool = False):
        self.device = resolve_device(device)
        self.params = params
        self.capacity = int(capacity)
        self.update_frequency = int(update_frequency)
        self.update_distance_m = float(update_distance_m)
        self.viz_dir = Path(viz_dir) if viz_dir is not None else None
        self.profile = profile
        m = params.map
        if in_memory_map:
            path = None
        else:
            path = Path(map_path) if map_path is not None else m.h5_path()
        self.global_map = GlobalMap(path, m.tau, m.initial_weight, meta={
            "tau": m.tau, "map_resolution": m.resolution,
            "max_weight": m.max_weight_scaled,
            "max_distance": m.max_distance,
            "map_size_x": m.size_voxels[0], "map_size_y": m.size_voxels[1],
            "map_size_z": m.size_voxels[2],
        })
        self.local_map = LocalMap(m.size_voxels, self.global_map)

        cuda = self.device.type == "cuda"
        # the caller's (registration) stream and the worker's own
        self._consumer_stream = (torch.cuda.current_stream(self.device)
                                 if cuda else None)
        self._worker_stream = torch.cuda.Stream(self.device) if cuda else None

        # (state, fields) snapshot published to the registration path; only
        # the worker thread replaces it (copy-on-write swap,
        # fastsense.cpp:105-109)
        self._snap_lock = threading.Lock()
        self.state = self.local_map.device_state(self.device)
        self._fields = None
        self.updates_published = 0
        self.update_ms: list[dict] = []
        self.gn_iterations: list[int] = []

        self.pose = np.eye(4, dtype=np.float32)     # mm translation
        self.initialized = False
        self.scan_count = 0
        self.last_update_pose = np.eye(4, dtype=np.float32)
        self.path: list[np.ndarray] = []

        self.imu_buffer = ConcurrentRingBuffer(1000)
        self.imu_diff = ImuOrientationDiff(self.imu_buffer)
        # raw gyro+accel samples are filtered in-process — the role of the
        # reference's external imu_filter_madgwick node (imu_filter.launch)
        self.madgwick = MadgwickFilter()

        self._jobs = ConcurrentRingBuffer(1)
        self._jobs_submitted = 0
        self._jobs_done = 0
        self._worker_error: BaseException | None = None
        self._done_cv = threading.Condition()
        self._worker = threading.Thread(target=self._worker_run, daemon=True)
        self._worker_running = True
        self._worker.start()
        self.eval = RuntimeEvaluator.get_instance()
        if self.profile:
            self.eval.use_device(self.device)

    # ------------------------------------------------------------- callbacks
    def imu_callback(self, sample: ImuSample,
                     linear_acceleration=None) -> None:
        """Buffer an orientation-carrying IMU sample (fastsense.cpp:120-125).
        A RAW sample (``orientation is None``) is run through the
        in-process Madgwick filter first, with ``linear_acceleration`` as
        the gravity observation."""
        if sample.orientation is None:
            accel = (np.zeros(3) if linear_acceleration is None
                     else linear_acceleration)
            sample = self.madgwick.filter_sample(sample, accel)
        self.imu_buffer.push_nb(sample, force=True)

    def cloud_callback(self, cloud_m: np.ndarray, stamp: float) -> np.ndarray:
        """One scan (fastsense.cpp:127-254).  Returns the new 4x4 pose (mm)."""
        self._raise_worker_error()
        prof = self.eval if self.profile else None
        if prof:
            prof.start("total")
        m = self.params.map
        reg = self.params.registration
        flat = np.ascontiguousarray(cloud_m.reshape(-1, 3), np.float32)
        if len(flat) > self.capacity:
            stride = int(np.ceil(len(flat) / self.capacity))
            flat = flat[::stride]
        pad = np.zeros((self.capacity - len(flat), 3), np.float32)
        cloud = torch.as_tensor(np.concatenate([flat, pad]),
                                device=self.device)
        valid = torch.as_tensor(
            np.concatenate([np.any(flat != 0.0, axis=1),
                            np.zeros(len(pad), bool)]), device=self.device)
        pts, mask = preprocess(cloud, valid,
                               torch.as_tensor(self.pose, device=self.device),
                               resolution=m.resolution, capacity=self.capacity)

        if not self.initialized:
            # first-scan bootstrap map update, synchronous
            # (fastsense.cpp:168-174); it fuses the state made in
            # __init__ in place, which no registration has read yet
            self.initialized = True
            self._update(self.state, pts, mask, self.pose, {})
            self.last_update_pose = self.pose.copy()

        pretransform = self.imu_diff.pretransform(stamp).astype(np.float32)
        dR = pretransform[:3, :3]
        pretransform[:3, 3] += (np.eye(3, dtype=np.float32) - dR) \
            @ self.pose[:3, 3]

        with self._snap_lock:
            state, fields = self.state, self._fields
        if prof:
            prof.start("registration")
        transform, iterations = register_cloud_fields(
            fields, state.pos, state.offset, pts, mask,
            torch.as_tensor(pretransform, device=self.device),
            size=self.local_map.size, resolution=m.resolution,
            max_iterations=reg.max_iterations,
            it_weight_gradient=reg.it_weight_gradient,
            epsilon=reg.epsilon, mode=reg.mode, return_iterations=True)
        transform = transform.cpu().numpy()
        if prof:
            prof.stop("registration")
            self.gn_iterations.append(iterations)

        self.pose = (transform @ self.pose).astype(np.float32)
        self.path.append(self.pose.copy())
        self.global_map.write_pose(self.pose[:3, 3],
                                   _quat_from_mat(self.pose[:3, :3]),
                                   scale=1000.0)

        # shift-update-visualize gate: every N scans or D meters
        # (fastsense.cpp:239-243); the job carries the scan so the async
        # update fuses the exact cloud that crossed the gate
        self.scan_count += 1
        dist = np.linalg.norm(
            (self.last_update_pose[:3, 3] - self.pose[:3, 3]) / 1000.0)
        if (self.scan_count % self.update_frequency == 0
                or dist > self.update_distance_m):
            self.last_update_pose = self.pose.copy()
            ready = None
            if self._consumer_stream is not None:
                # the worker's stream waits for this scan's preprocess
                ready = torch.cuda.Event()
                ready.record(self._consumer_stream)
            # the reference joins the previous thread before spawning a
            # new one (fastsense.cpp:246-249): a blocking hand-off, never a
            # dropped job
            self._jobs_submitted += 1
            self._jobs.push((pts, mask, self.pose.copy(), ready))
        if prof:
            prof.stop("total")
        return self.pose.copy()

    # --------------------------------------------------------------- mapping
    def _lap(self, times: dict, name: str, t0: float) -> float:
        """With ``profile``, the step's wall time up to now (ms, after its
        stream's work) into ``times``; returns the new start."""
        if not self.profile:
            return t0
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        now = time.perf_counter()
        times[name] = (now - t0) * 1000.0
        return now

    def _update(self, state, pts, mask, pose_mm: np.ndarray,
                times: dict) -> None:
        """Fuse the scan into ``state`` IN PLACE, compute its fields and
        publish the pair; ``state`` must be a copy that no registration
        reads.  Runs on the worker (or, for the bootstrap, the caller) and
        its current stream."""
        m = self.params.map
        lidar = self.params.lidar
        t0 = time.perf_counter()
        scanner_pos = torch.as_tensor(
            np.floor(pose_mm[:3, 3] / m.resolution).astype(np.int32),
            device=self.device)
        tsdf_update_projective(
            state, pts, mask, scanner_pos,
            torch.as_tensor(pose_mm[:3, :3], dtype=torch.float32),
            size=self.local_map.size, tau=m.tau,
            max_weight=m.max_weight_scaled, resolution=m.resolution,
            channels=lidar.channels, columns=lidar.hresolution,
            vfov_deg=lidar.vfov, level=False)
        t0 = self._lap(times, "fusion", t0)
        fields = fields_parity(state)
        self._lap(times, "fields", t0)
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            stream.synchronize()
            if stream != self._consumer_stream:
                for t in (*state, *fields):
                    t.record_stream(self._consumer_stream)
        with self._snap_lock:
            self.state = state
            self._fields = fields
            self.updates_published += 1
        if self.profile:
            self.update_ms.append(times)

    def _worker_job(self, pts, mask, pose_mm, ready) -> None:
        """shift_update_visualize twin (fastsense.cpp:88-118)."""
        m = self.params.map
        times: dict = {}
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
            pts.record_stream(self._worker_stream)
            mask.record_stream(self._worker_stream)
        t0 = time.perf_counter()
        state = self.state   # the worker is the only writer => safe read
        new_pos = np.floor(pose_mm[:3, 3] / m.resolution).astype(np.int64)
        if np.any(new_pos != state.pos.cpu().numpy()):
            self.local_map.absorb(state)
            self.local_map.shift(new_pos)
            state = self.local_map.device_state(self.device)   # a new copy
            self._lap(times, "shift", t0)
        else:
            # the published snapshot stays unchanged for registrations in
            # flight: the device analogue of the reference's local-map copy
            # constructor (hdf5_local_map.cpp:22-31)
            state = clone_state(state)
            self._lap(times, "clone", t0)
        self._update(state, pts, mask, pose_mm, times)
        if self.viz_dir is not None:
            from ..obs.viz import export_tsdf_ply
            self.viz_dir.mkdir(parents=True, exist_ok=True)
            export_tsdf_ply(
                self.viz_dir / f"tsdf_{self.scan_count:06d}.ply",
                self.state, resolution=m.resolution, tau=m.tau)

    def _worker_run(self) -> None:
        """Serialized mapping jobs on the worker's own stream."""
        if self._worker_stream is not None:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._worker_stream):
                self._worker_loop()
        else:
            self._worker_loop()

    def _worker_loop(self) -> None:
        while True:
            job = self._jobs.pop(timeout=0.1)
            if job is None:
                if not self._worker_running:
                    return
                continue
            try:
                self._worker_job(*job)
            except BaseException as e:      # surfaced on the caller
                self._worker_error = e
            with self._done_cv:
                self._jobs_done += 1
                self._done_cv.notify_all()

    def _raise_worker_error(self) -> None:
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise RuntimeError("fastsense map update failed") from err

    def sync(self, timeout: float | None = None) -> None:
        """Block until every enqueued mapping job has been published — the
        deterministic analogue of the reference's thread join
        (fastsense.cpp:246-249); for tests and offline replay."""
        with self._done_cv:
            self._done_cv.wait_for(
                lambda: self._jobs_done >= self._jobs_submitted, timeout)
        self._raise_worker_error()

    # --------------------------------------------------------------- shutdown
    def terminate(self, csv_path: str | Path | None = None) -> None:
        """Join the side thread, persist map + poses (fastsense.cpp:58-86)."""
        self._worker_running = False
        self._worker.join()
        self._raise_worker_error()
        self.imu_buffer.clear()
        self.local_map.absorb(self.state)
        self.local_map.write_back()
        if csv_path is not None:
            self.eval.export_results(csv_path)
        self.global_map.close()

    def trajectory(self) -> np.ndarray:
        return np.stack(self.path) if self.path else np.zeros((0, 4, 4))
