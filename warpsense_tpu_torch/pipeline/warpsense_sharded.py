"""Multi-GPU warpsense: the pipeline application over a process group.

Counterpart of ``warpsense_tpu/pipeline/warpsense_sharded.py`` (the
reference has no distributed layer; its orchestration is
``App::cloud_callback``, src/warpsense/app.cpp:65-117, and the async shift
thread, tsdf_mapping.cpp:97-136, on one GPU).  Every rank runs this app on
the same scans:

* the window (value, weight) is x-sharded over the ranks, ``pos`` and
  ``offset`` replicated (parallel/sharded.py);
* per scan: preprocess -> (gated) sharded projective fusion (kernel K1 on
  each rank's slab, no communication) -> sharded packed fields (kernel K2
  on each slab padded with its halo planes), cached across scans until a
  fusion or a shift -> sharded LM registration (statistics summed in rank
  order, so every rank takes the same decisions and holds the same pose);
* the window shift runs through ``LocalMap.attach_device`` on the rank's
  slab, scoped to its rows (``x_rows``): each rank evicts, loads and
  persists only its rows, into its own map file ``<map>.p<rank>.h5``
  (``eval/merge_maps.py`` folds them into one);
* the live monitor (``monitor=``, on any ranks): each rank with one
  publishes the pose after every scan and each shift before it happens;
  whether a map snapshot is due is decided for all ranks at once (each
  monitor's rate limit, one all-reduce), and a due snapshot is the whole
  window gathered from the slabs in rank order, published on every rank
  with a monitor.  Without a monitor on any rank a scan calls no
  collective for it;
* persistence, resume, the IMU pretransform and profiling are
  ``WarpsenseApp``'s.
"""
from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import torch

from ..core.config import Params
from ..map.local_map import make_odd
from ..parallel.distributed import gather_state
from ..parallel.sharded import (any_rank, make_mesh,
                                precompute_fields_packed_sharded,
                                register_cloud_packed_sharded, shard_state,
                                slab_rows, tsdf_update_projective_sharded)
from .fusion_backend import grid_rotation_for
from .warpsense import WarpsenseApp


class ShardedWarpsenseApp(WarpsenseApp):
    """Warpsense with its window sharded over the ranks of ``mesh`` (a
    ``parallel.sharded.Mesh``; default: this process's mesh over the
    initialized default group, a world of one without one, on
    ``device``).

    The window's x extent is rounded UP to a multiple of the world size
    (an even extent spans the floor convention of map/local_map.py); y
    and z are forced odd like the reference.  Fast mode only
    (``registration.mode == "fast"``, ``coarse_iterations == 0``).  Every
    rank must construct the app at the same point (with a group, one
    collective finds whether any rank has a ``monitor``).

    ``sync_shift=False`` (the default) at a world of one overlaps the
    window shift with the following scans through the staged shift
    (``LocalMap.begin_shift`` / ``shift_io`` / ``finish_shift``: the
    worker thread does global-map IO only, every device copy stays on the
    caller's thread).  With more than one rank the shift is always
    synchronous: every rank must swap at the same scan."""

    def __init__(self, params: Params, mesh=None,
                 map_path: str | Path | None = None,
                 window_size: tuple[int, int, int] | None = None,
                 sync_shift: bool = False, device="cuda", **kwargs):
        self.mesh = mesh if mesh is not None else make_mesh(device)
        n = self.mesh.world
        if params.registration.mode != "fast":
            raise ValueError(
                "ShardedWarpsenseApp runs the fast generation; got "
                f"registration.mode={params.registration.mode!r}")
        if params.registration.coarse_iterations:
            raise ValueError(
                "coarse_iterations is not supported by the sharded "
                "registration (register_cloud_packed_sharded); set it to 0")
        if window_size is None:
            sv = params.map.size_voxels
            window_size = (-(-sv[0] // n) * n, make_odd(sv[1]),
                           make_odd(sv[2]))
        window_size = tuple(int(s) for s in window_size)
        self._slab_rows = None
        if n > 1:
            # each rank persists its own rows into its own file
            self._slab_rows = slab_rows(self.mesh, window_size[0])
            if not kwargs.get("in_memory_map"):
                if map_path is None:
                    map_path = params.map.h5_path()
                map_path = Path(map_path).with_suffix(
                    f".p{self.mesh.rank}.h5")
        self._shift_plan = None
        super().__init__(params, map_path=map_path, force_odd=False,
                         window_size=window_size, sync_shift=sync_shift,
                         device=self.mesh.device, **kwargs)
        # the same on every rank: whether any rank publishes
        self._monitored = any_rank(self.mesh, self.monitor is not None)

    # ----------------------------------------------------------- device seams
    def _device_state(self):
        """This rank's slab of the host window on its device."""
        return shard_state(self.local_map.state, self.mesh)

    def _publish(self, stamp: float, scan_ms: float) -> None:
        """Pose to this rank's monitor; the whole window to every rank's
        monitor when any rank's rate limit says a snapshot is due.  Every
        rank enters the same collectives at the same scans: the decision is
        one all-reduce, the snapshot one gather of value and weight."""
        if not self._monitored:
            return
        mon = self.monitor
        if mon is not None:
            mon.publish_pose(stamp, self.pose, timing_ms=scan_ms)
        if not any_rank(self.mesh, mon is not None and mon.map_due()):
            return
        window = gather_state(self.state, self.mesh)
        if mon is not None:
            m = self.params.map
            mon.publish_map(window, resolution=m.resolution, tau=m.tau,
                            force=True)

    def _register(self, pts, mask, pretransform, prof=None) -> np.ndarray:
        m = self.params.map
        reg = self.params.registration
        if self._fields is None:
            self.eval.count("fields_cache_miss")
            if prof:
                prof.start("fields")
            self._fields = precompute_fields_packed_sharded(
                self.state, mesh=self.mesh, tau=m.tau,
                exact=self.exact_fields)
            if prof:
                prof.stop("fields")
        else:
            self.eval.count("fields_cache_hit")
        transform, iters, err = register_cloud_packed_sharded(
            self._fields, self.state.pos, self.state.offset, pts, mask,
            torch.as_tensor(pretransform, device=self.device),
            mesh=self.mesh, size=self.local_map.size, resolution=m.resolution,
            tau=m.tau, max_iterations=reg.max_iterations,
            epsilon=reg.epsilon, gather_freeze=reg.gather_freeze)
        self.last_reg_iters = iters
        self.last_reg_err = err
        return transform.cpu().numpy()

    def _update_tsdf(self, pts, mask, pose: np.ndarray | None = None,
                     evaluator=None) -> None:
        """Sharded projective fusion on the level map-aligned beam grid
        inside the tilt envelope (K1's level sweep), with the sensor
        attitude beyond it (K1's general sweep).  It has no spans of its
        own parts: ``evaluator`` is ignored."""
        m = self.params.map
        if pose is None:
            pose = self.pose
        scanner_voxel = np.floor(
            np.asarray(pose)[:3, 3] / m.resolution).astype(np.int32)
        grid_rot, level = grid_rotation_for(pose, self.params.lidar.vfov)
        tsdf_update_projective_sharded(
            self.state, pts, mask, scanner_voxel, grid_rot, mesh=self.mesh,
            size=self.local_map.size, tau=m.tau,
            max_weight=m.max_weight_scaled, resolution=m.resolution,
            channels=self.params.lidar.channels,
            columns=self.params.lidar.hresolution,
            vfov_deg=self.params.lidar.vfov, level=level)
        self._fields = None      # map changed: registration fields stale

    def _maybe_shift(self, prof=None) -> None:
        """Shift the window once the pose wandered ``map.shift`` meters.
        A world of one without ``sync_shift`` stages it (device gathers
        here, global-map IO on a worker thread, device scatters in
        ``_finish_async_shift``); otherwise every rank shifts its own rows
        now."""
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
        if self.mesh.world == 1 and not self._sync_shift:
            self.local_map.attach_device(self.state)
            self._shift_plan = self.local_map.begin_shift(new_pos)
            scan = self._scans - 1

            def work():
                if prof:  # the worker's spans belong to the scan that began it
                    prof.set_scan(scan)
                try:
                    self.local_map.shift_io(self._shift_plan)
                except BaseException as e:   # surfaced in _collect_shift
                    self._shift_error = e
            self._shift_thread = threading.Thread(target=work, daemon=True)
            self._shift_thread.start()
            return
        if prof:
            prof.start("shift")
        self.local_map.attach_device(self.state, x_rows=self._slab_rows)
        self.local_map.shift(new_pos)
        self.state = self.local_map.detach_device()
        self.shifted = True
        self._fields = None      # window moved: registration fields stale
        if prof:
            prof.stop("shift")

    def _finish_async_shift(self):
        """Staged swap-in: scatter the loaded slabs on this thread."""
        plan, self._shift_plan = self._shift_plan, None
        return self.local_map.finish_shift(plan)

    def terminate(self, csv_path=None) -> None:
        """Persist this rank's rows of the map, and the poses."""
        self.imu_buffer.clear()
        if self._shift_thread is not None:
            self._shift_thread.join()
        self._collect_shift()
        self.local_map.attach_device(self.state, x_rows=self._slab_rows)
        self.local_map.write_back()
        self.local_map.detach_device()
        if csv_path is not None:
            self.eval.export_results(csv_path)
        self.global_map.close()
