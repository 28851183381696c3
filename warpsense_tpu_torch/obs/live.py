"""Live observability: watch a run while it is in flight.

Counterpart of ``warpsense_tpu/obs/live.py``.  The reference streams TF
transforms, paths-as-pointclouds, and TSDF marker clouds to RViz every
scan (include/util/publish.h:11-93,
include/warpsense/visualization/map.h:14-246, published from App::
publish_pose_estimate app.cpp:150-170 and the shift thread
tsdf_mapping.cpp:134).  This module is that role without ROS:

* ``LiveMonitor`` — an in-process pub/sub hub the pipelines push into
  every scan (pose, path, timing, map stats) and on every shift (window
  skeleton).  Consumers subscribe callbacks per topic.
* ``FileStreamer`` — a subscriber that keeps ``latest_path.tum``,
  ``latest_map.ply`` and ``status.json`` fresh on disk (atomic renames,
  rate-limited) so any viewer/`watch` can follow the run.
* ``HttpMonitor`` — a stdlib HTTP endpoint serving the current status
  JSON, the TUM path, and the current map window as PLY; ``curl
  localhost:PORT/status`` is the new ``rostopic echo``.

``WarpsenseApp`` and ``ShardedWarpsenseApp`` accept ``monitor=``
(pipeline/warpsense.py, pipeline/warpsense_sharded.py) and call
``publish_*``; the sharded app publishes the whole window, gathered from
its ranks' slabs as host arrays.  Everything here is rate-limited and runs
on the caller's thread except the HTTP server (daemon thread).
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch


def _owned_copy(x):
    """A copy the caller cannot change: a tensor is cloned on its own
    device (the apps fuse their map IN PLACE), anything else becomes a
    numpy copy."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    return np.array(x)


class LiveMonitor:
    """Pub/sub hub + rolling run state (thread-safe)."""

    def __init__(self, map_snapshot_period_s: float = 1.0):
        self._subs: dict[str, list[Callable]] = {}
        self._lock = threading.Lock()
        self.path: list[tuple[float, np.ndarray]] = []    # (stamp, 4x4 mm)
        self.status: dict = {"scans": 0, "started": time.time()}
        self._map_state = None
        self._map_meta: dict = {}
        self._map_snapshot_period_s = float(map_snapshot_period_s)
        self._last_map_snapshot = 0.0

    def subscribe(self, topic: str, fn: Callable) -> None:
        with self._lock:
            self._subs.setdefault(topic, []).append(fn)

    def _emit(self, topic: str, *args) -> None:
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for fn in subs:
            fn(*args)

    # ---- called by the pipelines -----------------------------------------
    def publish_pose(self, stamp: float, pose_mm: np.ndarray,
                     timing_ms: float | None = None) -> None:
        """Per-scan pose (the reference's TF broadcast + path append,
        publish.h:28-43)."""
        pose = np.asarray(pose_mm, np.float64)
        with self._lock:
            self.path.append((float(stamp), pose.copy()))
            self.status["scans"] = len(self.path)
            self.status["stamp"] = float(stamp)
            self.status["position_m"] = (pose[:3, 3] / 1000.0).round(4).tolist()
            if timing_ms is not None:
                self.status["scan_ms"] = round(float(timing_ms), 2)
        self._emit("pose", stamp, pose)

    def map_due(self) -> bool:
        """Whether ``publish_map`` would take a snapshot now: the first one,
        then one each ``map_snapshot_period_s``."""
        with self._lock:
            return self._due(time.time())

    def _due(self, now: float) -> bool:          # under self._lock
        return (self._map_state is None or now - self._last_map_snapshot
                >= self._map_snapshot_period_s)

    def publish_map(self, state, *, resolution: int, tau: int,
                    force: bool = False) -> None:
        """Map-window snapshot (the reference's marker cloud,
        visualization/map.h:14-121); stored by reference, rendered lazily
        by consumers.

        Rate-limited (``map_due``) unless ``force`` (the sharded app takes
        that decision for all its ranks at once), and the stored snapshot
        is a COPY of the state's planes (tensors or host arrays): the
        pipelines fuse and shift their map in place, so holding the
        caller's planes would show consumers a map that changes under
        them."""
        now = time.time()
        with self._lock:
            if not (force or self._due(now)):
                return
            self._last_map_snapshot = now
        snap = type(state)(
            value=_owned_copy(state.value), weight=_owned_copy(state.weight),
            pos=_owned_copy(state.pos), offset=_owned_copy(state.offset))
        with self._lock:
            self._map_state = snap
            self._map_meta = {"resolution": resolution, "tau": tau}
            self.status["map_epoch"] = self.status.get("map_epoch", 0) + 1
        self._emit("map", snap)

    def publish_shift(self, pos_voxels) -> None:
        """Window re-center event (the shift thread's skeleton publish,
        tsdf_mapping.cpp:134)."""
        with self._lock:
            self.status["last_shift_pos"] = np.asarray(pos_voxels).tolist()
            self.status["shifts"] = self.status.get("shifts", 0) + 1
        self._emit("shift", pos_voxels)

    # ---- snapshots for consumers -----------------------------------------
    def tum_path(self) -> str:
        from ..io.trajectory import _quat_from_mat
        with self._lock:
            rows = list(self.path)
        lines = []
        for stamp, pose in rows:
            t = pose[:3, 3] / 1000.0
            q = _quat_from_mat(pose[:3, :3])
            lines.append("%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f"
                         % (stamp, t[0], t[1], t[2], q[0], q[1], q[2], q[3]))
        return "\n".join(lines) + ("\n" if lines else "")

    def map_ply_bytes(self) -> bytes:
        from ..io.pcd import write_ply
        import tempfile
        with self._lock:
            state, meta = self._map_state, dict(self._map_meta)
        if state is None:
            return b""
        from .viz import tsdf_cloud
        pts, colors = tsdf_cloud(state, resolution=meta["resolution"],
                                 tau=meta["tau"])
        with tempfile.TemporaryDirectory() as d:
            p = Path(d) / "m.ply"
            write_ply(p, pts, colors)
            return p.read_bytes()

    def status_json(self) -> str:
        with self._lock:
            return json.dumps(dict(self.status))


class FileStreamer:
    """Keeps latest_path.tum / status.json / latest_map.ply fresh on disk
    while the run is in flight (atomic renames; map export rate-limited)."""

    def __init__(self, monitor: LiveMonitor, directory: str | Path, *,
                 map_period_s: float = 5.0, path_period_s: float = 0.5):
        self.mon = monitor
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.map_period_s = map_period_s
        self.path_period_s = path_period_s
        self._last_map = 0.0
        self._last_path = 0.0
        monitor.subscribe("pose", self._on_pose)
        monitor.subscribe("map", self._on_map)

    def _atomic_write(self, name: str, data: bytes) -> None:
        tmp = self.dir / (name + ".tmp")
        tmp.write_bytes(data)
        os.replace(tmp, self.dir / name)

    def _on_pose(self, stamp, pose) -> None:
        now = time.time()
        if now - self._last_path < self.path_period_s:
            return
        self._last_path = now
        self._atomic_write("latest_path.tum", self.mon.tum_path().encode())
        self._atomic_write("status.json", self.mon.status_json().encode())

    def _on_map(self, state) -> None:
        now = time.time()
        if now - self._last_map < self.map_period_s:
            return
        self._last_map = now
        ply = self.mon.map_ply_bytes()
        if ply:
            self._atomic_write("latest_map.ply", ply)

    def flush(self) -> None:
        """Force-write everything (shutdown hook)."""
        self._atomic_write("latest_path.tum", self.mon.tum_path().encode())
        self._atomic_write("status.json", self.mon.status_json().encode())
        ply = self.mon.map_ply_bytes()
        if ply:
            self._atomic_write("latest_map.ply", ply)


class HttpMonitor:
    """Tiny stdlib HTTP endpoint over a LiveMonitor.

    GET /status       -> run status JSON
    GET /path.tum     -> full trajectory (TUM format)
    GET /map.ply      -> current window as colored PLY
    """

    def __init__(self, monitor: LiveMonitor, port: int = 0,
                 host: str = "127.0.0.1"):
        import http.server

        mon = monitor

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):        # silent
                pass

            def do_GET(self):
                if self.path.startswith("/status"):
                    body = mon.status_json().encode()
                    ctype = "application/json"
                elif self.path.startswith("/path.tum"):
                    body = mon.tum_path().encode()
                    ctype = "text/plain"
                elif self.path.startswith("/map.ply"):
                    body = mon.map_ply_bytes()
                    ctype = "application/octet-stream"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
