"""Synthetic OS1-128 scan generator — analytic ray-cast of a box world.

The reference is driven by rosbags of an Ouster OS1-128 (128 channels x
1024 columns, params/params.yaml:2-5).  This module synthesizes the same
organized scans from an analytic scene (room walls + box pillars) so the
whole pipeline (preprocessing, featsense feature extraction on the
organized grid, registration, fusion) can be exercised and benchmarked
without sensor data.  Scans are generated in the sensor frame; ground
truth poses come from the trajectory, enabling ATE-style evaluation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Box:
    lo: np.ndarray  # (3,) meters
    hi: np.ndarray  # (3,) meters


@dataclass
class BoxWorld:
    """A room (sensor inside `room`) containing solid `pillars`."""
    room: Box
    pillars: list[Box] = field(default_factory=list)

    @staticmethod
    def default() -> "BoxWorld":
        room = Box(np.array([-8.0, -6.0, -2.0]), np.array([8.0, 6.0, 3.0]))
        pillars = [
            Box(np.array([2.0, 1.0, -2.0]), np.array([2.6, 1.6, 3.0])),
            Box(np.array([-3.0, -2.5, -2.0]), np.array([-2.2, -1.9, 3.0])),
            Box(np.array([4.0, -3.5, -2.0]), np.array([4.8, -2.9, 0.5])),
            Box(np.array([-5.5, 2.0, -2.0]), np.array([-4.9, 3.2, 1.2])),
        ]
        return BoxWorld(room, pillars)


def _ray_box_exit(origins, dirs, box: Box):
    """t of exit through the box walls (rays starting inside)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t_lo = (box.lo - origins) / dirs
        t_hi = (box.hi - origins) / dirs
    t_far = np.maximum(t_lo, t_hi)
    return np.min(t_far, axis=-1)


def _ray_box_enter(origins, dirs, box: Box):
    """t of entry into a solid box; +inf when missed or behind."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t_lo = (box.lo - origins) / dirs
        t_hi = (box.hi - origins) / dirs
    t_near = np.max(np.minimum(t_lo, t_hi), axis=-1)
    t_far = np.min(np.maximum(t_lo, t_hi), axis=-1)
    hit = (t_near <= t_far) & (t_far > 0)
    t = np.where(t_near > 0, t_near, np.inf)
    return np.where(hit, t, np.inf)


def box_room_cloud(n: int, half: float, zhalf: float,
                   seed: int = 0) -> np.ndarray:
    """(~n, 3) int32 mm points uniformly sampled on the 6 walls of an
    axis-aligned box room — the shared synthetic fixture for benches,
    driver dry-runs, and distributed cross-process checks (ONE copy so
    "identical in every process" comparisons stay identical)."""
    rng = np.random.default_rng(seed)
    pts = []
    for ax in range(3):
        for s in (-1, 1):
            p = np.stack([rng.uniform(-half, half, n // 6),
                          rng.uniform(-half, half, n // 6),
                          rng.uniform(-zhalf, zhalf, n // 6)], axis=1)
            p[:, ax] = s * (zhalf if ax == 2 else half)
            pts.append(p)
    return np.round(np.concatenate(pts)).astype(np.int32)


def ray_directions(channels: int = 128, columns: int = 1024,
                   vfov_deg: float = 45.0) -> np.ndarray:
    """(channels, columns, 3) unit rays in the sensor frame (OS1 layout:
    vertical fan of `channels` beams swept over 360 deg azimuth)."""
    elev = np.deg2rad(np.linspace(vfov_deg / 2, -vfov_deg / 2, channels))
    azim = np.linspace(-np.pi, np.pi, columns, endpoint=False)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(azim)[None, :], np.sin(azim)[None, :]
    x = ce * ca
    y = ce * sa
    z = np.broadcast_to(se, x.shape)
    return np.stack([x, y, z], axis=-1).astype(np.float64)


def render_scan(world: BoxWorld, pose: np.ndarray, *, channels: int = 128,
                columns: int = 1024, vfov_deg: float = 45.0,
                max_range: float = 50.0, noise_std: float = 0.0,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """Organized (channels, columns, 3) float32 cloud in the SENSOR frame.

    ``pose``: 4x4 sensor-to-world, meters.  Misses / out-of-range rays are
    (0, 0, 0) — the convention the reference treats as invalid
    (mypcl/fromROSMsg zeros, featsense skips them).
    """
    dirs_s = ray_directions(channels, columns, vfov_deg)
    R = pose[:3, :3].astype(np.float64)
    origin = pose[:3, 3].astype(np.float64)
    dirs_w = dirs_s @ R.T
    o = np.broadcast_to(origin, dirs_w.shape)

    t = _ray_box_exit(o, dirs_w, world.room)
    for p in world.pillars:
        t = np.minimum(t, _ray_box_enter(o, dirs_w, p))
    valid = np.isfinite(t) & (t > 0.1) & (t < max_range)
    t = np.where(valid, t, 0.0)
    if noise_std > 0.0 and rng is not None:
        t = np.where(valid, t + rng.normal(0.0, noise_std, t.shape), t)
    pts_sensor = dirs_s * t[..., None]
    return np.where(valid[..., None], pts_sensor, 0.0).astype(np.float32)


def two_room_world() -> BoxWorld:
    """Adversarial multi-room world (round-5): two 10 x 10 m rooms joined
    by a 2 m-wide, ~14 m feature-poor corridor through 1.6 m doorways,
    fully closed by solid wall slabs + floor/ceiling.  Everything is
    "pillars" (solid boxes) inside a huge bounding room the rays never
    reach — so the existing analytic renderer works unchanged.

    Stresses exactly what the single convex box room cannot: occlusion
    (walls hide most of the map at any pose), doorway transitions (the
    visible set changes discontinuously), a feature-poor straight (the
    corridor's parallel walls leave the along-axis translation weakly
    observable — the far end wall is the only x constraint), and a loop
    return (the trajectory re-enters room A through the same corridor).
    The reference's accuracy story is rosbag trajectories of comparable
    buildings (README.md:262-279)."""
    zf, zc, th = -1.5, 2.5, 0.4
    door = 0.8                      # doorway half-width

    def box(x0, x1, y0, y1, z0=zf, z1=zc):
        return Box(np.array([x0, y0, z0]), np.array([x1, y1, z1]))

    walls = [
        # floor + ceiling over the whole building footprint
        box(-6.0, 30.0, -6.0, 6.0, zf - th, zf),
        box(-6.0, 30.0, -6.0, 6.0, zc, zc + th),
        # room A shell (interior x in [-5, 5], y in [-5, 5])
        box(-5.4, -5.0, -5.4, 5.4),                  # west
        box(-5.4, 5.4, 5.0, 5.4),                    # north
        box(-5.4, 5.4, -5.4, -5.0),                  # south
        box(5.0, 5.4, -5.4, -door),                  # east, south of door
        box(5.0, 5.4, door, 5.4),                    # east, north of door
        # corridor walls (interior y in [-door, door], x in [5.4, 18.6])
        box(5.4, 18.6, door, door + th),
        box(5.4, 18.6, -door - th, -door),
        # room B shell (interior x in [19, 29], y in [-5, 5])
        box(18.6, 19.0, -5.4, -door),                # west, south of door
        box(18.6, 19.0, door, 5.4),                  # west, north of door
        box(29.0, 29.4, -5.4, 5.4),                  # east
        box(18.6, 29.4, 5.0, 5.4),                   # north
        box(18.6, 29.4, -5.4, -5.0),                 # south
        # furniture: feature anchors inside the rooms (occluders)
        box(2.0, 2.6, 2.0, 2.6, zf, 1.2),
        box(-3.4, -2.8, -3.2, -2.4, zf, 2.0),
        box(-2.0, -1.4, 3.0, 3.8, zf, 0.8),
        box(21.5, 22.3, 2.2, 2.8, zf, 1.6),
        box(26.0, 26.8, -3.0, -2.2, zf, 1.0),
        box(23.0, 23.6, -1.0, -0.4, zf, 2.0),
    ]
    bound = Box(np.array([-60.0, -60.0, -60.0]), np.array([60.0, 60.0, 60.0]))
    return BoxWorld(room=bound, pillars=walls)


# waypoints of the two-room loop: lap around room A, out through the
# corridor, lap around room B, back through the corridor (loop return)
TWO_ROOM_WAYPOINTS = [
    (0.0, 0.0), (0.0, 2.8), (-2.8, 0.0), (0.0, -2.8), (2.8, 0.0),
    (3.5, 0.0), (12.0, 0.0), (22.0, 0.0), (24.0, 2.6), (26.5, 0.0),
    (24.0, -2.6), (21.5, 0.0), (12.0, 0.0), (3.5, 0.0), (0.0, 0.0),
]


def waypoint_trajectory(waypoints, *, step_m: float = 0.12, z: float = 0.3,
                        yaw_smooth: float = 0.25):
    """Piecewise-linear walk through 2-D ``waypoints`` at ``step_m`` per
    frame, yaw low-pass-tracking the direction of motion (a robot turning
    through corners, not teleporting its heading).

    Returns (poses (N, 4, 4) float64 meters, segment_id (N,) int32 — the
    waypoint segment each frame lies on, for per-segment drift metrics).
    """
    wps = np.asarray(waypoints, float)
    pts, seg = [], []
    for i in range(len(wps) - 1):
        a, b = wps[i], wps[i + 1]
        d = np.linalg.norm(b - a)
        n = max(1, int(np.ceil(d / step_m)))
        for k in range(n):
            pts.append(a + (b - a) * (k / n))
            seg.append(i)
    pts.append(wps[-1])
    seg.append(len(wps) - 2)
    pts = np.asarray(pts)
    poses = np.zeros((len(pts), 4, 4))
    yaw = None
    for i, p in enumerate(pts):
        d = (pts[min(i + 1, len(pts) - 1)] - pts[max(i - 1, 0)])
        target = np.arctan2(d[1], d[0]) if np.linalg.norm(d) > 1e-9 else 0.0
        if yaw is None:
            yaw = target
        else:
            # shortest-arc low-pass toward the travel direction
            dy = (target - yaw + np.pi) % (2 * np.pi) - np.pi
            yaw += yaw_smooth * dy
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i] = np.eye(4)
        poses[i][:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        poses[i][:3, 3] = [p[0], p[1], z]
    return poses, np.asarray(seg, np.int32)


def circular_trajectory(n_poses: int, radius: float = 2.0,
                        z: float = 0.3, yaw_rate: float | None = None
                        ) -> np.ndarray:
    """(n, 4, 4) poses walking a circle while yawing (meters)."""
    ts = np.linspace(0.0, 2 * np.pi, n_poses, endpoint=False)
    poses = np.zeros((n_poses, 4, 4), dtype=np.float64)
    for i, a in enumerate(ts):
        yaw = a + np.pi / 2 if yaw_rate is None else a * yaw_rate
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i] = np.eye(4)
        poses[i][:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        poses[i][:3, 3] = [radius * np.cos(a), radius * np.sin(a), z]
    return poses


def imu_stream_for(poses_mm: np.ndarray, scan_dt: float, imu_rate: int = 100):
    """Synthesize gyro samples consistent with consecutive poses.

    Returns a list of (stamp_s, angular_velocity[3]) covering each
    inter-scan interval, suitable for ImuAccumulator.
    """
    from ..utils.imu import ImuSample

    samples = []
    n = len(poses_mm)
    steps = max(1, int(round(imu_rate * scan_dt)))
    for i in range(1, n):
        dR = poses_mm[i][:3, :3] @ poses_mm[i - 1][:3, :3].T
        # rotation vector of dR
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        if angle < 1e-12:
            w = np.zeros(3)
        else:
            axis = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                             dR[1, 0] - dR[0, 1]]) / (2 * np.sin(angle))
            w = axis * angle / scan_dt
        t0 = (i - 1) * scan_dt
        for k in range(steps):
            samples.append(ImuSample(stamp=t0 + (k + 1) * scan_dt / steps,
                                     angular_velocity=w.copy()))
    return samples


def rich_trajectory(n_poses: int, *, step_m: float = 0.08,
                    yaw_rate: float = 0.05, pitch_deg: float = 8.0,
                    roll_deg: float = 5.0, z: float = 0.3) -> np.ndarray:
    """(n, 4, 4) rotation-RICH poses: a turning walk with a continuous yaw
    plus pitch- and roll-oscillation segments — the trajectory class where
    SE(3)-composition and fuse-ordering bugs manifest as measurable ATE
    (the reference's own composition drops the (dR - I) t coupling,
    app.cpp:172-176, which cancels only without rotation).  Thirds:
    yaw-only walk, then +pitch oscillation, then +roll oscillation."""
    poses = np.zeros((n_poses, 4, 4), dtype=np.float64)
    pos = np.array([0.0, 0.0, z])
    yaw = 0.0
    for i in range(n_poses):
        pitch = (np.deg2rad(pitch_deg) * np.sin(2 * np.pi * i / 25)
                 if i >= n_poses // 3 else 0.0)
        roll = (np.deg2rad(roll_deg) * np.sin(2 * np.pi * i / 18)
                if i >= 2 * n_poses // 3 else 0.0)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cr, sr = np.cos(roll), np.sin(roll)
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        poses[i] = np.eye(4)
        poses[i][:3, :3] = Rz @ Ry @ Rx
        poses[i][:3, 3] = pos
        pos = pos + np.array([cy, sy, 0.0]) * step_m
        yaw += yaw_rate
    return poses


def walk_trajectory(n_poses: int, *, step_m: float = 0.12,
                    yaw_rate: float = 0.03, z: float = 0.3) -> np.ndarray:
    """(n, 4, 4) poses walking forward with a slow turn — per-frame motion
    consistent with a 10-20 Hz sensor (the circular trajectory distributes
    a FULL circle over n poses, which at small n means unregistrable
    inter-frame jumps; this one keeps the step fixed)."""
    poses = np.zeros((n_poses, 4, 4), dtype=np.float64)
    pos = np.zeros(3)
    pos[2] = z
    yaw = 0.0
    for i in range(n_poses):
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i] = np.eye(4)
        poses[i][:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        poses[i][:3, 3] = pos
        pos = pos + np.array([c, s, 0.0]) * step_m
        yaw += yaw_rate
    return poses
