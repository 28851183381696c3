"""The benchmark's car park: scene, sensor, trajectories and IMU stream.

The renderer, the trajectories and the IMU stream follow
``warpsense_tpu_torch/io/synthetic.py`` (``render_scan``,
``imu_stream_for``), copied here so that the yardstick does not move with
the program.  The ray cast is rewritten in plain torch so that a lap of a
thousand OS1-128 scans renders on the card in seconds: every ray against
every solid box (slab test), nearest entry wins, a miss or a return
beyond ``max_range`` is (0, 0, 0), the convention the program reads as
invalid.  ``render_scan_np`` is the numpy original, kept for the tests.

Meters throughout; poses are 4x4 sensor-to-world.
"""
from __future__ import annotations

import math

import numpy as np
import torch


# ------------------------------------------------------------------- scene

def car_park(spec: dict) -> np.ndarray:
    """(B, 6) float64 boxes [lo xyz, hi xyz] of the car park in ``spec``
    (a mix's ``scene``): a ground slab (unless ``ground`` is false), double
    rows of parked cars along x (``rows``: each row's centre line and x
    extent; each bay occupied with probability ``occupancy``, drawn from
    ``scene_seed``), rows of square pillars (``pillar_rows``), walls
    ``facade_gap_m`` outside the lot and an optional ceiling slab at
    ``ceiling_z_m``."""
    rng = np.random.default_rng(int(spec["scene_seed"]))
    x0, x1 = spec["lot_x_m"]
    y0, y1 = spec["lot_y_m"]
    boxes = ([[x0 - 20.0, y0 - 20.0, -1.0, x1 + 20.0, y1 + 20.0, 0.0]]
             if spec.get("ground", True) else [])
    length, width, height = spec["car_m"]
    pitch = spec["bay_pitch_m"]
    for row in spec["rows"]:
        # two rows nose to nose about the row's centre line
        yc = row["y_m"]
        rx0, rx1 = row["x_m"]
        for side in (-1.0, 1.0):
            ya = yc + side * (0.25 + length / 2.0)
            for k in range(int((rx1 - rx0) // pitch)):
                if rng.random() >= spec["occupancy"]:
                    continue
                xc = rx0 + (k + 0.5) * pitch + rng.uniform(-0.15, 0.15)
                yj = ya + rng.uniform(-0.2, 0.2)
                boxes.append([xc - width / 2, yj - length / 2, 0.0,
                              xc + width / 2, yj + length / 2,
                              height + rng.uniform(-0.2, 0.3)])
    for row in spec.get("pillar_rows", []):
        half = row["size_m"] / 2
        for xp in np.arange(row["x_m"][0], row["x_m"][1] + 1e-9,
                            row["pitch_m"]):
            boxes.append([xp - half, row["y_m"] - half, 0.0,
                          xp + half, row["y_m"] + half, row["h_m"]])
    t = spec["facade_m"]
    h = spec["facade_h_m"]
    gap = spec.get("facade_gap_m", 10.0)
    fx0, fx1 = x0 - gap, x1 + gap
    fy0, fy1 = y0 - gap, y1 + gap
    boxes += [[fx0, fy0 - t, 0.0, fx1, fy0, h],
              [fx0, fy1, 0.0, fx1, fy1 + t, h * 0.8],
              [fx0 - t, fy0, 0.0, fx0, fy1, h * 1.2],
              [fx1, fy0, 0.0, fx1 + t, fy1, h]]
    if spec.get("ceiling_z_m") is not None:
        c = spec["ceiling_z_m"]
        boxes.append([fx0, fy0, c, fx1, fy1, c + 0.4])
    return np.asarray(boxes, np.float64)


# ------------------------------------------------------------------ sensor

def ray_directions(channels: int = 128, columns: int = 1024,
                   vfov_deg: float = 45.0) -> np.ndarray:
    """(channels, columns, 3) unit rays in the sensor frame (OS1 layout:
    a vertical fan of ``channels`` beams swept over 360 deg of azimuth);
    ``io/synthetic.ray_directions``."""
    elev = np.deg2rad(np.linspace(vfov_deg / 2, -vfov_deg / 2, channels))
    azim = np.linspace(-np.pi, np.pi, columns, endpoint=False)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(azim)[None, :], np.sin(azim)[None, :]
    x = ce * ca
    y = ce * sa
    z = np.broadcast_to(se, x.shape)
    return np.stack([x, y, z], axis=-1).astype(np.float64)


def render_scans(boxes: torch.Tensor, poses: torch.Tensor, dirs: torch.Tensor,
                 *, max_range: float, noise_std: float,
                 generator: torch.Generator | None,
                 box_chunk: int = 64) -> torch.Tensor:
    """Organized float32 scans (S, channels, columns, 3) in the SENSOR frame
    for the float64 ``poses`` (S, 4, 4), on the device of ``boxes``.

    The world is the union of solid ``boxes`` (B, 6); a ray's range is the
    nearest entry ``t > 0`` into any of them (``io/synthetic.
    _ray_box_enter``), valid when ``0.1 < t < max_range``.  With
    ``noise_std`` each valid range gets Gaussian noise from ``generator``."""
    S = poses.shape[0]
    d_s = dirs.reshape(-1, 3)                                   # (R, 3)
    d_w = torch.einsum("sij,rj->sri", poses[:, :3, :3], d_s)    # (S, R, 3)
    o = poses[:, None, :3, 3].expand_as(d_w)
    inv = 1.0 / d_w
    t = torch.full(d_w.shape[:2], math.inf, dtype=torch.float64,
                   device=boxes.device)
    for b0 in range(0, boxes.shape[0], box_chunk):
        bx = boxes[b0:b0 + box_chunk]                           # (b, 6)
        lo = (bx[:, None, None, :3] - o[None]) * inv[None]      # (b, S, R, 3)
        hi = (bx[:, None, None, 3:] - o[None]) * inv[None]
        near = torch.minimum(lo, hi).amax(dim=-1)
        far = torch.maximum(lo, hi).amin(dim=-1)
        del lo, hi
        hit = (near <= far) & (far > 0) & (near > 0)
        t = torch.minimum(t, torch.where(hit, near, math.inf).amin(dim=0))
    valid = torch.isfinite(t) & (t > 0.1) & (t < max_range)
    if noise_std > 0.0:
        noise = torch.randn(t.shape, dtype=torch.float64,
                            device=boxes.device, generator=generator)
        t = torch.where(valid, t + noise_std * noise, t)
    t = torch.where(valid, t, torch.zeros_like(t))
    pts = d_s[None] * t[..., None]
    pts = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    return pts.to(torch.float32).reshape(S, *dirs.shape)


def render_scan_np(boxes: np.ndarray, pose: np.ndarray, *, channels: int,
                   columns: int, vfov_deg: float,
                   max_range: float = 50.0) -> np.ndarray:
    """numpy original of the ray cast (``io/synthetic.render_scan`` with
    every box solid and no room), for the tests."""
    dirs_s = ray_directions(channels, columns, vfov_deg)
    dirs_w = dirs_s @ pose[:3, :3].T
    o = np.broadcast_to(pose[:3, 3], dirs_w.shape)
    t = np.full(dirs_w.shape[:2], np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for b in boxes:
            t_lo = (b[:3] - o) / dirs_w
            t_hi = (b[3:] - o) / dirs_w
            t_near = np.max(np.minimum(t_lo, t_hi), axis=-1)
            t_far = np.min(np.maximum(t_lo, t_hi), axis=-1)
            hit = (t_near <= t_far) & (t_far > 0)
            t = np.minimum(t, np.where(hit & (t_near > 0), t_near, np.inf))
    valid = np.isfinite(t) & (t > 0.1) & (t < max_range)
    pts = dirs_s * np.where(valid, t, 0.0)[..., None]
    return np.where(valid[..., None], pts, 0.0).astype(np.float32)


# ------------------------------------------------------------ trajectories

def _yaw_pose(x: float, y: float, z: float, yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    p = np.eye(4)
    p[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    p[:3, 3] = [x, y, z]
    return p


def stadium_lap(start_xy, straight_m: float, radius_m: float,
                step_m: float, z: float) -> np.ndarray:
    """(N, 4, 4) poses of a closed aisle loop: east along y0 for
    ``straight_m``, a U-turn of ``radius_m`` to the parallel aisle, west
    back, a U-turn home; yaw is the path's tangent.  The step is the
    nearest to ``step_m`` that closes the loop in whole scans."""
    x0, y0 = start_xy
    length = 2 * straight_m + 2 * math.pi * radius_m
    n = int(round(length / step_m))
    out = []
    for k in range(n):
        s = k * length / n
        if s < straight_m:                                   # east
            out.append(_yaw_pose(x0 + s, y0, z, 0.0))
            continue
        s -= straight_m
        arc = math.pi * radius_m
        if s < arc:                                          # U-turn north
            a = s / radius_m
            out.append(_yaw_pose(x0 + straight_m + radius_m * math.sin(a),
                                 y0 + radius_m - radius_m * math.cos(a), z,
                                 a))
            continue
        s -= arc
        if s < straight_m:                                   # west
            out.append(_yaw_pose(x0 + straight_m - s, y0 + 2 * radius_m, z,
                                 math.pi))
            continue
        a = (s - straight_m) / radius_m                      # U-turn south
        out.append(_yaw_pose(x0 - radius_m * math.sin(a),
                             y0 + radius_m + radius_m * math.cos(a), z,
                             math.pi + a))
    return np.stack(out)


def circle_lap(center_xy, radius_m: float, step_m: float,
               z: float) -> np.ndarray:
    """(N, 4, 4) poses on a circle about ``center_xy``, counter-clockwise,
    yaw the tangent, the step nearest ``step_m`` that closes the circle."""
    n = int(round(2 * math.pi * radius_m / step_m))
    cx, cy = center_xy
    return np.stack([_yaw_pose(cx + radius_m * math.cos(a),
                               cy + radius_m * math.sin(a), z,
                               a + math.pi / 2)
                     for a in (2 * math.pi * k / n for k in range(n))])


LAPS = {"stadium": stadium_lap, "circle": circle_lap}


def lap_poses(spec: dict) -> np.ndarray:
    """The poses of a mix's ``lap``: its ``shape`` with that function's
    arguments."""
    args = {k: v for k, v in spec.items() if k != "shape"}
    return LAPS[spec["shape"]](**args)


# ------------------------------------------------------------------- IMU

def gyro_between(p0: np.ndarray, p1: np.ndarray, dt: float) -> np.ndarray:
    """Angular velocity (rad/s, sensor frame of ``io/synthetic.
    imu_stream_for``) that turns ``p0``'s attitude into ``p1``'s in
    ``dt``."""
    dR = p1[:3, :3] @ p0[:3, :3].T
    angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    if angle < 1e-12:
        return np.zeros(3)
    axis = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                     dR[1, 0] - dR[0, 1]]) / (2 * np.sin(angle))
    return axis * angle / dt
