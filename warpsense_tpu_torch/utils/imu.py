"""IMU angular-velocity accumulator -> rotation pretransform.

Behavioral parity: src/util/imu_accumulator.cpp:20-55 —
drains buffered IMU samples with stamp <= cloud stamp, integrates
``ang_vel * dt`` as sequential X/Y/Z axis rotations, and left-multiplies
into an accumulated rotation.  The first sample only seeds the clock.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ring_buffer import ConcurrentRingBuffer


@dataclass
class ImuSample:
    stamp: float                 # seconds
    angular_velocity: np.ndarray  # (3,) rad/s
    orientation: np.ndarray | None = None  # (4,) unit quaternion (x,y,z,w)


def _axis_rotations(orientation: np.ndarray) -> np.ndarray:
    """AngleAxis(x, Ux) * AngleAxis(y, Uy) * AngleAxis(z, Uz)."""
    rx, ry, rz = orientation
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


class ImuAccumulator:
    def __init__(self, buffer: ConcurrentRingBuffer):
        self.buffer = buffer
        self.first = True
        self.last_stamp = 0.0

    def acc_transform(self, cloud_stamp: float) -> np.ndarray:
        """4x4 rotation pretransform from all IMU samples up to the stamp."""
        acc = np.eye(4, dtype=np.float64)
        while True:
            msg = self.buffer.pop_nb_if(lambda m: cloud_stamp - m.stamp >= 0)
            if msg is None:
                break
            if self.first:
                self.last_stamp = msg.stamp
                self.first = False
                continue
            dt = abs(msg.stamp - self.last_stamp)
            R = _axis_rotations(np.asarray(msg.angular_velocity) * dt)
            acc[:3, :3] = R @ acc[:3, :3]
            self.last_stamp = msg.stamp
        return acc


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (x,y,z,w) -> 3x3 rotation, numpy twin of
    core.geometry.quat_to_mat."""
    x, y, z, w = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class MadgwickFilter:
    """Madgwick AHRS orientation filter (gyro + accelerometer, IMU variant).

    The reference wires ROS's ``imu_filter_madgwick`` node in front of the
    fastsense pipeline (launch/imu_filter.launch) so raw
    gyro+accel streams arrive as absolute orientations; this is that
    node's role, so ``FastsenseApp`` (which consumes orientation
    quaternions via ``ImuOrientationDiff``) can ingest raw IMU data.

    Standard gradient-descent formulation: q_dot = 0.5 q (x) [0, w]
    - beta * grad(f)/|grad(f)|, with f the accelerometer-gravity
    alignment objective.  ``beta`` defaults to the ROS node's 0.1.
    Quaternions are (x, y, z, w) like the rest of this repo.
    """

    def __init__(self, beta: float = 0.1):
        self.beta = float(beta)
        self.q = np.array([0.0, 0.0, 0.0, 1.0])    # xyzw
        self.last_stamp: float | None = None

    def update(self, stamp: float, gyro, accel) -> np.ndarray:
        """Advance to ``stamp`` with one (gyro rad/s, accel m/s^2) sample;
        returns the current orientation quaternion (x, y, z, w)."""
        gyro = np.asarray(gyro, np.float64)
        accel = np.asarray(accel, np.float64)
        if self.last_stamp is None:
            self.last_stamp = float(stamp)
            # seed roll/pitch from gravity when the accel is sane
            n = np.linalg.norm(accel)
            if 0.5 * 9.81 < n < 1.5 * 9.81:
                ax, ay, az = accel / n
                roll = np.arctan2(ay, az)
                pitch = np.arctan2(-ax, np.hypot(ay, az))
                cr, sr = np.cos(roll / 2), np.sin(roll / 2)
                cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
                self.q = np.array([sr * cp, cr * sp, -sr * sp, cr * cp])
                self.q /= np.linalg.norm(self.q)
            return self.q.copy()
        dt = float(stamp) - self.last_stamp
        self.last_stamp = float(stamp)
        if dt <= 0.0:
            return self.q.copy()

        x, y, z, w = self.q
        gx, gy, gz = gyro
        # rate of change from gyro: 0.5 * q (x) (0, w_gyro)
        qdot = 0.5 * np.array([
            w * gx + y * gz - z * gy,
            w * gy - x * gz + z * gx,
            w * gz + x * gy - y * gx,
            -x * gx - y * gy - z * gz,
        ])

        n = np.linalg.norm(accel)
        if n > 1e-9:
            ax, ay, az = accel / n
            # objective f = R(q)^T g_world - a  (g_world = +z), Jacobian^T f
            f1 = 2.0 * (x * z - w * y) - ax
            f2 = 2.0 * (w * x + y * z) - ay
            f3 = 2.0 * (0.5 - x * x - y * y) - az
            gx_ = 2.0 * z * f1 + 2.0 * w * f2 - 4.0 * x * f3
            gy_ = -2.0 * w * f1 + 2.0 * z * f2 - 4.0 * y * f3
            gz_ = 2.0 * x * f1 + 2.0 * y * f2
            gw_ = -2.0 * y * f1 + 2.0 * x * f2
            grad = np.array([gx_, gy_, gz_, gw_])
            gn = np.linalg.norm(grad)
            if gn > 1e-12:
                qdot -= self.beta * grad / gn

        self.q = self.q + qdot * dt
        self.q /= np.linalg.norm(self.q)
        return self.q.copy()

    def filter_sample(self, sample: "ImuSample",
                      linear_acceleration) -> "ImuSample":
        """Raw sample -> sample carrying the filtered orientation (the
        shape ``FastsenseApp.imu_callback`` expects)."""
        q = self.update(sample.stamp, sample.angular_velocity,
                        linear_acceleration)
        return ImuSample(sample.stamp, np.asarray(sample.angular_velocity),
                         orientation=q)


class ImuOrientationDiff:
    """Absolute-orientation-difference pretransform (the fastsense variant).

    Behavioral parity: src/cpu/fastsense.cpp:181-212 — the
    node consumes (Madgwick-)filtered IMU messages carrying absolute
    orientation quaternions; per scan it drains all samples with
    stamp <= cloud stamp, keeps the LAST one, and the rotation pretransform
    is R(q_now) @ R(q_prev)^T (the orientation delta since the previous
    scan).  The first orientation only seeds the anchor.
    """

    def __init__(self, buffer: ConcurrentRingBuffer):
        self.buffer = buffer
        self.last_orientation: np.ndarray | None = None

    def pretransform(self, cloud_stamp: float) -> np.ndarray:
        """4x4 rotation pretransform from the orientation delta."""
        latest = None
        while True:
            msg = self.buffer.pop_nb_if(lambda m: cloud_stamp - m.stamp >= 0)
            if msg is None:
                break
            if msg.orientation is not None:
                latest = np.asarray(msg.orientation, np.float64)
        acc = np.eye(4, dtype=np.float64)
        if latest is None:
            return acc
        if self.last_orientation is not None:
            acc[:3, :3] = (_quat_to_mat_np(latest)
                           @ _quat_to_mat_np(self.last_orientation).T)
        self.last_orientation = latest
        return acc
