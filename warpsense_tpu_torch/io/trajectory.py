"""Trajectory export and ATE evaluation.

Counterpart of ``warpsense_tpu/io/trajectory.py``: TUM read/write plus the
standard ATE RMSE with optional Umeyama SE(3) alignment (what ``evo_ape
-a`` computes).  Everything is numpy in double precision except the
rotation -> quaternion step, which goes through the float32
``core.geometry.mat_to_quat`` like the JAX function, so a TUM file written
here is byte-equal to the JAX package's for the same poses.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..core.geometry import mat_to_quat


def _quat_from_mat(R: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion as float64, computed in float32."""
    q = mat_to_quat(torch.as_tensor(np.asarray(R), dtype=torch.float32))
    return q.numpy().astype(np.float64)


def _mat_from_quat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def write_tum(path: str | Path, poses: np.ndarray,
              stamps: np.ndarray | None = None, *, scale: float = 1.0
              ) -> None:
    """poses: (N, 4, 4); translations multiplied by ``scale`` (1e-3 turns
    the pipelines' mm poses into meters)."""
    poses = np.asarray(poses, np.float64)
    if stamps is None:
        stamps = np.arange(len(poses), dtype=np.float64)
    with open(path, "w") as f:
        for s, p in zip(stamps, poses):
            t = p[:3, 3] * scale
            q = _quat_from_mat(p[:3, :3])
            f.write(f"{s:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def read_tum(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """-> (stamps (N,), poses (N, 4, 4))."""
    rows = np.loadtxt(path).reshape(-1, 8)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, 3] = rows[:, 1:4]
    for i, q in enumerate(rows[:, 4:8]):
        poses[i, :3, :3] = _mat_from_quat(q)
    return rows[:, 0], poses


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """SE(3) (optionally Sim(3)) alignment src -> dst of (N, 3) point sets.
    Returns (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float((D * S.diagonal()).sum() / (xs ** 2).sum() * len(src)) \
        if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_errors(estimate: np.ndarray, reference: np.ndarray, *,
               align: bool = True) -> np.ndarray:
    """Per-frame absolute translation errors (N,) in meters over (N, 4, 4)
    pose arrays; with ``align`` the estimate is Umeyama-SE(3)-aligned
    first (evo -a)."""
    est = np.asarray(estimate, np.float64)[:, :3, 3]
    ref = np.asarray(reference, np.float64)[:, :3, 3]
    if len(est) != len(ref):
        raise ValueError("trajectory length mismatch")
    if align and len(est) >= 3:
        R, t, s = umeyama_alignment(est, ref)
        est = est @ (s * R).T + t
    return np.sqrt(np.sum((est - ref) ** 2, axis=1))


def ate_rmse(estimate: np.ndarray, reference: np.ndarray, *,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE over (N, 4, 4) pose arrays (meters)."""
    return float(np.sqrt(np.mean(
        ate_errors(estimate, reference, align=align) ** 2)))
