"""pcd_registration: known-perturbation registration recovery.

Counterpart of ``warpsense_tpu/eval/pcd_registration.py`` (the reference's
pcd_registration node, test/pcd_registration.cpp:234-355): build a TSDF
volume from a static cloud with the ray march, perturb the cloud by known
translations/rotations (idle, +-T, +-RY and their combination, :300-322),
register it back with ``ops/registration.register_cloud`` on ``device``,
and report min/max/avg/median per-point re-projection error (:65-177) for
every case.

    python -m warpsense_tpu_torch.eval.pcd_registration [--pcd cloud.pcd] \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _perturbations(tx=200.0, ty=200.0, tz=50.0, ry=np.deg2rad(5.0)):
    """The reference's perturbation matrix set (pcd_registration.cpp:300-322)."""
    idle = np.eye(4, dtype=np.float32)
    trans = np.eye(4, dtype=np.float32)
    trans[:3, 3] = [tx, ty, tz]
    rot = np.eye(4, dtype=np.float32)
    c, s = np.cos(ry), np.sin(ry)
    rot[:2, :2] = [[c, -s], [s, c]]
    rot2 = np.eye(4, dtype=np.float32)
    rot2[:2, :2] = [[c, s], [-s, c]]
    return {
        "idle": idle,
        "translation": trans,
        "rotation": rot,
        "rotation_inv": rot2,
        "translation+rotation": (trans @ rot).astype(np.float32),
    }


def reprojection_errors(points_mm: np.ndarray, recovered: np.ndarray) -> dict:
    """Per-point |T p - p| stats; ground truth is identity
    (pcd_registration.cpp:65-177)."""
    p = points_mm.astype(np.float64)
    moved = p @ recovered[:3, :3].T.astype(np.float64) + recovered[:3, 3]
    err = np.linalg.norm(moved - p, axis=1)
    return {"min": float(err.min()), "max": float(err.max()),
            "avg": float(err.mean()), "median": float(np.median(err))}


def run(cloud_mm: np.ndarray, *, tau: int = 600, resolution: int = 64,
        size=(201, 201, 121), max_weight_scaled: int = 32 * 64,
        max_iterations: int = 200, it_weight_gradient: float = 0.1,
        epsilon: float = 0.03, mode: str = "fast", device="cuda") -> dict:
    from ..core.consts import MATRIX_RESOLUTION
    from ..map.local_map import create_state
    from ..ops.registration import register_cloud
    from ..ops.tsdf import plan_raymarch, tsdf_update
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    up = torch.tensor([0, 0, MATRIX_RESOLUTION], dtype=torch.int32,
                      device=dev)
    max_range = int(np.max(np.linalg.norm(cloud_mm, axis=1))) + tau
    ms, mi = plan_raymarch(tau, resolution, max_range)
    n = len(cloud_mm)
    pts = torch.as_tensor(cloud_mm, dtype=torch.int32, device=dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)

    state = create_state(size, tau, 0, device=dev)
    size = tuple(state.value.shape)
    tsdf_update(state, pts, mask, torch.zeros(3, dtype=torch.int32,
                                              device=dev),
                up, size=size, tau=tau, max_weight=max_weight_scaled,
                resolution=resolution, max_steps=ms, max_isteps=mi)

    results = {}
    for name, pert in _perturbations().items():
        t0 = time.perf_counter()
        pose = register_cloud(state, pts, mask,
                              torch.as_tensor(pert, device=dev), size=size,
                              resolution=resolution,
                              max_iterations=max_iterations,
                              it_weight_gradient=it_weight_gradient,
                              epsilon=epsilon, mode=mode)
        pose = pose.cpu().numpy().astype(np.float64)
        ms_taken = (time.perf_counter() - t0) * 1000
        stats = reprojection_errors(cloud_mm, pose)
        stats["ms"] = round(ms_taken, 2)
        results[name] = stats
    return results


def _load_cloud(args) -> np.ndarray:
    if args.pcd:
        from ..io.pcd import read_pcd
        cloud_m = read_pcd(args.pcd)[:, :3]
        cloud_m = cloud_m - cloud_m.mean(axis=0, keepdims=True)
    else:
        from ..io.synthetic import BoxWorld, render_scan
        scan = render_scan(BoxWorld.default(), np.eye(4), channels=32,
                           columns=512)
        cloud_m = scan.reshape(-1, 3)
        cloud_m = cloud_m[np.any(cloud_m != 0, axis=1)]
    mm = np.round(cloud_m * 1000).astype(np.int64)
    vox = mm // args.resolution
    _, keep = np.unique(vox, axis=0, return_index=True)
    return vox[np.sort(keep)] * args.resolution + args.resolution // 2


def main(argv=None) -> dict:
    """Parse ``argv``, run, print the results as one JSON line; returns
    them."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pcd", default=None)
    ap.add_argument("--tau", type=int, default=600)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--mode", choices=["parity", "fast"], default="fast")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    cloud = _load_cloud(args)
    results = run(cloud, tau=args.tau, resolution=args.resolution,
                  mode=args.mode, device=args.device)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
