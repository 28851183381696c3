"""pcd2tsdf: single cloud -> TSDF volume, device op vs host twin.

Counterpart of ``warpsense_tpu/eval/pcd2tsdf.py`` (the reference's
pcd2tsdf node, test/pcd2tsdf.cpp:30-130): loads a PCD (or synthesizes a
scan), voxel-subsamples and demeans it, builds the TSDF volume with BOTH
the ray march on ``device`` (``ops/tsdf.tsdf_update``) and the exact
integer host twin (``ops/tsdf_reference``), and reports their agreement
and optional colored-PLY exports instead of publishing RViz markers.

    python -m warpsense_tpu_torch.eval.pcd2tsdf [--pcd cloud.pcd] \
        [--out-dir DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..core.consts import MATRIX_RESOLUTION

UP = np.array([0, 0, MATRIX_RESOLUTION], np.int64)   # the z axis


def tsdf_volume(pts_mm: np.ndarray, *, tau: int, resolution: int, size,
                max_weight_scaled: int, max_steps: int, max_isteps: int,
                device: torch.device):
    """(state, ms): the ray march (``ops/tsdf.tsdf_update``) of ``pts_mm``
    from the origin into a fresh window on ``device``, and its host time
    to the end of the work."""
    from ..map.local_map import create_state
    from ..ops.tsdf import tsdf_update
    state = create_state(size, tau, 0, device=device)
    t0 = time.perf_counter()
    tsdf_update(state, torch.as_tensor(pts_mm, dtype=torch.int32,
                                       device=device),
                torch.ones((len(pts_mm),), dtype=torch.bool, device=device),
                torch.zeros(3, dtype=torch.int32, device=device),
                torch.as_tensor(UP, dtype=torch.int32, device=device),
                size=tuple(state.value.shape), tau=tau,
                max_weight=max_weight_scaled, resolution=resolution,
                max_steps=max_steps, max_isteps=max_isteps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return state, (time.perf_counter() - t0) * 1000


def run(cloud_mm: np.ndarray, *, tau: int = 600, resolution: int = 64,
        size=(201, 201, 121), max_weight_scaled: int = 32 * 64,
        host_compare_points: int = 256, out_dir: str | None = None,
        device="cuda") -> dict:
    from ..map.global_map import GlobalMap
    from ..map.local_map import LocalMap
    from ..ops.tsdf import plan_raymarch
    from ..ops.tsdf_reference import update_tsdf_reference
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    max_range = int(np.max(np.linalg.norm(cloud_mm, axis=1))) + tau
    ms, mi = plan_raymarch(tau, resolution, max_range)

    def device_volume(pts):
        return tsdf_volume(pts, tau=tau, resolution=resolution, size=size,
                           max_weight_scaled=max_weight_scaled, max_steps=ms,
                           max_isteps=mi, device=dev)

    n = len(cloud_mm)
    device_volume(cloud_mm)                       # warm-up
    state, device_ms = device_volume(cloud_mm)
    stats = {
        "points": int(n),
        "touched_voxels_device": int((state.weight != 0).sum()),
        "device_ms": round(device_ms, 2),
    }

    # exact integer host-twin comparison on a subsample (the twin is a
    # per-point Python ray march: faithful, not fast)
    if host_compare_points:
        stride = max(1, n // host_compare_points)
        sub = cloud_mm[::stride][:host_compare_points]
        sub_state, _ = device_volume(sub)
        gm = GlobalMap(None, tau, 0)             # the twin persists nothing
        lm = LocalMap(size, gm)
        t0 = time.perf_counter()
        update_tsdf_reference(sub.astype(np.int64), np.zeros(3, np.int64),
                              UP, lm, tau=tau, max_weight=max_weight_scaled,
                              resolution=resolution)
        host_ms = (time.perf_counter() - t0) * 1000
        gm.close()
        dv = sub_state.value.cpu().numpy().astype(np.int32)
        dw = sub_state.weight.cpu().numpy().astype(np.int32)
        hv = lm.state.value.astype(np.int32)
        hw = lm.state.weight.astype(np.int32)
        touched = (dw != 0) | (hw != 0)
        agree = (dv == hv) & (dw == hw)
        stats.update({
            "compare_points": int(len(sub)),
            "touched_voxels_host": int((hw != 0).sum()),
            "exact_agreement": (float(agree[touched].mean())
                                if touched.any() else 1.0),
            "value_mad_mm": (float(np.abs(dv - hv)[touched].mean())
                             if touched.any() else 0.0),
            "host_ms": round(host_ms, 2),
        })
    if out_dir is not None:
        from ..obs.viz import export_tsdf_ply
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        stats["device_ply"] = str(out / "tsdf_device.ply")
        export_tsdf_ply(out / "tsdf_device.ply", state,
                        resolution=resolution, tau=tau)
    return stats


def _load_cloud(args) -> np.ndarray:
    if args.pcd:
        from ..io.pcd import read_pcd
        cloud_m = read_pcd(args.pcd)[:, :3]
    else:
        from ..io.synthetic import BoxWorld, render_scan
        scan = render_scan(BoxWorld.default(), np.eye(4), channels=32,
                           columns=512)
        cloud_m = scan.reshape(-1, 3)
        cloud_m = cloud_m[np.any(cloud_m != 0, axis=1)]
    # demean + voxel-center subsample like the reference driver
    cloud_m = cloud_m - cloud_m.mean(axis=0, keepdims=True)
    mm = np.round(cloud_m * 1000).astype(np.int64)
    vox = mm // args.resolution
    _, keep = np.unique(vox, axis=0, return_index=True)
    centers = vox[np.sort(keep)] * args.resolution + args.resolution // 2
    return centers


def main(argv=None) -> dict:
    """Parse ``argv``, run, print the stats as one JSON line; returns them."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pcd", default=None,
                    help="input cloud (synthetic if unset)")
    ap.add_argument("--tau", type=int, default=600)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    cloud = _load_cloud(args)
    stats = run(cloud, tau=args.tau, resolution=args.resolution,
                out_dir=args.out_dir, device=args.device)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
