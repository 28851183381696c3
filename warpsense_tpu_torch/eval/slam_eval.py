"""End-to-end SLAM evaluation: ATE + throughput for both pipelines.

Counterpart of ``warpsense_tpu/eval/slam_eval.py``: run warpsense (HATSDF
point-to-TSDF) or featsense (F-LOAM + VGICP) over a dataset with ground
truth and report ATE RMSE, per-scan time and scans/s as one JSON line.

    python -m warpsense_tpu_torch.eval.slam_eval --pipeline warpsense \
        --frames 20
    python -m warpsense_tpu_torch.eval.slam_eval --pipeline featsense \
        --frames 20

The apps run on ``--device`` (default ``cuda``; a CUDA device without a
GPU raises).  ``--in-memory-map`` keeps the global map in memory (no h5py
needed, nothing persisted).

``--pipeline warpsense-sharded`` runs ``ShardedWarpsenseApp``: as a world
of one in a plain process, or one rank per process under torchrun (each
rank on cuda:LOCAL_RANK unless ``--device`` names another device; each
rank persists its rows into ``<map>.p<rank>.h5``):

    torchrun --nproc-per-node 4 -m warpsense_tpu_torch.eval.slam_eval \
        --pipeline warpsense-sharded --frames 20

Two ranks on one GPU need ``--backend gloo`` (NCCL refuses two ranks on
one device).
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from ..core.config import Params
from ..io.dataset import SyntheticDataset
from ..io.trajectory import ate_rmse, write_tum


def default_params(channels: int, columns: int) -> Params:
    return Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 64, "max_weight": 10,
                "size": {"x": 25, "y": 25, "z": 10}, "shift": 8.0,
                "update_distance": 0.1},
        "floam": {"min_distance": 0.5, "max_distance": 40.0,
                  "edge_threshold": 0.5, "surf_threshold": 0.05,
                  "edge_resolution": 0.15, "optimization_steps": 3,
                  "enrich": 4, "vgicp_fitness_score": 6.0},
        "registration": {"max_iterations": 200, "epsilon": 0.03,
                         "it_weight_gradient": 0.1, "mode": "fast"},
        "lidar": {"channels": channels, "hresolution": columns},
    })


def run_warpsense(dataset, params: Params, map_path: Path | None, *,
                  capacity: int = 32768, device="cuda",
                  in_memory_map: bool = False, tum_out=None,
                  sharded: bool = False) -> dict:
    """``sharded``: the sharded app over this process's mesh (the
    initialized default group, or a world of one)."""
    if sharded:
        from ..pipeline.warpsense_sharded import ShardedWarpsenseApp
        app = ShardedWarpsenseApp(params, map_path=map_path,
                                  capacity=capacity, device=device,
                                  in_memory_map=in_memory_map)
    else:
        from ..pipeline.warpsense import WarpsenseApp
        app = WarpsenseApp(params, map_path=map_path, capacity=capacity,
                           device=device, in_memory_map=in_memory_map)
    truth, est, times, stamps = [], [], [], []
    for frame in dataset:
        t0 = time.perf_counter()
        pose_mm = app.cloud_callback(frame.cloud, frame.stamp)
        times.append(time.perf_counter() - t0)
        pose_m = pose_mm.astype(np.float64).copy()
        pose_m[:3, 3] /= 1000.0
        est.append(pose_m)
        truth.append(frame.ground_truth)
        stamps.append(frame.stamp)
    app.terminate()
    return _report(np.stack(est), truth, times, stamps, tum_out)


def run_featsense(dataset, params: Params, map_path: Path | None, *,
                  edge_capacity: int = 2048, surf_capacity: int = 4096,
                  cloud_capacity: int = 32768, device="cuda",
                  in_memory_map: bool = False, tum_out=None) -> dict:
    from ..pipeline.featsense import FeatsenseApp

    app = FeatsenseApp(params, map_path=map_path,
                       edge_capacity=edge_capacity,
                       surf_capacity=surf_capacity,
                       cloud_capacity=cloud_capacity, device=device,
                       in_memory_map=in_memory_map)
    truth, est, times, stamps = [], [], [], []
    for frame in dataset:
        t0 = time.perf_counter()
        pose = app.process_scan(frame.cloud, frame.stamp)
        times.append(time.perf_counter() - t0)
        est.append(pose)
        truth.append(frame.ground_truth)
        stamps.append(frame.stamp)
    app.terminate()
    return _report(np.stack(est), truth, times, stamps, tum_out)


def _report(est: np.ndarray, truth, times: list[float], stamps,
            tum_out=None) -> dict:
    """The run's JSON report; with ``tum_out``, the estimated trajectory
    (meters) is written there in TUM format."""
    if tum_out is not None:
        write_tum(tum_out, est, np.asarray(stamps, np.float64))
    steady = times[2:] if len(times) > 4 else times  # skip warm-up frames
    out = {
        "frames": len(times),
        "scan_ms_avg": round(float(np.mean(steady)) * 1000, 2),
        "scans_per_s": round(1.0 / float(np.mean(steady)), 2),
    }
    if truth is not None:
        # ATE over the frames that HAVE ground truth (timestamp-matched
        # GT legitimately skips frames outside the tolerance)
        have = [i for i, t in enumerate(truth) if t is not None]
        if len(have) >= 3:
            truth_a = np.stack([truth[i] for i in have])
            est_a = est[have]
            out["ate_rmse_m"] = round(ate_rmse(est_a, truth_a, align=True), 4)
            out["ate_rmse_raw_m"] = round(
                ate_rmse(est_a, truth_a, align=False), 4)
            out["ate_frames"] = len(have)
    return out


def main(argv=None) -> dict:
    """Parse ``argv``, run, print the report as one JSON line; returns it."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pipeline",
                    choices=["warpsense", "warpsense-sharded", "featsense"],
                    default="warpsense")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--columns", type=int, default=1024)
    ap.add_argument("--radius", type=float, default=2.0,
                    help="accepted for the JAX CLI's command lines; unused")
    ap.add_argument("--map-out", default=None)
    ap.add_argument("--tum-out", default=None,
                    help="write the estimated trajectory (TUM, meters)")
    ap.add_argument("--bag", default=None,
                    help="drive from a rosbag1 file instead of synthetic")
    ap.add_argument("--cloud-topic", default="/os_cloud_node/points")
    ap.add_argument("--imu-topic", default=None)
    ap.add_argument("--tum-gt", default=None,
                    help="TUM ground-truth file for ATE against the bag")
    ap.add_argument("--gt-tolerance", type=float, default=0.05,
                    help="max |scan stamp - GT stamp| (s) to associate")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    ap.add_argument("--in-memory-map", action="store_true",
                    help="keep the global map in memory (no HDF5 file)")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="warpsense-sharded under torchrun: the process "
                         "group's backend")
    args = ap.parse_args(argv)

    if args.bag:
        from ..io.rosbag import RosbagDataset
        from ..io.trajectory import read_tum
        ds = RosbagDataset(args.bag, args.cloud_topic, args.imu_topic,
                           channels=args.channels, columns=args.columns)
        frames = list(ds)
        if args.tum_gt:
            # associate by NEAREST TIMESTAMP, not list index: GT files are
            # routinely sampled at a different rate than the cloud topic
            # and bags drop scans
            stamps, gt = read_tum(args.tum_gt)
            for fr in frames:
                j = int(np.argmin(np.abs(stamps - fr.stamp)))
                if abs(float(stamps[j]) - fr.stamp) <= args.gt_tolerance:
                    fr.ground_truth = gt[j]
        dataset = frames
    else:
        dataset = SyntheticDataset(args.frames, channels=args.channels,
                                   columns=args.columns)
    params = default_params(args.channels, args.columns)
    if args.in_memory_map:
        map_path = None
    else:
        map_path = Path(args.map_out) if args.map_out else (
            Path(tempfile.mkdtemp()) / "slam_eval.h5")
    kw = dict(device=args.device, in_memory_map=args.in_memory_map,
              tum_out=args.tum_out)
    if args.pipeline == "featsense":
        stats = run_featsense(dataset, params, map_path, **kw)
    elif args.pipeline == "warpsense":
        stats = run_warpsense(dataset, params, map_path, **kw)
    else:
        stats = _run_sharded(args, dataset, params, map_path, kw)
    stats["pipeline"] = args.pipeline
    print(json.dumps(stats))
    return stats


def _run_sharded(args, dataset, params, map_path, kw) -> dict:
    """The sharded warpsense run as one rank of the torchrun job (or a
    world of one); the report carries the rank and the world size."""
    import os

    import torch.distributed as dist

    from ..parallel.distributed import init_distributed
    from ..parallel.sharded import make_mesh

    if args.device == "cuda" and "LOCAL_RANK" in os.environ:
        kw["device"] = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    joined = init_distributed(backend=args.backend)
    try:
        stats = run_warpsense(dataset, params, map_path, sharded=True, **kw)
        mesh = make_mesh(kw["device"])
        stats.update(rank=mesh.rank, world=mesh.world)
    finally:
        if joined:
            dist.destroy_process_group()
    return stats


if __name__ == "__main__":
    main()
