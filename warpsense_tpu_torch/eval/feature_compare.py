"""feature_compare: featsense features on the device vs the host twin vs
the ORIGINAL F-LOAM selection.

Counterpart of ``warpsense_tpu/eval/feature_compare.py`` (the reference's
``feature_compare_node``, test/feature_compare.cpp, publishes the edge and
surf features of the vendored original F-LOAM and of featsense on one
cloud for a visual comparison).  Here the comparison is counted on one
organized scan:

* the feature stage on ``--device`` vs its loop-exact host twin
  (``features_reference``; the same spec, so they should agree);
* the device's picks vs the independent original-F-LOAM selection
  (``floam_original``, test/floam.h:150-245): another algorithm by design,
  so the report gives counts and overlap.

    python -m warpsense_tpu_torch.eval.feature_compare [--pcd cloud.pcd]
        [--channels 64 --columns 512] [--out-dir DIR] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run(cloud: np.ndarray, *, edge_capacity: int = 2048,
        surf_capacity: int = 4096, out_dir: str | None = None,
        device="cuda") -> dict:
    """The comparison on one organized (H, W, 3) cloud (meters); the
    feature stage runs on ``device`` (a CUDA device without a GPU
    raises)."""
    import torch

    from ..frontends.featsense import features as dev
    from ..frontends.featsense import features_reference as ref
    from ..frontends.featsense.floam_original import floam_original_features
    from ..utils.device import resolve_device

    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    e_ref, s_ref = ref.extract_features(cloud, ref.FeatureParams())
    host_s = time.perf_counter() - t0

    tc = torch.as_tensor(np.asarray(cloud, np.float32), device=device)
    kw = dict(edge_capacity=edge_capacity, surf_capacity=surf_capacity)
    dev.extract_features(tc, **kw)            # warm-up (first launches)
    sync()
    t0 = time.perf_counter()
    (e_pts, e_mask, e_idx), (s_pts, s_mask, s_idx) = dev.extract_features(
        tc, **kw)
    sync()
    dev_s = time.perf_counter() - t0

    e_mask, s_mask = e_mask.cpu().numpy(), s_mask.cpu().numpy()
    e_dev = set(e_idx.cpu().numpy()[e_mask].tolist())
    s_dev = set(s_idx.cpu().numpy()[s_mask].tolist())
    e_set, s_set = set(map(int, e_ref)), set(map(int, s_ref))

    t0 = time.perf_counter()
    e_fl, s_fl = floam_original_features(cloud.reshape(-1, 3))
    floam_s = time.perf_counter() - t0
    e_flo, s_flo = set(map(int, e_fl)), set(map(int, s_fl))

    def jaccard(a, b):
        return len(a & b) / max(len(a | b), 1)

    def recall(found, other):
        """Fraction of the other algorithm's picks ``found`` also has."""
        return len(found & other) / max(len(other), 1)

    result = {
        "metric": "feature_compare",
        "device": str(device),
        "edges": {"host": len(e_set), "device": len(e_dev),
                  "floam": len(e_flo),
                  "jaccard": round(jaccard(e_set, e_dev), 4),
                  "floam_recall": round(recall(e_dev, e_flo), 4),
                  "floam_precision": round(recall(e_flo, e_dev), 4)},
        "surfs": {"host": len(s_set), "device": len(s_dev),
                  "floam": len(s_flo),
                  "jaccard": round(jaccard(s_set, s_dev), 4),
                  "floam_recall": round(recall(s_dev, s_flo), 4),
                  "floam_precision": round(recall(s_flo, s_dev), 4)},
        "host_ms": round(host_s * 1e3, 1),
        "device_ms": round(dev_s * 1e3, 1),
        "floam_ms": round(floam_s * 1e3, 1),
    }
    if out_dir is not None:
        from pathlib import Path

        from ..io.pcd import write_ply
        d = Path(out_dir)
        d.mkdir(parents=True, exist_ok=True)
        flat = cloud.reshape(-1, 3)
        write_ply(d / "edges_host.ply", flat[sorted(e_set)])
        write_ply(d / "surfs_host.ply", flat[sorted(s_set)])
        write_ply(d / "edges_device.ply", e_pts.cpu().numpy()[e_mask])
        write_ply(d / "surfs_device.ply", s_pts.cpu().numpy()[s_mask])
        result["out_dir"] = str(d)
    return result


def synthetic_scan(channels: int, columns: int) -> np.ndarray:
    """The CLI's default scan: the box world from the origin."""
    from ..io.synthetic import BoxWorld, render_scan
    return render_scan(BoxWorld.default(), np.eye(4), channels=channels,
                       columns=columns, max_range=22.0, noise_std=0.005,
                       rng=np.random.default_rng(0))


def main(argv=None) -> dict:
    """Parse ``argv``, run, print the report as one JSON line; returns it."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pcd", default=None, help="organized cloud to load")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--columns", type=int, default=512)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    if args.pcd is not None:
        from ..io.pcd import read_pcd
        pts = read_pcd(args.pcd).astype(np.float32)
        n = args.channels * args.columns
        if len(pts) < n:
            pts = np.concatenate([pts, np.zeros((n - len(pts), 3),
                                                np.float32)])
        cloud = pts[:n].reshape(args.channels, args.columns, 3)
    else:
        cloud = synthetic_scan(args.channels, args.columns)
    report = run(cloud, out_dir=args.out_dir, device=args.device)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
