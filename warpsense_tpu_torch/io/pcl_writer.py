"""Cloud export tool: dump numbered .pcd/.ply files from a dataset.

Counterpart of ``warpsense_tpu/io/pcl_writer.py`` (the reference's
pcl_writer node, src/visualization/pcl_writer.cpp:18-109, minus ROS): it
drains any dataset iterable (synthetic by default) and writes what
``io.dataset.PcdDirectoryDataset`` reads back.

    python -m warpsense_tpu_torch.io.pcl_writer --out clouds --format pcd \
        --frames 20
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .dataset import SyntheticDataset
from .pcd import write_pcd, write_ply
from .trajectory import write_tum


def export(dataset, out_dir: str | Path, fmt: str = "pcd") -> int:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    poses = []
    n = 0
    for i, frame in enumerate(dataset):
        cloud = np.asarray(frame.cloud, np.float32).reshape(-1, 3)
        cloud = cloud[np.any(cloud != 0.0, axis=1)]
        path = out / f"cloud{i}.{fmt}"
        if fmt == "ply":
            write_ply(path, cloud)
        else:
            write_pcd(path, cloud)
        if frame.ground_truth is not None:
            poses.append(frame.ground_truth)
        n += 1
    if poses:
        write_tum(out / "ground_truth.tum", np.stack(poses))
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--format", choices=["pcd", "ply"], default="pcd")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--columns", type=int, default=1024)
    args = ap.parse_args(argv)
    ds = SyntheticDataset(args.frames, channels=args.channels,
                          columns=args.columns)
    n = export(ds, args.out, args.format)
    print(f"wrote {n} clouds to {args.out}")


if __name__ == "__main__":
    main()
