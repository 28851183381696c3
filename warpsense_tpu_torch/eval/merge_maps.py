"""Merge per-rank HDF5 maps of a multi-GPU run into one map.

Counterpart of ``warpsense_tpu/eval/merge_maps.py``.  A
``ShardedWarpsenseApp`` run with more than one rank persists one file per
rank (``<name>.p<rank>.h5``), each holding exactly the voxels of that
rank's rows (x_rows-scoped slab IO, pipeline/warpsense_sharded.py).  This
tool folds them into one map of the reference schema
(src/map/hdf5_global_map.cpp), which the single-GPU tooling reads:

    python -m warpsense_tpu_torch.eval.merge_maps run.p0.h5 run.p1.h5 \
        -o run.h5

Merge rule: per voxel, the FIRST input with a nonzero WEIGHT wins (the
packed uint32 entry is weight<<16 | value; ranks own disjoint voxel rows,
so at most one input has a nonzero weight anywhere).  Poses and map meta
attributes come from the first input that has them (every rank writes the
same pose path).

Limitation: files written with ``map.initial_weight != 0`` are ambiguous
to merge: their untouched voxels carry a nonzero weight and cannot be
told apart from fused data (the pipelines' default initial_weight is 0,
as in the reference).
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def merge(inputs, output) -> dict:
    import h5py

    inputs = list(inputs)
    with h5py.File(output, "w") as out:
        om = out.require_group("map")
        op = out.require_group("poses")
        poses_done = False
        for src_path in inputs:
            with h5py.File(src_path, "r") as src:
                if "map" in src:
                    if not om.attrs and src["map"].attrs:
                        for a, v in src["map"].attrs.items():
                            om.attrs[a] = v
                    for tag, ds in src["map"].items():
                        raw = np.asarray(ds[...], np.uint32)
                        if tag in om:
                            cur = np.asarray(om[tag][...], np.uint32)
                            # first nonzero weight wins
                            keep = (cur >> 16) != 0
                            om[tag][...] = np.where(keep, cur, raw)
                        else:
                            om.create_dataset(tag, data=raw,
                                              dtype=np.uint32)
                if not poses_done and "poses" in src and len(src["poses"]):
                    for name, grp in src["poses"].items():
                        g = op.create_group(name)
                        g.create_dataset("pose", data=grp["pose"][...])
                    poses_done = True
        return {"inputs": len(inputs), "chunks": len(om),
                "poses": len(op)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("inputs", nargs="+", help="per-process .h5 files")
    ap.add_argument("-o", "--output", required=True)
    args = ap.parse_args(argv)
    print(json.dumps(merge(args.inputs, args.output)))


if __name__ == "__main__":
    main()
