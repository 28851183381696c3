#!/usr/bin/env python3
"""The feature stage on the card against the same stage on the CPU: one
synthetic organized scan through ``frontends/featsense/features`` on
``cuda`` and on ``cpu``, stage by stage — curvature and ranges (bit
mismatches), the occlusion mask, and the edge and surf picks, with the
curvature ties among each set's differing picks.  Prints one JSON line.

    python3 tools/feature_card_vs_cpu.py [--channels 128 --columns 1024]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from warpsense_tpu_torch.eval.feature_compare import synthetic_scan
    from warpsense_tpu_torch.frontends.featsense import features as f

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--columns", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    cloud = synthetic_scan(args.channels, args.columns)
    out = {"device": torch.cuda.get_device_name(0)}
    runs = {}
    for name in ("cpu", "cuda"):
        t = torch.as_tensor(np.asarray(cloud, np.float32), device=name)
        curv, ranges = f.curvature_and_ranges(t)
        picked = f.mark_occluded(ranges, f.FeatureParams())
        (_, em, ei), (_, sm, si) = f.extract_features(
            t, edge_capacity=4096, surf_capacity=32768)
        runs[name] = dict(
            curv=curv.cpu().numpy(), ranges=ranges.cpu().numpy(),
            picked=picked.cpu().numpy(),
            edges=set(ei.cpu().numpy()[em.cpu().numpy()].tolist()),
            surfs=set(si.cpu().numpy()[sm.cpu().numpy()].tolist()))
    a, b = runs["cpu"], runs["cuda"]
    fin = np.isfinite(a["curv"])
    out["curv_bit_mismatches"] = int(
        (a["curv"][fin].view(np.int32) != b["curv"][fin].view(np.int32))
        .sum())
    out["ranges_bit_mismatches"] = int(
        (a["ranges"].view(np.int32) != b["ranges"].view(np.int32)).sum())
    out["occlusion_mismatches"] = int((a["picked"] != b["picked"]).sum())
    flat = a["curv"].reshape(-1)
    for group in ("edges", "surfs"):
        only_cpu = sorted(a[group] - b[group])
        only_cuda = sorted(b[group] - a[group])
        diff = only_cpu + only_cuda
        vals = flat[diff]
        out[group] = {
            "cpu": len(a[group]), "cuda": len(b[group]),
            "only_cpu": len(only_cpu), "only_cuda": len(only_cuda),
            "differing_curvatures": sorted(set(vals.tolist()))[:12],
            "differing_with_a_tied_curvature": int(sum(
                (flat == v).sum() > 1 for v in vals))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
