#!/usr/bin/env python3
"""Time kernels K1 and K2, and the registration loop kernel, of two or more
checkouts of warpsense_tpu_torch on one GPU, or run their SHARDED phases.

    python3 tools/kernel_ab.py [--kernels k1,k2,loop | sharded | shardloop]
        ROOT [ROOT ...]

Each ROOT is a directory holding a ``warpsense_tpu_torch`` package (a
checkout of another commit, unpacked with ``git archive``, or ``.``).  Every
ROOT runs in a process of its own, in the order given (give them as A B B A
to see the drift between turns), and prints one JSON line.  The cases, the
checks and the timing are chip_smoke.py's (this checkout's):

* k1: K1's level and 4-degree tilt times at the full 625 x 625 x 235
  window and at configs/default.yaml's 625 x 625 x 391; chip_smoke's K1
  checks fuse the map, checking the ROOT's kernel against its plain version
  on the way, then ``time_fusion`` times each case from a copy of that map;
* k2: K2's packed and exact times at 625 x 625 x 235 on chip_smoke's seeded
  full-range window, after ``check_fields`` has held the ROOT's kernel to
  its plain versions on it: one call and per launch (``time_fields``),
  with the copy yardstick beside them;
* loop: the registration loop kernel (a checkout that has it) on
  chip_smoke's REGLOOP problems (``time_loops``): its device time an
  iteration on the whole cloud and on every 1,024th point, and one
  registration between events;
* shardloop (alone): the ROOT's own SHARDLOOP timing, its
  ``chip_smoke.time_shard_loops`` on its REGLOOP problems after its
  ``build_kernels()`` (the sharded loop at a world of one, no group):
  each problem's iterations, launches, one registration between events,
  the loop's device time an iteration (torch.profiler) and, where the
  checkout measures it, the host clock of a registration;
* sharded (alone): the ROOT's own SHARDED phase, its
  ``chip_smoke.run_sharded`` after its ``build_kernels()`` (two gloo ranks
  on the card, then its NCCL rank of one, with that checkout's app, loop
  and checks): every gloo rank's spans (``stage_avg_ms``), scan times and
  registration loop report, where the checkout makes one, and the NCCL
  rank's registration times.

The first line is the card's name and power limit as nvidia-smi gives them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KERNELS = ("k1", "k2", "loop", "sharded", "shardloop")
ALONE = ("sharded", "shardloop")


def sharded_root(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import chip_smoke as cs           # ROOT's: its ranks import it by name
    import torch
    cs.build_kernels()
    rep = cs.run_sharded(torch, cs.SHARDED)
    loops = rep.get("registration") or [None] * len(rep["ranks"])
    nccl = rep.get("nccl_registration")
    return {"root": root, "ranks": [
        dict(rank=r["rank"], stage_avg_ms=r["stage_avg_ms"],
             scan_ms=r["scan_ms"], **({"loop": loop} if loop else {}))
        for r, loop in zip(rep["ranks"], loops)],
        **({"nccl": {k: nccl.get(k) for k in (
            "ms_by_registration", "loop_ms_repeated", "header_reads",
            "syncs_by_registration")}} if nccl else {})}


def shardloop_root(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import chip_smoke as cs           # ROOT's own checks and timing
    import torch
    cs.build_kernels()
    device = torch.device("cuda", 0)
    full, _ = cs.check_fusion(torch, cs.FULL, device)
    default, _ = cs.check_fusion(torch, cs.default_fusion_cfg(), device)
    probs = cs.regloop_problems(torch, full, default, device)
    poses = [p.to(device) for p in cs.regloop_poses(torch)]
    keys = ("iterations", "launches", "ms", "device_ms_per_iteration",
            "host_ms", "host_ms_eager", "ms_eager")
    return {"root": root, "loops": {
        name: {k: t[k] for k in keys if k in t}
        for name, t in cs.time_shard_loops(torch, probs, poses).items()}}


def time_root(root: str, kernels) -> dict:
    if kernels == ["sharded"]:
        return sharded_root(root)
    if kernels == ["shardloop"]:
        return shardloop_root(root)
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs           # this checkout's, whatever ROOT holds
    # the package comes from ROOT: chip_smoke imports it inside its functions
    sys.path[0] = str(Path(root).resolve())
    import torch
    device = torch.device("cuda", 0)
    out = {"root": root}
    if "k1" in kernels:
        for name, cfg in (("full", cs.FULL),
                          ("default", cs.default_fusion_cfg())):
            state, _ = cs.check_fusion(torch, cfg, device)
            times = cs.time_fusion(torch, cfg, state, ("level", "tilt"),
                                   bounds=False)
            for case, t in times.items():
                out[f"{name}_{case}_ms"] = t["ms"]
            del state
            torch.cuda.empty_cache()
    if "k2" in kernels:
        state = cs.seeded_fields_state(torch, cs.FULL["size"], device)
        cs.check_fields(torch, state, cs.FULL["tau"], "seeded_full")
        for name, t in cs.time_fields(torch, cs.FULL, state).items():
            for key in ("ms", "per_launch_ms", "copy_ms"):
                out[f"k2_{name}_{key}"] = t[key]
        del state
        torch.cuda.empty_cache()
    if "loop" in kernels:
        full, _ = cs.check_fusion(torch, cs.FULL, device)
        default, _ = cs.check_fusion(torch, cs.default_fusion_cfg(), device)
        probs = cs.regloop_problems(torch, full, default, device)
        poses = [p.to(device) for p in cs.regloop_poses(torch)]
        for name, t in cs.time_loops(torch, probs, poses).items():
            key = f"loop_{name}"
            out[f"{key}_iterations"] = t["iterations"]
            out[f"{key}_us_per_iteration"] = \
                t["device_ms_per_iteration"] * 1e3
            out[f"{key}_few_points_us_per_iteration"] = \
                t["few_points_device_ms_per_iteration"] * 1e3
            out[f"{key}_ms"] = t["ms"]
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="k1,k2",
                    help="comma-separated subset of k1,k2,loop, or "
                    "sharded or shardloop alone")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv[1:])
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels takes a subset of {','.join(KERNELS)}")
    if set(kernels) & set(ALONE) and len(kernels) > 1:
        ap.error("--kernels sharded and shardloop run alone")
    if args.one:
        print(json.dumps(time_root(args.roots[0], kernels)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in args.roots:
        subprocess.run([sys.executable, __file__, "--one",
                        "--kernels", args.kernels, root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
