"""The precision control of a cell's check: the plain reference in the
program's place, its registration statistics in bfloat16 (the nearest
precision below the configuration's float32), held to the reference in
float32 by the cell's own comparison and limits.  It must come out not
correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

prints, for each seed, ``correct`` and every number (JSON, one line a
seed), and exits with 1 if the control comes out correct on any seed.
Runs on the card at the cell's size; ``benchmark/tests/test_bench_control.py``
runs it on the CPU at a tiny size.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def control_numbers(cfg, traffic, scans: int, device, *,
                    free_scans: int = 0) -> dict:
    """The numbers of the bfloat16 reference (in the program's place, on
    its own) against the float32 reference, over ``scans`` scans."""
    import torch

    from harness import check
    ref16, poses16 = check.replay(cfg, traffic, scans, device,
                                  stats_dtype=torch.bfloat16)
    v, w, pos, off = ref16.window_box()
    window = (check_roll(v.cpu().numpy(), off),
              check_roll(w.cpu().numpy(), off), pos, off)
    del ref16, v, w
    return check.reference_numbers(cfg, traffic, poses16, window,
                                   device=device, free_scans=free_scans)


def check_roll(box, offset):
    """A window in global order laid out as the program's ring buffer
    (the inverse of ``check.unroll``)."""
    import numpy as np
    out = box
    for ax in range(3):
        s = box.shape[ax]
        out = np.roll(out, int(offset[ax]) - s // 2, axis=ax)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch

    from harness import check, discover
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = discover.benchmark()
    cell = discover.cell(bench, args.workload)
    cfg = discover.config(cell["config"])
    mix = discover.mix(cell["traffic"])
    checks = discover.checks(args.workload)
    scans = int(cfg["warmup_scans"]) + int(checks["scans"])
    gen = discover.generator(mix["kind"])
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        traffic = gen.make(mix, seed % (1 << 63), cfg["lidar"],
                           torch.device("cuda"))
        nums = control_numbers(cfg, traffic, scans, torch.device("cuda"),
                               free_scans=int(checks.get("free_scans", 0)))
        judged = check.judge(nums, checks["limits"], 0)
        correct = check.passed(judged)
        caught &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "correct": correct, **nums}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
