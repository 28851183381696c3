"""Faults planted in the program under the harness: each breaks the timed
path underneath a run, whose check must then come out not correct.

    python3 benchmark/faults.py --workload <cell> --fault <name> \
        --seeds 1,2,3 --seconds 18

runs the cell with the fault on the card, at the cell's size, and prints
for each seed ``correct`` and every number compared beside its limit
(JSON, one line a seed); it exits with 1 if any run comes out correct.
The window has to be long enough for the cell's checked scans.
``benchmark/tests/test_bench_rehearsal.py`` plants each fault on the CPU
at a tiny size.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def unchanged(app):
    """A step that returns its state unchanged."""
    def cloud_callback(cloud_m, stamp):
        return app.pose.copy()
    app.cloud_callback = cloud_callback


def half_batch(app):
    """Half of each scan's points left out."""
    orig = app.cloud_callback

    def cloud_callback(cloud_m, stamp):
        flat = cloud_m.reshape(-1, 3).copy()
        flat[1::2] = 0.0
        return orig(flat, stamp)
    app.cloud_callback = cloud_callback


def altered(app):
    """The pose altered where it is produced: 1 mm along x, in the app's
    own state, after every scan."""
    orig = app.cloud_callback

    def cloud_callback(cloud_m, stamp):
        orig(cloud_m, stamp)
        app.pose[0, 3] += np.float32(1.0)
        return app.pose.copy()
    app.cloud_callback = cloud_callback


def after_shift_altered(app):
    """The pose of the scan after each window shift, the first registered
    against the shifted window, altered by 1 mm along x in the app's own
    state."""
    orig = app.cloud_callback

    def cloud_callback(cloud_m, stamp):
        after = app.shifted             # the scan before ended in a shift
        orig(cloud_m, stamp)
        if after:
            app.pose[0, 3] += np.float32(1.0)
        return app.pose.copy()
    app.cloud_callback = cloud_callback


def no_write_back(app):
    """A shift that evicts its slabs without writing them to the global
    map, so that a later load-back brings back what the global map held
    before (the empty map where the drive has not been)."""
    app.local_map._save_area = lambda start, end: None


FAULTS = {f.__name__: f for f in (unchanged, half_batch, altered,
                                  after_shift_altered, no_write_back)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch

    from harness import discover
    from harness.cell import run_cell
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = discover.benchmark()
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = run_cell(bench, args.workload, seed=seed % (1 << 63),
                     seconds=args.seconds, trace=False,
                     sabotage=FAULTS[args.fault])
        caught &= r["correct"] is False
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "attempted": r["attempted"],
                          "seconds": time.perf_counter() - t0,
                          "correct": r["correct"], "check": r["check"]}),
              flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
