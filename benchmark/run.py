"""The benchmark of warpsense_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  ``--trace 0`` measures the cell's end-to-end metrics over a window
of ``--seconds``; ``--trace 1`` its per-layer metrics (spans, probes and
a ``torch.profiler`` trace, written under ``benchmark/out/``).  Every run
then checks the program's outputs against the plain reference
(``harness/check.py``).  The last line of standard output is the result
object; the numbers compared and their limits are also the last lines of
standard error.  Without a card, or with fewer than the cell's, it exits
with 2 and prints no result; with JAX or the JAX package loaded, with 3.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _finite(x):
    """The result as strict JSON: a non-finite number reads 1e308 (or
    -1e308); NaN reads 1e308."""
    if isinstance(x, float) and not math.isfinite(x):
        return -1e308 if x < 0 else 1e308
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    os.environ.setdefault("CUDA_CACHE_PATH", str(HERE / "out" / "nv_cache"))
    from harness import discover, guard

    bench = discover.benchmark()
    cell = discover.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from harness.cell import run_cell
    result = run_cell(bench, args.workload, seed=args.seed % (1 << 63),
                      seconds=args.seconds, trace=bool(args.trace))
    foreign = guard.foreign_modules()
    if foreign:
        print(f"loaded in this process: {', '.join(foreign)}",
              file=sys.stderr)
        return 3
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
