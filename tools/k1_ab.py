#!/usr/bin/env python3
"""Time kernel K1 of two or more checkouts of warpsense_tpu_torch on one GPU.

    python3 tools/k1_ab.py ROOT [ROOT ...]

Each ROOT is a directory holding a ``warpsense_tpu_torch`` package (a
checkout of another commit, unpacked with ``git archive``, or ``.``).  Every
ROOT runs in a process of its own, in the order given (give them as A B B A
to see the drift between turns), and prints one JSON line: K1's level and
4-degree tilt times at the full 625 x 625 x 235 window and at
configs/default.yaml's 625 x 625 x 391.  The cases, the map they run on and
the timing are chip_smoke.py's (this checkout's): its K1 checks fuse the
map, checking the ROOT's kernel against its plain version on the way, then
``time_fusion`` times each case from a copy of that map.  The first line is
the card's name and power limit as nvidia-smi gives them.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def time_root(root: str) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs           # this checkout's, whatever ROOT holds
    # the package comes from ROOT: chip_smoke imports it inside its functions
    sys.path[0] = str(Path(root).resolve())
    import torch
    device = torch.device("cuda", 0)
    out = {"root": root}
    for name, cfg in (("full", cs.FULL), ("default", cs.default_fusion_cfg())):
        state, _ = cs.check_fusion(torch, cfg, device)
        times = cs.time_fusion(torch, cfg, state, ("level", "tilt"),
                               bounds=False)
        for case, t in times.items():
            out[f"{name}_{case}_ms"] = t["ms"]
        del state
        torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(time_root(argv[2])), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
