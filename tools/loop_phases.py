#!/usr/bin/env python3
"""The registration loop kernel at the portable cluster size (8 CTAs) and at
the one it is built with (16), and where an iteration spends its cycles.

    python3 tools/loop_phases.py [ROOT]

ROOT (default ``.``) holds a ``warpsense_tpu_torch`` package and its
``chip_smoke.py``.  The package's kernel sources are copied to
ROOT/_smoke/loop_phases/ (a gitignored directory) and built from there,
``csrc/registration.cu`` four times, with the two macros it keeps for this
tool: ``WS_REG_CLUSTER`` (8 or 16 CTAs) and, or not, ``WS_LOOP_PHASES``
(CTA 0's thread 0 reads the SM's clock at the boundaries of each
iteration's phases and writes the differences into the zero columns of the
loop's trace, the 30th to 32nd of its first three rows of statistics).
The phases, in order: ``stats`` (this thread's points), ``reduce+row``
(the warp tree, the warps' sum and the row's stores into every CTA, which
waits for the CTA's slowest warp), ``cluster.sync``, ``rows`` (the C rows
summed), ``step:setup``, ``step:solve6``, ``step:apply_xi``, ``step:tail``
(the tests) and ``syncthreads`` (the CTA waiting for warp 0's step).

For each cluster size it prints, one JSON line a problem of chip_smoke's
REGLOOP (FULL's packed and exact fields, DEFAULT's parity fields, and the
fast app's packed problem without the coarse phase), from chip_smoke's first
pose: the build without stamps timed as chip_smoke times the loop
(``time_loops``: device time an iteration on the whole cloud and on every
1,024th point, one registration between events), then the stamped build's
median cycles of each phase over the iterations after the first, once on
the whole cloud and once on every 1,024th point.  The first line is the
card's name, power limit and SM clock as nvidia-smi gives them.  Needs one
GPU.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

PHASES = ("stats", "reduce+row", "cluster.sync", "rows", "step:setup",
          "step:solve6", "step:apply_xi", "step:tail", "syncthreads")
CLUSTERS = (16, 8)


def main(argv: list[str]) -> int:
    root = Path(argv[0] if argv else ".").resolve()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from warpsense_tpu_torch.kernels import _build
    from warpsense_tpu_torch.kernels import registration as kreg
    from warpsense_tpu_torch.ops import registration as treg
    src = (_build.SRC_DIR / "registration.cu").read_text()
    work = root / "_smoke" / "loop_phases"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.SRC_DIR, work / "csrc")
    _build.SRC_DIR, _build.BUILD_DIR = work / "csrc", work / "_build"

    def build(cluster: int, phases: bool) -> None:
        head = f"#define WS_REG_CLUSTER {cluster}\n"
        if phases:
            head += "#define WS_LOOP_PHASES 1\n"
        (_build.SRC_DIR / "registration.cu").write_text(head + src)
        _build._libs.pop("registration", None)
        kreg._placed.clear()
        kreg.CLUSTER = cluster
        kreg.TRACE_WIDTH = treg.trace_width(cluster)

    dev = torch.device("cuda", 0)
    cs.build_kernels()
    full, _ = cs.check_fusion(torch, cs.FULL, dev)
    default, _ = cs.check_fusion(torch, cs.default_fusion_cfg(), dev)
    probs = cs.regloop_problems(torch, full, default, dev)
    pose = cs.regloop_poses(torch)[0].to(dev)
    timed = dict(packed_app=probs["packed"]._replace(coarse_iterations=0),
                 **probs)
    for cluster in CLUSTERS:
        build(cluster, phases=False)
        times = cs.time_loops(torch, probs, [pose])
        build(cluster, phases=True)
        for name, prob in timed.items():
            out = dict(problem=name, cluster=cluster,
                       **{k: times[name][k] for k in (
                           "iterations", "ms", "device_ms_per_iteration",
                           "empty_cluster_device_ms_per_iteration",
                           "few_points_device_ms_per_iteration")})
            for cloud in ("all", "every_1024th"):
                p = prob if cloud == "all" else prob._replace(
                    points=prob.points[::1024], mask=prob.mask[::1024],
                    epsilon=0.0)
                trace = torch.zeros((p.max_iterations, kreg.TRACE_WIDTH),
                                    device=dev)
                st = treg.init_state(p, pose, dev)
                kreg.reg_loop(st, p, trace=trace)
                n = int(st[treg.S_I])
                cyc = trace[:n, treg.STATE_LEN:].reshape(
                    n, cluster, treg.PARTIALS)[:, :3, 29:].reshape(n, 9)
                med = (cyc[1:] if n > 1 else cyc).median(dim=0).values
                phases = dict(zip(PHASES, (int(x) for x in med)))
                out[f"cycles_{cloud}"] = dict(phases, iterations=n,
                                              total=sum(phases.values()))
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
