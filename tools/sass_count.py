#!/usr/bin/env python3
"""Count the SASS instructions of K1's general sweep per voxel, for one or
more checkouts, and set them against the card's issue rate; or, with
``--fields``, count K2's instantiations.

    python3 tools/sass_count.py ROOT [ROOT ...]
    python3 tools/sass_count.py --fields ROOT [ROOT ...]

Each ROOT holds a ``warpsense_tpu_torch`` package (``.``, or a checkout of
another commit unpacked with ``git archive`` into a gitignored directory).
Its ``csrc/fusion.cu`` is compiled to a cubin with the package's nvcc
flags (sm_90a, -O3, -fmad=false) under chiprun_out/sass/, disassembled with
``cuobjdump -sass`` from the same toolkit, and ``general_kernel``'s z loop
(the body of its backward branch) is walked:

* the voxel's paths: from the loop head to its backward branch, leaving at
  the k-th early-out (a conditional jump to the loop's latch, in order; the
  last such jump is the new weight's zero test, not an early-out) or at
  none (``full``: a voxel that fuses, through the merge's averaging path);
* per (x, y) column, the instructions before the loop (once a warp).

The per-voxel stages come from this checkout's plain model
(``ops/tsdf_projective.general_rejects``) on chip_smoke's "tilt" case at
FULL (625 x 625 x 235) and DEFAULT (625 x 625 x 391).  A kernel with one
early-out leaves every rejected voxel there; one with an early-out per
stage leaves each at its own.  Two counts per case:

* ``lane``: each voxel's own path, summed, over 32 lanes a warp
  instruction;
* ``warp``: each warp iteration (32 consecutive z of a column) issues the
  path of its deepest lane, as the early-outs' paths are prefixes of one
  another (divergence within a warp costs the union).

Both add the prologue once a column.

``issue_floor_ms`` = warp instructions / (SMs x 4 issue slots x the SM's
highest clock): the least time the card could take to issue them.  The
first line is the card's name and power limit as nvidia-smi gives them.

``--fields``: ROOT's ``csrc/fields.cu`` is compiled the same way and each
instantiation of ``fields_kernel`` is listed by mode (packed, exact,
parity; a checkout with a bool template parameter has the first two):
its instructions, those that are not NOP, and a digest of the
instruction text without addresses, so that two checkouts' SASS of one
mode can be told equal or not.
"""
from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
OUT = HERE / "chiprun_out" / "sass"
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"^(@!?U?P\w+\s+)?BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)")


def disassemble(root: Path, tag: str, source: str = "fusion.cu") -> str:
    """cuobjdump -sass of ``root``'s ``source``, built as chip_smoke's build
    would build it (the shared-library flags left out); the cubin and the
    SASS are kept as chiprun_out/sass/<tag>.*."""
    from warpsense_tpu_torch.kernels import _build
    nvcc = _build.find_nvcc()
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
    OUT.mkdir(parents=True, exist_ok=True)
    cubin = OUT / f"{tag}.cubin"
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin),
                    str(root / "warpsense_tpu_torch" / "csrc" / source)],
                   check=True)
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    (OUT / f"{tag}.sass.txt").write_text(sass)
    return sass


def function_sass(sass: str, name: str) -> list[tuple[int, str]]:
    """(address, instruction) of the function whose mangled name holds
    ``name``."""
    blocks = re.split(r"\n\s*Function : ", sass)
    for b in blocks[1:]:
        head, _, body = b.partition("\n")
        if re.search(rf"\d{name}E", head):
            return [(int(a, 16), t) for a, t in _INSTR.findall(body)]
    raise ValueError(f"no function {name} in the SASS")


# fields_kernel's template argument in its mangled name: a bool (EXACT) or
# the Mode enum, each by its number
_FIELDS_MODE = re.compile(r"fields_kernelIL(?:b|\w*ModeE)(\d)E")
FIELDS_MODES = ("packed", "exact", "parity")


def fields_counts(sass: str) -> dict:
    """{mode: {instructions, not_nop, digest}} of every fields_kernel
    instantiation in ``sass``."""
    out = {}
    for b in re.split(r"\n\s*Function : ", sass)[1:]:
        head, _, body = b.partition("\n")
        m = _FIELDS_MODE.search(head)
        if not m:
            continue
        code = [t for _, t in _INSTR.findall(body)]
        out[FIELDS_MODES[int(m.group(1))]] = dict(
            function=head.strip(), instructions=len(code),
            not_nop=sum(not t.startswith("NOP") for t in code),
            digest=hashlib.sha256("\n".join(code).encode()).hexdigest()[:16])
    return out


def loop_paths(code: list[tuple[int, str]]) -> dict:
    """The z loop's paths (see the module docstring): ``exits`` (one count
    per early-out, in order), ``full`` (a voxel that fuses) and
    ``prologue`` (the instructions before the loop).

    A path's count is the longest path between two instructions over the
    loop's forward branches, never through an out-of-line call (the slow
    paths of sqrt, reciprocal and division), so each fast path and the
    merge's averaging path are the ones counted."""
    index = {a: i for i, (a, _) in enumerate(code)}
    jumps = {}
    for i, (a, t) in enumerate(code):
        m = _BRA.match(t)
        if m:
            jumps[i] = (index[int(m.group(2), 16)], m.group(1) is not None)
    tail, head = max(((i, j) for i, (j, _) in jumps.items() if j < i),
                     key=lambda b: b[0] - b[1])

    def longest(start, end):
        """Instructions on the longest path start -> end (both counted)."""
        best = {end: 1}
        for i in range(end - 1, start - 1, -1):
            if code[i][1].startswith("CALL"):
                continue
            nxt = []
            j, cond = jumps.get(i, (None, True))
            if j is not None and i < j <= end:
                nxt.append(j)
            if cond:                         # falls through
                nxt.append(i + 1)
            steps = [best[k] for k in nxt if k in best]
            if steps:
                best[i] = 1 + max(steps)
        return best[start]

    # the early-outs: the conditional jumps to the loop's latch, the target
    # most of the loop's conditional forward jumps share
    cond = [(i, j) for i, (j, c) in jumps.items() if c and head <= i < j
            and i < tail]
    targets = [j for _, j in cond]
    latch = max(set(targets), key=targets.count)
    exits = [i for i, j in cond if j == latch][:-1]    # the last: w == 0
    after = longest(latch, tail)
    return dict(prologue=head, loop=tail - head + 1,
                exits=[longest(head, e) + after for e in exits],
                full=longest(head, tail))


def stage_costs(torch, cfg, paths, device):
    """(lane, warp) instruction counts of the general sweep on chip_smoke's
    tilt case at ``cfg``, given ``paths``."""
    import chip_smoke as cs
    from warpsense_tpu_torch.map.local_map import create_state
    from warpsense_tpu_torch.ops.tsdf_projective import (GENERAL_STAGES,
                                                         general_rejects)
    case = next(c for c in cs.fusion_cases(torch) if c["name"] == "tilt")
    state = create_state(cfg["size"], cfg["tau"], 0, device=device,
                         force_odd=False)
    pts, mask = cs.room_points(torch, cfg, device)
    _, (rng_tab, _, _, cx, cy, cz) = cs.case_inputs(torch, cfg, state, case,
                                                    pts, mask)
    del state
    stage = general_rejects(cx, cy, cz, rng_tab, case["R"], tau=cfg["tau"],
                            resolution=cfg["res"], channels=cfg["channels"],
                            columns=cfg["columns"],
                            vfov_deg=cfg["vfov_deg"]).to(torch.int64)
    exits, n = paths["exits"], len(GENERAL_STAGES)
    if len(exits) not in (1, n):
        raise ValueError(f"{len(exits)} early-outs for {n} stages")
    by_stage = [paths["full"]] + (exits * n if len(exits) == 1 else exits)
    cost = torch.tensor(by_stage, device=device)[stage]
    X, Y, Z = stage.shape
    it = (Z + 31) // 32
    padded = torch.zeros((X, Y, it * 32), dtype=torch.int64, device=device)
    padded[..., :Z] = cost
    warp = padded.reshape(X, Y, it, 32).amax(dim=3)
    once = paths["prologue"] * X * Y
    return dict(voxels=X * Y * Z, lane=int(cost.sum()) / 32 + once,
                warp=int(warp.sum()) + once)


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    if argv[1] == "--fields":
        for k, root in enumerate(argv[2:]):
            sass = disassemble(Path(root), f"fields{k}", "fields.cu")
            print(json.dumps(dict(root=root, **fields_counts(sass))),
                  flush=True)
        return 0
    import torch
    import chip_smoke as cs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    name, limit, mhz = [s.strip() for s in smi.stdout.splitlines()[0]
                        .split(",")]
    print(f"{name}, {limit} W", flush=True)
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * 4 * float(mhz) * 1e6          # warp instructions a second
    cfgs = {"full": cs.FULL, "default": cs.default_fusion_cfg()}
    for k, root in enumerate(argv[1:]):
        code = function_sass(disassemble(Path(root), f"root{k}"),
                             "general_kernel")
        paths = loop_paths(code)
        out = dict(root=root, sms=sms, max_sm_mhz=float(mhz), **paths)
        for label, cfg in cfgs.items():
            c = stage_costs(torch, cfg, paths, device)
            out[label] = dict(
                lane_per_voxel=c["lane"] * 32 / c["voxels"],
                warp_per_voxel=c["warp"] * 32 / c["voxels"],
                lane_floor_ms=c["lane"] / rate * 1e3,
                issue_floor_ms=c["warp"] / rate * 1e3)
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
