#!/usr/bin/env python3
"""Smoke test of warpsense_tpu_torch on one CUDA GPU (an H100 for sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; nothing falls back to the CPU):
1. record the card and the toolchain;
2. build the CUDA kernels from warpsense_tpu_torch/csrc with nvcc;
3. fusion kernel K1 against its plain PyTorch version at the full
   625 x 625 x 235 window with a 128 x 1024 scanner: two level fusions,
   one at a 4 degree tilt, a level fusion whose cloud leaves most columns
   without a hit, and one on a window whose ring offset is nonzero on all
   three axes (a window after a shift); 0 value/weight mismatches
   required; then the same cases at configs/default.yaml's shapes
   (625 x 625 x 391, tau 1000 mm, its max_weight), which the parity and
   featsense apps run;
4. fields kernel K2 (packed and exact) against its plain version on the
   fused map and on seeded windows of full-range values with weight on
   every face (so every wrap path runs) at 625 x 625 x 235 and at the
   default 625 x 625 x 391, each at tau 600 and 1000; 0 mismatches
   required;
5. kernel and plain times (CUDA events around one call, median of 7; K2
   also per launch in runs of K2_LAUNCHES back-to-back launches), K1
   level and tilt (the general sweep) and K2 at 625 x 625 x 235, K1 level
   and tilt at the default shapes, each beside its bound: the least time
   an H100 SXM could take for the same work
   (bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s, whichever is
   longer; K1's bytes and operations counted from this run's inputs, the
   tilt's also under the count without its early-outs; K1 also beside the
   floor of its design's own traffic, sweep_floor_ms; K2 also beside a
   device-to-device copy of as many bytes, copy_ms);
6. WarpsenseApp(device="cuda") in fast mode at the application config:
   10 synthetic scans with one or more map shifts, then terminate();
   finite poses, ATE below ATE_BOUND_M, both kernels launched;
7. torch.profiler over 4 more app scans: device busy share and top
   kernels (trace in chiprun_out/app_trace.json);
7b. the tilted walk (TILT_APP): the same app on 18 scans that pitch and
   roll past the 2 degree budget from the seventh on, so fusion bins with
   the sensor attitude; finite poses, a map shift, ATE below twice the
   JAX app's on these scans, K1's general sweep launched on at least
   TILT_APP["min_general_scans"] scans;
8. WarpsenseApp(device="cuda") in parity mode at configs/default.yaml
   (625 x 625 x 391): the same 10 scans, update_distance 0, a shift check
   every scan; each scan's position within PARITY_POSE_BOUND_MM of the
   JAX app's on the CPU and its window where JAX's was (the window moves
   six times), ATE below PARITY_ATE_BOUND_M, K1 launched;
9. ray-march fusion: one fuse_cloud(fusion="raymarch") on CUDA and on CPU
   tensors at a 161 x 161 x 61 window (0 value/weight mismatches), then
   its time at the default window;
10. FeatsenseApp(device="cuda", fusion="auto") at configs/default.yaml on
   10 scans with translation and yaw, twice: finite poses, every pose of
   the second run equal to the first's bit for bit, final-pose error below
   FEATSENSE_BOUND_M, K1 launched; then 3 scans with fusion="raymarch".

Every phase prints its seconds.  Each path's kernel launches are counted
from 0 just before it runs; K1's also by sweep (general_launches_by_path:
the calls that ran the general sweep).

The last three lines are one JSON object describing the kernels, the
card's name and power limit as nvidia-smi prints them, and
{"ok": true, "device": {...}}.  Exits non-zero without printing a result
when no CUDA device is available or the package is missing.
"""
from __future__ import annotations

import faulthandler
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FULL = dict(size=(625, 625, 235), tau=600, res=64, n=32766,
            channels=128, columns=1024, vfov_deg=45.0, max_weight=32 * 64)
# ATE (translation RMSE, no alignment) of the 10-scan walk.  The JAX app on
# the same scans (CPU) reaches the value recorded in CHANGES.md; the bound
# leaves room for float-order differences in registration.
ATE_BOUND_M = 0.02
APP = dict(size=(625, 625, 235), res=64, scans=10, warmup=2,
           channels=128, columns=1024, capacity=32766, step_m=0.1,
           shift_m=0.35, noise=0.002, ate_bound_m=ATE_BOUND_M)
# the tilted walk: APP's settings on 18 scans of io/synthetic
# .rich_trajectory (0.08 m steps, 0.05 rad of yaw a scan, +-8 deg of pitch
# from scan 6 and +-5 deg of roll from scan 12), so scans 6-17 tilt past
# the 2 degree budget and fuse through K1's general sweep.  Fast mode fuses
# a scan only when the pose moved since the last fusion or the window
# shifted, which comes to every other scan on this walk: 12 tilted scans
# give at least 6 general fusions.  The JAX fast app on the CPU, fusion
# pinned to "projective-level", at a 321 x 221 x 111 window that holds the
# room, reaches TILT_JAX_ATE_M on these scans
# (tests/_jax_tilt_reference.py); the bound is twice that.
TILT_JAX_ATE_M = 0.00935352837387806
TILT_APP = dict(APP, scans=18, step_m=0.08, yaw_rate=0.05, pitch_deg=8.0,
                roll_deg=5.0, ate_bound_m=2 * TILT_JAX_ATE_M,
                min_general_scans=6)
TILT_DEG = 4.0
REPS = 7
# the K1 ring-offset case moves the window's ring by these voxels per axis
RING_SHIFT = (211, 97, 58)
# H100 SXM peaks (NVIDIA data sheet) against which bound_ms is counted
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations of K1 (csrc/fusion.cu), counted from its source: each
# arithmetic op, sqrt, division or reciprocal, comparison, min/max,
# rint/floor/trunc and int<->float conversion counts one.  Per beam
# (prepare_kernel): 3 subtractions and the running maximum of finite
# ranges.  Level sweep: per (x, y) column its terms (rho2, atan2_poly,
# inv_rho, colf, col, col_res) and m + tau; per voxel inside the cull's run
# its acceptance tests (r_vox, ring, v_res, h_res, the range test).
# General sweep: per (x, y) column its halves of the rotation (6 products,
# 3 sums); per z its products with the rotation's last row; per azimuth
# column of the table the maximum; per voxel the tests of each stage it
# reaches, in general_rejects' order (fusion_work's left_at): range (the
# rotation's 3 sums, rho2, r_vox, the comparison: 10), ring (sqrt, max,
# reciprocal, banded_atan, ringf and its clip, rint, conversion, 2
# comparisons: 26), vertical (delta_z, v_res, max, comparison: 9),
# horizontal (atan2_poly, colf, col_res, h_res, comparison: 34) and beam
# (conversion, isfinite, range + tau, comparison: 4).  Per voxel that
# passes the tests, its value and weight.  These count the work of this
# implementation on this run's data (the voxels its culls and early-outs
# leave), not the least work the function could need, so a share of the
# bound is an upper estimate.  The cull's searches are the kernel's own
# overhead and are not counted.
K1_OPS_PER_BEAM = 5
K1_OPS_PER_COLUMN_LEVEL = 39
K1_OPS_PER_VOXEL_LEVEL = 39
K1_OPS_PER_COLUMN_GENERAL = 9
K1_OPS_PER_Z_GENERAL = 3
K1_OPS_PER_VOXEL_GENERAL_STAGES = (10, 26, 9, 34, 4)
K1_OPS_PER_FUSED_VOXEL = 21
# For comparison, the general sweep's count without early-outs or the
# hoisted rotation: every voxel within range of the table (ranged_voxels)
# rotates and runs all its tests, every other voxel rotates and takes its
# length (the bound's count before the early-outs)
K1_OPS_GENERAL_NO_EARLY_OUT = (92, 22)
# parity mode at the shipped default config, on APP's scans.  Cut: 10
# scans, update_distance 0 (fuse every scan), shift 0 (the window-shift
# check runs every scan: the reference's GN creeps ~1.5 mm a scan here, so
# a 0.35 m gate would never fire; at 0 the window follows the pose across
# voxel edges).  The JAX parity app on the CPU, at a 361 x 261 x 131
# window that holds the room, reaches these positions (mm) and windows;
# the port on the CPU is within 2e-6 mm of them.  The pose bound is the
# repo's registration tolerance, far below the 14.3 mm the reference
# moves by the last scan; the ATE bound is twice JAX's ATE.
PARITY = dict(APP, capacity=32768, shift_m=0.0)
PARITY_JAX_MM = [
    [-0.3352, -0.0035, 0.0472], [0.6422, -0.0255, 0.2934],
    [1.6379, -0.2885, 0.0572], [3.0878, -0.2296, -0.0691],
    [4.4202, -0.1418, 0.0201], [6.0252, 0.0099, 0.0484],
    [7.6392, 0.5802, 0.1938], [9.511, 1.1782, 0.1936],
    [11.5487, 1.9807, 0.3165], [14.3411, 3.0451, 0.2407]]
PARITY_JAX_WINDOW = [[-1, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, -1],
                     [0, -1, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
                     [0, 0, 0], [0, 0, 0]]
PARITY_POSE_BOUND_MM = 0.5
PARITY_ATE_BOUND_M = 2 * 0.5253290603
# ray march: CUDA vs CPU at a window the CPU sweeps in seconds, then the
# time at the default window; 32,766 points on the walls of a room inside
# each window
RAYMARCH = dict(small=(161, 161, 61), n=32766)
# featsense at the default config: 10 scans of 128 x 1024 along 0.12 m
# steps with 0.02 rad of yaw a scan.  The JAX app on the CPU ends 0.10133 m
# from the truth on these scans (CHANGES.md); the bound is twice that.
FEATSENSE = dict(scans=10, warmup=2, raymarch_scans=3, step_m=0.12,
                 noise=0.003, channels=128, columns=1024)
FEATSENSE_BOUND_M = 2 * 0.10133
DEFAULT_YAML = ROOT / "warpsense_tpu_torch" / "configs" / "default.yaml"
# K2's seeded windows: full-range int16 values, weights nonzero with this
# probability (on every face too), checked at these taus
FIELDS_SEED = 7
FIELDS_WEIGHT_SHARE = 0.7
FIELDS_TAUS = (600, 1000)
# K2 is also timed per launch over runs of this many back-to-back launches
K2_LAUNCHES = 10


def log(*a) -> None:
    print(*a, flush=True)


# ----------------------------------------------------------------- phase 1
def _imports(name: str) -> bool:
    """Whether ``import name`` works here (recorded, not relied on)."""
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def record_card(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    from warpsense_tpu_torch.kernels import _build
    nvcc = _build.find_nvcc()
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    info = {
        "nvidia_smi": smi[0],
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc, "nvcc_version": nvcc_v.splitlines()[-1],
        "python": sys.version.split()[0],
        "triton": _imports("triton"),
        "h5py": _imports("h5py"),
    }
    log("[card]", json.dumps(info))
    return info


# ----------------------------------------------------------------- phase 2
def build_kernels() -> dict:
    from warpsense_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    for name in ("fusion", "fields"):
        _build.load(name)
    secs = time.perf_counter() - t0
    log(f"[build] {secs:.2f} s total; per source:",
        json.dumps(_build.build_seconds))
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[ptxas {name}] {line.strip()}")
    return dict(_build.build_seconds, total=secs)


# ----------------------------------------------------------------- phase 3
def tilt_rotation(torch, deg: float):
    a = math.radians(deg)
    return torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                         [-math.sin(a), 0.0, math.cos(a)]],
                        dtype=torch.float32)


def fusion_cases(torch):
    """The K1 checks, in order: name, scanner voxel, grid rotation, level
    or not, ``ring`` (move the window's ring by RING_SHIFT) and ``cloud``
    ("room", or "wedge": a 60 degree wedge of it, so that most azimuth
    columns see no return)."""
    eye = torch.eye(3, dtype=torch.float32)
    case = dict(scanner=(0, 0, 0), R=eye, level=True, ring=False,
                cloud="room")
    return [dict(case, name="level"),
            dict(case, name="level_moved", scanner=(1, 1, 0)),
            dict(case, name="tilt", R=tilt_rotation(torch, TILT_DEG),
                 level=False),
            dict(case, name="level_wedge", scanner=(-2, 1, 0),
                 cloud="wedge"),
            dict(case, name="level_ring_offset", scanner=(3, -2, 1),
                 ring=True)]


def case_inputs(torch, cfg, state, case, pts, mask):
    """(state, fusion_inputs) of one K1 case: the state is ``state`` or, for
    a ring case, a view of its planes with the ring moved."""
    from warpsense_tpu_torch.ops.tsdf_projective import fusion_inputs
    device = state.value.device
    if case["ring"]:
        size = cfg["size"]
        state = state._replace(
            pos=torch.tensor(case["scanner"], dtype=torch.int32,
                             device=device),
            offset=torch.tensor([(s // 2 + d) % s for s, d in
                                 zip(size, RING_SHIFT)], dtype=torch.int32,
                                device=device))
    if case["cloud"] == "wedge":
        mask = mask & (pts[:, 0] > 0) & (pts[:, 1].abs() * 100
                                         < 58 * pts[:, 0])
    spos = torch.tensor(case["scanner"], dtype=torch.int32, device=device)
    return state, fusion_inputs(
        state, pts, mask, spos, case["R"], size=cfg["size"],
        tau=cfg["tau"], resolution=cfg["res"], channels=cfg["channels"],
        columns=cfg["columns"], vfov_deg=cfg["vfov_deg"])


def room_points(torch, cfg, device):
    from warpsense_tpu_torch.io.synthetic import box_room_cloud
    X, Y, Z = cfg["size"]
    half = min(X, Y) * cfg["res"] * 45 // 100
    zhalf = Z * cfg["res"] * 40 // 100
    pts = torch.as_tensor(box_room_cloud(cfg["n"], half, zhalf),
                          device=device)
    return pts, torch.ones(pts.shape[0], dtype=torch.bool, device=device)


def check_fusion(torch, cfg, device):
    """K1 vs plain on identical inputs (one beam table per fusion, fed to
    both).  Returns (kernel state, per-case report)."""
    from warpsense_tpu_torch.kernels.fusion import fusion_sweep_merge
    from warpsense_tpu_torch.map.local_map import clone_state, create_state
    from warpsense_tpu_torch.ops.tsdf_projective import sweep_merge_plain
    kw = dict(tau=cfg["tau"], resolution=cfg["res"],
              channels=cfg["channels"], columns=cfg["columns"],
              vfov_deg=cfg["vfov_deg"])
    mw = cfg["max_weight"]
    pts, mask = room_points(torch, cfg, device)
    st_k = create_state(cfg["size"], cfg["tau"], 0, device=device,
                        force_odd=False)
    st_p = clone_state(st_k)
    report = []
    for c in fusion_cases(torch):
        sk, (rng_tab, endpoint, smm, cx, cy, cz) = case_inputs(
            torch, cfg, st_k, c, pts, mask)
        fusion_sweep_merge(sk.value, sk.weight, cx, cy, cz, rng_tab,
                           endpoint, smm, c["R"], max_weight=mw,
                           level=c["level"], **kw)
        sweep_merge_plain(st_p.value, st_p.weight, cx, cy, cz, rng_tab,
                          endpoint, smm, c["R"], max_weight=mw, **kw)
        dv = int((st_k.value != st_p.value).sum())
        dw = int((st_k.weight != st_p.weight).sum())
        err = int((st_k.value.int() - st_p.value.int()).abs().max()) + int(
            (st_k.weight.int() - st_p.weight.int()).abs().max())
        fused = int((st_k.weight != 0).sum())
        case = dict(name=c["name"], size=list(cfg["size"]), tau=cfg["tau"],
                    scanner=list(c["scanner"]), level=c["level"],
                    z_rotation=int(torch.argmin(cz)), value_mismatch=dv,
                    weight_mismatch=dw, max_abs_err=err, fused_voxels=fused)
        log("[K1]", json.dumps(case))
        report.append(case)
        if dv or dw:
            raise AssertionError(f"K1 disagrees with its plain version: {case}")
        if c["ring"] and case["z_rotation"] == 0:
            raise AssertionError("the ring case did not rotate z")
    if report[0]["fused_voxels"] == 0:
        raise AssertionError("K1 fused nothing")
    return st_k, report


def default_fusion_cfg() -> dict:
    """check_fusion's inputs at configs/default.yaml: the window the
    parity and featsense apps allocate (extents forced odd), its tau and
    max_weight, and its scanner."""
    params = default_params()
    m, lidar = params.map, params.lidar
    return dict(size=tuple(s | 1 for s in m.size_voxels), tau=m.tau,
                res=m.resolution, n=FULL["n"], channels=lidar.channels,
                columns=lidar.hresolution, vfov_deg=lidar.vfov,
                max_weight=m.max_weight_scaled)


# ----------------------------------------------------------------- phase 4
def face_weight_shares(state) -> list:
    """Share of nonzero weights on each of the window's six faces (x=0,
    x=X-1, y=0, y=Y-1, z=0, z=Z-1): where K2's wrap paths read weight."""
    w = state.weight
    faces = (w[0], w[-1], w[:, 0], w[:, -1], w[:, :, 0], w[:, :, -1])
    return [float((f != 0).float().mean()) for f in faces]


def seeded_fields_state(torch, size, device, seed=FIELDS_SEED):
    """A window of full-range int16 values (-32768 and 32767 at two corners
    each, uniform elsewhere) and weights in [1, 32767], zero with
    probability 1 - FIELDS_WEIGHT_SHARE, made from a numpy seed."""
    import numpy as np

    from warpsense_tpu_torch.map.local_map import create_state
    rng = np.random.default_rng(seed)
    v = rng.integers(-32768, 32768, size, dtype=np.int16)
    v[0, 0, 0] = v[-1, -1, -1] = -32768
    v[0, -1, 0] = v[-1, 0, -1] = 32767
    w = rng.integers(1, 32768, size, dtype=np.int16)
    w[rng.random(size, dtype=np.float32) >= FIELDS_WEIGHT_SHARE] = 0
    state = create_state(size, 0, 0, device=device, force_odd=False)
    state.value.copy_(torch.from_numpy(v))
    state.weight.copy_(torch.from_numpy(w))
    return state


def check_fields(torch, state, tau, name):
    """K2 in both modes against its plain versions on ``state``: 0
    mismatching int32 words required."""
    from warpsense_tpu_torch.kernels.fields import fields_packed
    from warpsense_tpu_torch.ops.registration import (
        precompute_fields_packed, precompute_fields_packed2)
    report = dict(name=name, size=list(state.value.shape), tau=tau,
                  face_weight_share=face_weight_shares(state))
    k = fields_packed(state, tau=tau)
    p = precompute_fields_packed(state, tau=tau)
    report["packed_mismatch"] = int((k.plane != p.plane).sum())
    k2 = fields_packed(state, tau=tau, exact=True)
    p2 = precompute_fields_packed2(state)
    report["exact_mismatch"] = int((k2.plane_a != p2.plane_a).sum()
                                   + (k2.plane_b != p2.plane_b).sum())
    report["max_abs_err"] = max(
        int((k.plane.long() - p.plane.long()).abs().max()),
        int((k2.plane_a.long() - p2.plane_a.long()).abs().max()),
        int((k2.plane_b.long() - p2.plane_b.long()).abs().max()))
    report["valid_codes"] = int(((k.plane >> 24) & 0xFF).ne(0).sum())
    log("[K2]", json.dumps(report))
    if report["packed_mismatch"] or report["exact_mismatch"]:
        raise AssertionError(f"K2 disagrees with its plain version: {report}")
    if report["valid_codes"] == 0:
        raise AssertionError("K2 saw no weighted voxel")
    return report


def check_fields_all(torch, state, tau, device):
    """K2 on the fused map ``state``, then on seeded full-range windows at
    FULL and at the default shapes, each at tau 600 and 1000.  The seeded
    windows carry weight on every face, so every wrap path is exercised."""
    report = [check_fields(torch, state, tau, "fused")]
    for label, size in (("full", FULL["size"]),
                        ("default", default_fusion_cfg()["size"])):
        seeded = seeded_fields_state(torch, size, device)
        if min(face_weight_shares(seeded)) < FIELDS_WEIGHT_SHARE - 0.05:
            raise AssertionError("a seeded face lacks weight")
        for t in FIELDS_TAUS:
            report.append(check_fields(torch, seeded, t,
                                       f"seeded_{label}_tau{t}"))
        del seeded
        torch.cuda.empty_cache()
    return report


# ----------------------------------------------------------------- phase 5
def time_ms(torch, fn, setup=None, reps=REPS) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events);
    ``setup`` runs before each, outside the events."""
    if setup is not None:
        setup()
    fn()                                              # warm-up
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: int, ops: int, ms: float) -> dict:
    """The least time the card could take for work of ``nbytes`` bytes and
    ``ops`` float32 operations, what bounds it, and the share of it that
    a kernel taking ``ms`` reaches."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    b = max(bytes_ms, ops_ms)
    return dict(bytes=nbytes, ops=ops, bound_ms=b,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                share_of_bound=b / ms)


def fusion_cost(work: dict, *, channels: int, columns: int, X: int, Y: int,
                Z: int, level: bool) -> dict:
    """Bytes and float32 ops of one K1 call, from ``fusion_work``'s counts:
    ``bytes``, what the function must move (the int16 value and weight of
    each fused voxel read and written, the float4 beam table and the three
    coordinate vectors read once), ``ops`` (K1_OPS_*), and ``sweep_bytes``,
    what this design moves: the level sweep loads the value and weight of
    every voxel it sweeps, the general sweep those of the voxels that pass
    its beam-free tests.  For the general sweep also ``ops_no_early_out``,
    the count without early-outs (K1_OPS_GENERAL_NO_EARLY_OUT)."""
    table = 16 * channels * columns + 4 * (X + Y + Z)
    fused = work["fused_voxels"]
    base = K1_OPS_PER_BEAM * channels * columns \
        + K1_OPS_PER_FUSED_VOXEL * fused
    out = dict(bytes=8 * fused + table)
    if level:
        out.update(ops=base + K1_OPS_PER_COLUMN_LEVEL * work["columns"]
                   + K1_OPS_PER_VOXEL_LEVEL * work["swept_voxels"],
                   sweep_bytes=4 * (work["swept_voxels"] + fused) + table)
        return out
    reach, ops = work["voxels"], base \
        + K1_OPS_PER_COLUMN_GENERAL * work["columns"] \
        + K1_OPS_PER_Z_GENERAL * Z + columns
    for stage, per_voxel in zip(list(work["left_at"])[1:],
                                K1_OPS_PER_VOXEL_GENERAL_STAGES):
        ops += per_voxel * reach             # the voxels reaching the stage
        loaded = reach                       # the beam stage's: map loaded
        reach -= work["left_at"][stage]
    full, out_of_range = K1_OPS_GENERAL_NO_EARLY_OUT
    out.update(ops=ops, sweep_bytes=4 * (loaded + fused) + table,
               ops_no_early_out=base + full * work["ranged_voxels"]
               + out_of_range * (work["voxels"] - work["ranged_voxels"]))
    return out


def time_fusion(torch, cfg, state, names, bounds=True):
    """K1 times of the named fusion cases on ``state`` (each run starts from
    a copy of it, made outside the timed region); with ``bounds``, also the
    plain times and each case's bound, counted from its inputs."""
    from warpsense_tpu_torch.kernels.fusion import fusion_sweep_merge
    device = state.value.device
    kw = dict(tau=cfg["tau"], resolution=cfg["res"],
              channels=cfg["channels"], columns=cfg["columns"],
              vfov_deg=cfg["vfov_deg"])
    mw = cfg["max_weight"]
    pts, mask = room_points(torch, cfg, device)
    work = [state.value.clone(), state.weight.clone()]

    def reset():
        work[0].copy_(state.value)
        work[1].copy_(state.weight)

    out = {}
    for c in fusion_cases(torch):
        if c["name"] not in names:
            continue
        _, inputs = case_inputs(torch, cfg, state, c, pts, mask)
        rng_tab, endpoint, smm, cx, cy, cz = inputs
        args = (cx, cy, cz, rng_tab, endpoint, smm, c["R"])
        level = c["level"]
        k_ms = time_ms(torch, lambda: fusion_sweep_merge(
            work[0], work[1], *args, max_weight=mw, level=level, **kw),
            setup=reset)
        out[c["name"]] = dict(size=list(cfg["size"]), tau=cfg["tau"],
                              ms=k_ms)
        if bounds:
            from warpsense_tpu_torch.ops.tsdf_projective import (
                fusion_work, sweep_merge_plain)
            p_ms = time_ms(torch, lambda: sweep_merge_plain(
                work[0], work[1], *args, max_weight=mw, **kw), setup=reset,
                reps=5)
            counts = fusion_work(*args, level=level, **kw)
            X, Y, Z = cfg["size"]
            cost = fusion_cost(counts, channels=cfg["channels"],
                               columns=cfg["columns"], X=X, Y=Y, Z=Z,
                               level=level)
            # the floor of this design's own traffic, beside the bound
            sweep_ms = max(cost["sweep_bytes"] / HBM_BYTES_PER_S,
                           cost["ops"] / F32_OPS_PER_S) * 1e3
            out[c["name"]].update(
                plain_ms=p_ms, library_ms=None,
                **bound(cost["bytes"], cost["ops"], k_ms),
                sweep_bytes=cost["sweep_bytes"], sweep_floor_ms=sweep_ms,
                work=counts)
            if "ops_no_early_out" in cost:
                # the bound under the count without early-outs, beside it
                out[c["name"]]["bound_ms_no_early_out"] = bound(
                    cost["bytes"], cost["ops_no_early_out"], k_ms)["bound_ms"]
        log(f"[time K1 {c['name']}]", json.dumps(out[c["name"]]))
    return out


def time_per_launch(torch, fn, launches=K2_LAUNCHES) -> float:
    """``time_ms`` of ``launches`` back-to-back calls of ``fn``, per call:
    the host's work for the next call overlaps the device's for this one,
    so a short kernel is timed without the host's gap before it."""
    def run():
        for _ in range(launches):
            fn()
    return time_ms(torch, run) / launches


def time_fields(torch, cfg, state):
    """K2 times on ``state``, each beside its bound: the int16 value and
    weight planes read once and one int32 plane written (two in exact
    mode).  Its work is integer work, far below the float32 rate, so bytes
    bound it.  ``ms`` is one wrapper call between two events, as K1's, so
    it holds the host's work before the launch; ``per_launch_ms`` is the
    same call in runs of back-to-back calls (``time_per_launch``), without
    that gap.  Beside them ``copy_ms``: a device-to-device ``copy_`` that
    moves as many bytes (half of them read, half written), timed per
    launch, the rate the card reaches in practice, and ``share_of_copy`` =
    copy_ms / per_launch_ms."""
    from warpsense_tpu_torch.kernels.fields import fields_packed
    nvox = state.value.numel()
    out = {}
    for exact in (False, True):
        def call():
            fields_packed(state, tau=cfg["tau"], exact=exact)
        k_ms = time_ms(torch, call)
        pl_ms = time_per_launch(torch, call)
        moved = (12 if exact else 8) * nvox
        src = torch.empty(moved // 2, dtype=torch.uint8,
                          device=state.value.device)
        dst = torch.empty_like(src)
        c_ms = time_per_launch(torch, lambda: dst.copy_(src))
        del src, dst
        out["exact" if exact else "packed"] = dict(
            size=list(state.value.shape), ms=k_ms, library_ms=None,
            **bound(moved, 0, k_ms), per_launch_ms=pl_ms, copy_ms=c_ms,
            share_of_copy=c_ms / pl_ms)
    return out


def time_fields_plain(torch, cfg, state, times):
    """The plain versions' times into ``times`` (``time_fields``'s), taken
    after all the kernel times: the plain versions' heavy traffic slows a
    kernel timed right after them."""
    from warpsense_tpu_torch.ops.registration import (
        precompute_fields_packed, precompute_fields_packed2)
    times["packed"]["plain_ms"] = time_ms(
        torch, lambda: precompute_fields_packed(state, tau=cfg["tau"]),
        reps=5)
    times["exact"]["plain_ms"] = time_ms(
        torch, lambda: precompute_fields_packed2(state), reps=5)
    for name, t in times.items():
        log(f"[time K2 {name}]", json.dumps(t))
    return times


# ----------------------------------------------------------------- phase 6
def app_config(cfg) -> dict:
    """The fast-mode app's configuration as a dict (``Params.from_dict``)."""
    return {
        "map": {"max_distance": 0.6, "resolution": cfg["res"],
                "max_weight": 32, "shift": cfg["shift_m"],
                "update_distance": 0.0},
        "registration": {"max_iterations": 50, "epsilon": 0.03,
                         "it_weight_gradient": 0.1, "mode": "fast"},
        "lidar": {"channels": cfg["channels"],
                  "hresolution": cfg["columns"]},
    }


def app_params(cfg):
    from warpsense_tpu_torch.core.config import Params
    return Params.from_dict(app_config(cfg))


def app_scans(cfg):
    """(ground truth, scans): the walk, or with ``pitch_deg`` in ``cfg`` the
    tilted walk of ``rich_trajectory``."""
    import numpy as np

    from warpsense_tpu_torch.io.synthetic import (BoxWorld, render_scan,
                                                  rich_trajectory,
                                                  walk_trajectory)
    world = BoxWorld.default()
    rng = np.random.default_rng(4)
    if "pitch_deg" in cfg:
        gt = rich_trajectory(cfg["scans"], step_m=cfg["step_m"],
                             yaw_rate=cfg["yaw_rate"],
                             pitch_deg=cfg["pitch_deg"],
                             roll_deg=cfg["roll_deg"])
    else:
        gt = walk_trajectory(cfg["scans"], step_m=cfg["step_m"])
    scans = [render_scan(world, p, channels=cfg["channels"],
                         columns=cfg["columns"], noise_std=cfg["noise"],
                         rng=rng) for p in gt]
    return gt, scans


def ate_m(poses_mm, gt) -> float:
    """Translation RMSE (m) of the app poses (mm, first-scan frame)
    against ground truth expressed in the first sensor frame."""
    import numpy as np
    inv0 = np.linalg.inv(gt[0])
    err = [np.asarray(p, np.float64)[:3, 3] / 1000.0 - (inv0 @ g)[:3, 3]
           for p, g in zip(poses_mm, gt)]
    return float(np.sqrt(np.mean(np.sum(np.square(err), axis=1))))


def run_app(torch, cfg, device):
    """Drive WarpsenseApp through its callbacks (global map in memory);
    returns the report."""
    import numpy as np

    from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator
    from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp

    gt, scans = app_scans(cfg)
    app = WarpsenseApp(app_params(cfg), in_memory_map=True,
                       capacity=cfg["capacity"], window_size=cfg["size"],
                       force_odd=False, fusion="auto", sync_shift=True,
                       device=device, profile=True)
    ev = RuntimeEvaluator.get_instance()
    ev.clear()
    pos0 = app.state.pos.cpu().numpy().copy()
    poses, iters = [], []
    reset_launches()
    t_start = None
    for i, scan in enumerate(scans):
        if i == cfg["warmup"]:
            if device.type == "cuda":
                torch.cuda.synchronize()
            t_start = time.perf_counter()
        poses.append(app.cloud_callback(scan, 0.1 * i))
        iters.append(app.last_reg_iters)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    shifted = app.state.pos.cpu().numpy().copy()
    t0 = time.perf_counter()
    app.terminate()
    term_s = time.perf_counter() - t0
    launches = read_launches()
    stages = {r["task"]: r["avg"] / 1000.0 for r in ev.to_rows()}
    rep = dict(scans=len(scans), timed_scans=len(scans) - cfg["warmup"],
               scans_per_s=(len(scans) - cfg["warmup"]) / wall,
               stage_avg_ms=stages, terminate_s=term_s,
               lm_iterations=iters, window_pos_start=pos0.tolist(),
               window_pos_end=shifted.tolist(),
               ate_m=ate_m(poses, gt), launches=launches,
               finite=bool(np.all(np.isfinite(np.stack(poses)))))
    if "pitch_deg" in cfg:
        from warpsense_tpu_torch.pipeline.fusion_backend import \
            sensor_tilt_deg
        rep["tilt_deg"] = [sensor_tilt_deg(p) for p in poses]
    log("[app]", json.dumps(rep))
    if not rep["finite"]:
        raise AssertionError("non-finite pose")
    if np.array_equal(pos0, shifted):
        raise AssertionError("no map shift ran")
    if not rep["ate_m"] < cfg["ate_bound_m"]:
        raise AssertionError(f"ATE {rep['ate_m']:.4f} m >= "
                             f"{cfg['ate_bound_m']} m")
    if device.type == "cuda" and min(launches["fusion"],
                                     launches["fields"]) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if launches["fusion_general"] < cfg.get("min_general_scans", 0):
        raise AssertionError(f"K1's general sweep ran on fewer than "
                             f"{cfg['min_general_scans']} scans: {launches}")
    return rep


def profile_app(torch, cfg, device, scans=4):
    """torch.profiler over ``scans`` app scans after a warm-up: device busy
    share (sum of kernel times over wall time) and the top kernels.  The
    chrome trace goes to chiprun_out/app_trace.json."""
    from torch.profiler import ProfilerActivity, profile

    from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp
    gt, all_scans = app_scans(dict(cfg, scans=cfg["warmup"] + scans))
    app = WarpsenseApp(app_params(cfg), in_memory_map=True,
                       capacity=cfg["capacity"], window_size=cfg["size"],
                       force_odd=False, fusion="auto", sync_shift=True,
                       device=device)
    for i, scan in enumerate(all_scans[:cfg["warmup"]]):
        app.cloud_callback(scan, 0.1 * i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, scan in enumerate(all_scans[cfg["warmup"]:]):
            app.cloud_callback(scan, 0.1 * (cfg["warmup"] + i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    app.terminate()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    out = dict(scans=scans, wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
               device_busy_share=busy_us / 1e6 / wall,
               top=[dict(name=k[:80], ms=t / 1e3, count=c)
                    for k, t, c in rows[:12]])
    log("[profile]", json.dumps(out))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "app_trace.json"))
    return out


# ----------------------------------------------------------------- phase 8
def default_params(**map_overrides):
    from warpsense_tpu_torch.core.config import Params
    params = Params.from_yaml(DEFAULT_YAML)
    for k, v in map_overrides.items():
        setattr(params.map, k, v)
    return params


def reset_launches() -> None:
    from warpsense_tpu_torch.kernels.fields import fields_packed
    from warpsense_tpu_torch.kernels.fusion import fusion_sweep_merge
    fusion_sweep_merge.launches = 0
    fusion_sweep_merge.general_launches = 0
    fields_packed.launches = 0


def read_launches() -> dict:
    """K1's launches ("fusion", of which "fusion_general" ran the general
    sweep) and K2's ("fields")."""
    from warpsense_tpu_torch.kernels.fields import fields_packed
    from warpsense_tpu_torch.kernels.fusion import fusion_sweep_merge
    return {"fusion": fusion_sweep_merge.launches,
            "fusion_general": fusion_sweep_merge.general_launches,
            "fields": fields_packed.launches}


def run_parity_app(torch, cfg, device):
    """WarpsenseApp in parity mode (the default config) through its
    callbacks; returns the report."""
    import numpy as np

    from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator
    from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp
    params = default_params(update_distance=0.0, shift=cfg["shift_m"])
    if params.registration.mode != "parity":
        raise AssertionError("configs/default.yaml is not in parity mode")
    gt, scans = app_scans(cfg)
    app = WarpsenseApp(params, in_memory_map=True, capacity=cfg["capacity"],
                       fusion="auto", device=device, profile=True)
    ev = RuntimeEvaluator.get_instance()
    ev.clear()
    poses, windows = [], []
    reset_launches()
    for i, scan in enumerate(scans):
        if i == cfg["warmup"]:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        poses.append(app.cloud_callback(scan, 0.1 * i))
        windows.append(app.state.pos.cpu().tolist())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = read_launches()
    pose_err = [float(np.abs(p[:3, 3] - np.asarray(j)).max())
                for p, j in zip(poses, PARITY_JAX_MM)]
    rep = dict(window=list(app.local_map.size), scans=len(scans),
               scans_per_s=(len(scans) - cfg["warmup"]) / wall,
               stage_avg_ms={r["task"]: r["avg"] / 1000.0
                             for r in ev.to_rows()},
               stage_count={r["task"]: r["count"] for r in ev.to_rows()},
               window_pos=windows, pose_err_vs_jax_mm=pose_err,
               ate_m=ate_m(poses, gt), launches=launches,
               finite=bool(np.all(np.isfinite(np.stack(poses)))))
    app.terminate()
    log("[parity_app]", json.dumps(rep))
    if not rep["finite"]:
        raise AssertionError("non-finite parity pose")
    if not max(pose_err) < PARITY_POSE_BOUND_MM:
        raise AssertionError(f"parity poses {max(pose_err):.4f} mm from "
                             f"JAX's >= {PARITY_POSE_BOUND_MM} mm")
    if windows != PARITY_JAX_WINDOW:
        raise AssertionError(f"parity windows {windows} != JAX's "
                             f"{PARITY_JAX_WINDOW}")
    if not rep["ate_m"] < PARITY_ATE_BOUND_M:
        raise AssertionError(f"parity ATE {rep['ate_m']:.4f} m >= "
                             f"{PARITY_ATE_BOUND_M} m")
    if launches["fusion"] == 0:
        raise AssertionError(f"K1 was not launched: {launches}")
    return rep


# ----------------------------------------------------------------- phase 9
def raymarch_inputs(torch, params, size, n, device):
    import math

    import numpy as np

    from warpsense_tpu_torch.map.local_map import create_state
    from warpsense_tpu_torch.ops.tsdf import plan_raymarch
    m = params.map
    pts, mask = room_points(torch, dict(size=size, res=m.resolution, n=n),
                            device)
    a = math.radians(3.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                    [-math.sin(a), 0, math.cos(a)]]
    pose[:3, 3] = [70.0, -40.0, 30.0]
    state = create_state(size, m.tau, 0, device=device, force_odd=False)
    steps = plan_raymarch(m.tau, m.resolution, 50000, params.lidar.channels,
                          params.lidar.vfov)
    return state, pts, mask, pose, steps


def check_raymarch(torch, device, card_name):
    """Ray march on CUDA tensors against the same call on CPU tensors (the
    same plain PyTorch code), then its time at the default window on the
    card ``card_name`` (nvidia-smi's name and power limit)."""
    from warpsense_tpu_torch.map.local_map import clone_state
    from warpsense_tpu_torch.pipeline.fusion_backend import fuse_cloud
    params = default_params()
    out = {}
    size = RAYMARCH["small"]
    st, pts, mask, pose, steps = raymarch_inputs(torch, params, size,
                                                 RAYMARCH["n"], device)
    kw = dict(params=params, size=size, fusion="raymarch",
              max_steps=steps[0], max_isteps=steps[1])
    st_cpu = clone_state(st)
    st_cpu = type(st)(*(t.cpu() for t in st_cpu))
    t0 = time.perf_counter()
    fuse_cloud(st, pts, mask, pose, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fuse_cloud(st_cpu, pts.cpu(), mask.cpu(), pose, **kw)
    t2 = time.perf_counter()
    dv = int((st.value.cpu() != st_cpu.value).sum())
    dw = int((st.weight.cpu() != st_cpu.weight).sum())
    out["small"] = dict(size=list(size), points=int(pts.shape[0]),
                        value_mismatch=dv, weight_mismatch=dw,
                        fused_voxels=int((st_cpu.weight != 0).sum()),
                        cuda_s=t1 - t0, cpu_s=t2 - t1)
    log("[raymarch]", json.dumps(out["small"]))
    if dv or dw:
        raise AssertionError(f"ray march CUDA != CPU: {out['small']}")
    if out["small"]["fused_voxels"] == 0:
        raise AssertionError("the ray march fused nothing")
    del st, st_cpu

    size = tuple(s | 1 for s in params.map.size_voxels)  # forced odd
    st, pts, mask, pose, steps = raymarch_inputs(torch, params, size,
                                                 RAYMARCH["n"], device)
    base = clone_state(st)
    kw.update(size=size, max_steps=steps[0], max_isteps=steps[1])

    def reset():
        st.value.copy_(base.value)
        st.weight.copy_(base.weight)
    ms = time_ms(torch, lambda: fuse_cloud(st, pts, mask, pose, **kw),
                 setup=reset, reps=5)
    out["default"] = dict(size=list(size), points=int(pts.shape[0]),
                          max_steps=steps[0], max_isteps=steps[1], ms=ms,
                          fused_voxels=int((st.weight != 0).sum()),
                          card=card_name)
    log("[raymarch]", json.dumps(out["default"]))
    return out


# ---------------------------------------------------------------- phase 10
def featsense_scans(cfg):
    import numpy as np

    from warpsense_tpu_torch.io.synthetic import BoxWorld, render_scan
    truth = np.zeros((cfg["scans"], 4, 4))
    for i in range(cfg["scans"]):
        c, s = np.cos(0.02 * i), np.sin(0.02 * i)
        truth[i] = np.eye(4)
        truth[i][:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        truth[i][:3, 3] = [cfg["step_m"] * i, 0.04 * i, 0.0]
    rng = np.random.default_rng(5)
    scans = [render_scan(BoxWorld.default(), p, channels=cfg["channels"],
                         columns=cfg["columns"], noise_std=cfg["noise"],
                         rng=rng) for p in truth]
    return truth, scans


def featsense_auto_run(torch, cfg, params, scans, device):
    """One FeatsenseApp run with fusion="auto" (K1) over ``scans``: (poses,
    the report's fields)."""
    from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator
    from warpsense_tpu_torch.pipeline.featsense import FeatsenseApp
    app = FeatsenseApp(params, fusion="auto", device=device,
                       in_memory_map=True, profile=True)
    ev = RuntimeEvaluator.get_instance()
    ev.clear()
    poses = []
    reset_launches()
    for i, scan in enumerate(scans):
        if i == cfg["warmup"]:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        poses.append(app.process_scan(scan, 0.1 * i))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    rep = dict(window=list(app.mapping.local_map.size), scans=len(scans),
               scans_per_s=(len(scans) - cfg["warmup"]) / wall,
               stage_avg_ms={r["task"]: r["avg"] / 1000.0
                             for r in ev.to_rows()},
               refined_poses=len(app.mapping.gicp_path),
               launches=read_launches())
    app.terminate()
    return poses, rep


def run_featsense_app(torch, cfg, device):
    """FeatsenseApp at the default config with fusion="auto" (K1), twice on
    the same scans (the card's runs must repeat every pose bit for bit),
    then a few scans with the default fusion="raymarch"."""
    import numpy as np

    from warpsense_tpu_torch.pipeline.featsense import FeatsenseApp
    truth, scans = featsense_scans(cfg)
    params = default_params()
    poses, rep = featsense_auto_run(torch, cfg, params, scans, device)
    again, rep2 = featsense_auto_run(torch, cfg, params, scans, device)
    launches = rep["launches"]
    rep.update(
        final_error_m=float(np.linalg.norm(poses[-1][:3, 3]
                                           - truth[-1][:3, 3])),
        finite=bool(np.all(np.isfinite(np.stack(poses)))),
        repeat=dict(scans_per_s=rep2["scans_per_s"],
                    identical_scans=sum(np.array_equal(a, b)
                                        for a, b in zip(poses, again)),
                    max_abs_diff=float(np.max(np.abs(np.stack(poses)
                                                     - np.stack(again))))))
    rm = FeatsenseApp(params, device=device, in_memory_map=True)
    if rm.mapping.fusion != "raymarch":
        raise AssertionError("featsense's default fusion is not raymarch")
    t0 = time.perf_counter()
    rm_poses = [rm.process_scan(s, 0.1 * i)
                for i, s in enumerate(scans[:cfg["raymarch_scans"]])]
    torch.cuda.synchronize()
    rep["raymarch"] = dict(
        scans=len(rm_poses), wall_s=time.perf_counter() - t0,
        fused_voxels=int((rm.mapping.state.weight != 0).sum()),
        finite=bool(np.all(np.isfinite(np.stack(rm_poses)))))
    rm.terminate()
    log("[featsense_app]", json.dumps(rep))
    if not (rep["finite"] and rep["raymarch"]["finite"]):
        raise AssertionError("non-finite featsense pose")
    if rep["repeat"]["identical_scans"] != len(scans):
        raise AssertionError(f"featsense did not repeat its poses on the "
                             f"card: {rep['repeat']}")
    if not rep["final_error_m"] < FEATSENSE_BOUND_M:
        raise AssertionError(f"featsense final error {rep['final_error_m']:.4f}"
                             f" m >= {FEATSENSE_BOUND_M} m")
    if launches["fusion"] == 0:
        raise AssertionError(f"K1 was not launched: {launches}")
    if rep["raymarch"]["fused_voxels"] == 0:
        raise AssertionError("the ray-march back end fused nothing")
    return rep


def phase(name, fn, *args):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name} {time.perf_counter() - t0:.2f} s")
    return out


# -------------------------------------------------------------------- main
def main() -> int:
    faulthandler.enable()        # a crash in a kernel call prints its stack
    if not (ROOT / "warpsense_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: warpsense_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    import warpsense_tpu_torch  # noqa: F401  (TF32 off)

    card = phase("card", record_card, torch)
    phase("build", build_kernels)
    state, k1 = phase("fusion_check", check_fusion, torch, FULL, device)
    k2 = phase("fields_check", check_fields_all, torch, state, FULL["tau"],
               device)
    k1_times = phase("fusion_times", time_fusion, torch, FULL, state,
                     ("level", "tilt"))
    k2_times = phase("fields_times", time_fields, torch, FULL, state)
    phase("fields_plain_times", time_fields_plain, torch, FULL, state,
          k2_times)
    del state
    torch.cuda.empty_cache()
    default_cfg = default_fusion_cfg()
    state, k1_default = phase("fusion_check_default", check_fusion, torch,
                              default_cfg, device)
    k1_times_default = phase("fusion_times_default", time_fusion, torch,
                             default_cfg, state, ("level", "tilt"))
    del state
    torch.cuda.empty_cache()
    app = phase("fast_app", run_app, torch, APP, device)
    phase("profile", profile_app, torch, APP, device)
    torch.cuda.empty_cache()
    tilt = phase("tilt_app", run_app, torch, TILT_APP, device)
    torch.cuda.empty_cache()
    parity = phase("parity_app", run_parity_app, torch, PARITY, device)
    torch.cuda.empty_cache()
    phase("raymarch", check_raymarch, torch, device, card["nvidia_smi"])
    torch.cuda.empty_cache()
    feats = phase("featsense_app", run_featsense_app, torch, FEATSENSE,
                  device)
    paths = {"fast_app": app["launches"], "tilt_app": tilt["launches"],
             "parity_app": parity["launches"],
             "featsense_app": feats["launches"]}

    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by",
                   "share_of_bound", "library_ms")

    def entry(t, *extra):
        return {k: t[k] for k in timing_keys + extra}

    k1_cases = {"level_full": entry(k1_times["level"]),
                "tilt_full": entry(k1_times["tilt"], "bound_ms_no_early_out"),
                "level_default": entry(k1_times_default["level"]),
                "tilt_default": entry(k1_times_default["tilt"],
                                      "bound_ms_no_early_out")}
    k2_cases = {f"{name}_full": dict(
        entry(k2_times[name]), **{k: k2_times[name][k] for k in (
            "per_launch_ms", "copy_ms", "share_of_copy")})
        for name in ("packed", "exact")}
    kernels = [
        {"name": "fusion_K1", "route": "cuda",
         "source": "warpsense_tpu_torch/csrc/fusion.cu",
         "replaces": "warpsense_tpu/kernels/tsdf_pallas.py:133",
         "also_replaces": "warpsense_tpu/kernels/tsdf_pallas.py:82",
         "launches": app["launches"]["fusion"],
         "launches_by_path": {k: v["fusion"] for k, v in paths.items()},
         "general_launches_by_path": {k: v["fusion_general"]
                                      for k, v in paths.items()},
         "max_abs_err": max(c["max_abs_err"] for c in k1 + k1_default),
         **k1_cases["level_full"], "cases": k1_cases},
        {"name": "fields_K2", "route": "cuda",
         "source": "warpsense_tpu_torch/csrc/fields.cu",
         "replaces": "warpsense_tpu/kernels/fields_pallas.py:79",
         "launches": app["launches"]["fields"],
         "launches_by_path": {k: v["fields"] for k, v in paths.items()},
         "max_abs_err": max(c["max_abs_err"] for c in k2),
         **k2_cases["packed_full"], "cases": k2_cases},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
