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
3b. the preprocessing kernel (one launch of csrc/preprocess.cu) against
   its plain version on the card at the apps' shapes (32,766 points in
   fast mode, 32,768 snapped) and snapped at 100 mm; 0 mismatches
   required; each app shape's time between CUDA events, its device time
   and launches under torch.profiler, a call and a sync on the host
   clock, beside the plain version's as the app ran it and its bound;
4. fields kernel K2 (packed, exact and parity) against its plain versions
   on the fused map (also with its weight plane at another offset from a
   16-byte boundary than its value plane: the wrapper stages an aligned
   copy) and on seeded windows of full-range values with weight on every
   face (so every wrap path runs) at 625 x 625 x 235 and at the default
   625 x 625 x 391, packed and exact each at tau 600 and 1000; 0
   mismatches required;
5. kernel and plain times (CUDA events around one call, median of 7; K2
   also per launch in runs of K2_LAUNCHES back-to-back launches), K1
   level and tilt (the general sweep) and K2 at 625 x 625 x 235, K1 level
   and tilt at the default shapes, each beside its bound: the least time
   an H100 SXM could take for the same work
   (bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s, whichever is
   longer; K1's bytes and operations counted from this run's inputs, the
   tilt's also under the count without its early-outs; K1 also beside the
   floor of its design's own traffic, sweep_floor_ms; K2 also beside a
   device-to-device copy of as many bytes, copy_ms); then K2's parity mode
   on the seeded window at the default 625 x 625 x 391;
5b. REGLOOP, the registration loop kernel (one launch a registration:
   K3, the statistics, and K4, the step, of every iteration) on FULL's
   fused map (packed and exact fields, the fast LM with a coarse phase and
   the gather freeze) and the default one (parity fields and GN), from 3
   seeded pretransforms of 1 degree and 141 mm (the LM also from two
   starts near its solution, where it freezes), each run traced: (a)
   each iteration's statistics against their plain version at the traced
   carry, every mode run (full, coarse, gather, cached), c equal, H / g /
   e within REGLOOP["k3_rtol"], a second launch tracing the same bits;
   (b) every traced step replayed by the plain step equal to the bit;
   (c) against the host loop (plain versions): equal iterations, poses
   within 0.5 mm / 1e-4 rad, the first step at which their decisions
   part and its margins, each loop's time, the loop kernel's
   synchronizing operations (PyTorch's sync debug mode: exactly one, the
   header read); then the loop kernel timed per registration and per
   iteration, beside its device time, the empty cluster loop and its
   bound, and the plain versions, an empty kernel and
   solve_ex on one 6x6 system.  Then SHARDLOOP, the sharded loop at a
   world of one (no group; an iteration one launch of shard_iter_kernel,
   K4 of the iteration before then K3, CHUNK of them between two header
   reads) from REGLOOP's starts, on a fresh mesh for each start: its
   first registration launched from the host, the second replayed from
   its captured chunk (a CUDA graph, captured once): its end state,
   header and every traced row equal to the loop kernel's to the bit,
   shard_reads(iterations) syncs (sync debug mode), CHUNK launches a read
   and from the graph one replay a read; shard_iter_kernel against its
   plain version (fused_iteration_plain) at the first FUSED_ITERATIONS
   traced carries of each problem (the new carry to the bit, the rows
   within REGLOOP["k3_rtol"], the slot and rows it read unchanged); then
   its time a registration (events and host clock, the graph and a fresh
   mesh's host launches) and its device time an iteration beside the bound.  Every
   registration of the apps below is one launch of the loop kernel and one
   header read (checked); each app prints its registrations' iterations,
   host syncs and loop time;
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
   six times), ATE below PARITY_ATE_BOUND_M, K1 launched, K2's parity
   mode launched once for each computation of the fields (the app's
   fields_cache_miss count);
9. ray-march fusion: one fuse_cloud(fusion="raymarch") on CUDA and on CPU
   tensors at a 161 x 161 x 61 window (0 value/weight mismatches), then
   its time at the default window;
9b. OFFLINE: eval.pcd2tsdf and eval.pcd_registration through their CLIs
   at the defaults (the synthetic BoxWorld scan) on the card, then with
   --device cpu in the same process: pcd2tsdf's exact agreement with its
   host twin 1.0 and its ray-marched volumes the CPU's bit for bit; each
   of pcd_registration's five cases one launch of the loop kernel and one
   sync, within OFFLINE_JAX_AVG_MM's bounds, in the CPU run's iterations
   and, in the three cases JAX's CLI recovers, within 1 mm of the CPU
   run's average error;
10. FeatsenseApp(device="cuda", fusion="auto") at configs/default.yaml on
   10 scans with translation and yaw, twice: finite poses, every pose of
   the second run equal to the first's bit for bit, final-pose error below
   FEATSENSE_BOUND_M, K1 launched; then 3 scans with fusion="raymarch";
11. FastsenseApp(device="cuda") at configs/default.yaml (FASTSENSE_APP):
   12 scans with an orientation IMU sample before each, first replayed
   with sync() after each scan (ATE at most twice the JAX app's, every
   fusion one launch of K1's general sweep, a (state, fields) snapshot
   taken before the first worker update bit-unchanged after the last,
   K2's parity mode launched once per published update),
   then the same scans without sync() (every job published by
   terminate(), finite poses); both profiled: scans/s, the registration
   span, each scan's GN iterations, each update's shift or clone, fusion
   and fields; then a held run without sync(): after the first scan, 6
   scans from one pose half a voxel away, the gate every second scan, so
   each worker update fuses a clone of the published map (no shift), and
   every snapshot taken after a scan stays bit-unchanged;
12. eval.slam_eval in-process at its defaults with --device cuda
   --in-memory-map: warpsense (20 frames, fast mode: K1's level sweep and
   K2 launched) and featsense (10 frames), each ATE at most twice the JAX
   CLI's on the same arguments;
13. the multi-GPU layer (SHARDED): ShardedWarpsenseApp at APP's settings
   on APP's walk as two spawned ranks on the one card over gloo (NCCL
   refuses two ranks on one device), the window 626 x 625 x 235 (313 x-rows
   a rank): the same pose on every rank after every scan, ATE below APP's
   bound, K1 launched on every rank once per fused scan and K2 launched,
   the sharded loop's kernel (shard_iter_kernel) CHUNK times a header
   read on every rank, over NCCL the chunk captured once and replayed
   from the second registration on (each rank prints its
   [registration sharded] report: launches an iteration, replays,
   captures, header reads, a torch.profiler table of one registration's
   host time); the rank's last registration run again
   traced, every traced step replayed by the plain step to the bit, the
   rank's own rows of every traced iteration (its slab's statistics)
   against reg_stats_plain on its slab (c equal, H / g / e within
   REGLOOP["k3_rtol"]), and the ranks' traces equal; a one-scan sharded fusion and the sharded
   fields of the app's map, gathered, equal to the single-GPU kernels' (0
   mismatches); each rank's spans, peak memory and its gloo staging (halo
   exchange, the rows' all-gather); then an NCCL group of one rank on
   APP's 10 scans, each pose equal to the single-GPU WarpsenseApp's at the
   same window and settings to the bit, at most shard_reads(iterations)
   syncs a registration (sync debug mode), its traced registration
   replayed; after each rank's counts were read, the same scans again
   with a LiveMonitor on every rank (the gloo ranks at a rate limit that
   takes at least 3 map snapshots, the NCCL rank at a period of 0 beside
   the single-GPU app with the same monitor, scan by scan): the
   unmonitored run's poses to the bit, the monitor's path those poses,
   every snapshot the rank's slab at its scan (the ranks' slabs in rank
   order), the gloo ranks' snapshots and status equal, the NCCL rank's
   every snapshot the single-GPU app's, each gather's host time printed;
14. utils.device_query --bandwidth (one JSON line per card);
15. eval.feature_compare on the card on one synthetic 128 x 1024 scan: the
   device picks within 1% of the host twin's (Jaccard at least 0.99), with
   the F-LOAM twin's counts.

Every phase prints its seconds.  Each path's kernel launches are counted
from 0 just before it runs; K1's also by sweep (general_launches_by_path:
the calls that ran the general sweep); the sharded paths' K4 + K3 as
shard_iter_kernel (its own entry, shard_iter_K4K3).

The last three lines are one JSON object describing the kernels, the
card's name and power limit as nvidia-smi prints them, and
{"ok": true, "device": {...}}.  Exits non-zero without printing a result
when no CUDA device is available or the package is missing.
"""
from __future__ import annotations

import faulthandler
import hashlib
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
# the line of the JAX package's build_beam_table, which the table step
# replaces
JAX_BEAM_TABLE_LINE = 117
# the table step's launches, one each a call: a memset of the keys, the
# bin kernel, prepare_kernel (as the profiler names them)
TABLE_KERNELS = ("bin_kernel", "prepare_kernel", "Memset")
# the line of the JAX package's preprocess, which the preprocessing kernel
# replaces (XLA there)
JAX_PREPROCESS_LINE = 27
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
# FastsenseApp at configs/default.yaml (parity mode, 625 x 625 x 391, tau
# 1000 mm) on APP's walk extended to 12 scans, with an orientation IMU
# sample before each scan and the reference's gate (every 100 scans or
# 0.25 m: a fusion about every third scan, a worker shift on each).  Cuts:
# 12 scans; the global map in memory.  The JAX FastsenseApp on the CPU, on
# these scans at a 359 x 265 x 125 window that holds the room
# (FASTSENSE_JAX_WINDOW_M, whole meters as the config takes them), reaches
# FASTSENSE_JAX_ATE_M (tests/_jax_fastsense_reference.py); the bound is
# twice that.
FASTSENSE_APP = dict(APP, scans=12, capacity=32768, update_frequency=100,
                     update_distance_m=0.25, held_scans=6)
FASTSENSE_JAX_WINDOW_M = (23, 17, 8)
FASTSENSE_JAX_ATE_M = 0.07810244042916908
# eval.slam_eval in-process at its own defaults (fast mode, 391 x 391 x 157
# at 64 mm, synthetic 128 x 1024 walk).  The JAX CLI on the CPU with the
# same arguments reaches SLAM_EVAL_JAX_ATE_M (tests/_jax_fastsense_reference
# .py); each run's bound is twice its figure.
SLAM_EVAL_ARGS = {
    "warpsense": ["--pipeline", "warpsense", "--frames", "20", "--channels",
                  "128", "--columns", "1024"],
    "featsense": ["--pipeline", "featsense", "--frames", "10"]}
SLAM_EVAL_JAX_ATE_M = {"warpsense": 0.0039, "featsense": 0.0063}
# the multi-GPU layer: ShardedWarpsenseApp at APP's settings on APP's walk,
# two ranks on the one card over gloo (NCCL refuses two ranks on one
# device), so FULL's x extent 625 rounds up to 626 (313 rows a rank) and
# the shift is synchronous; then an NCCL group of one rank on the same
# scans beside the single-GPU WarpsenseApp at the same window and settings
# (force_odd=False, the synchronous shift, the level grid), run in the
# same process.  Held to APP's ATE bound, equal poses on every rank, the
# gathered one-scan fusion and fields equal to the single-GPU kernels'
# bits, the NCCL rank's poses the single-GPU app's bits.
# Then each rank runs the same scans again with a live monitor (after the
# counted run, so the monitor is off on every timed path): the gloo ranks
# at a rate limit of monitor_period_scans of their median unmonitored scan
# plus the monitor's copy of a snapshot, a snapshot every second or third
# scan (at least min_snapshots; the clock starts after each ~0.5 s gather
# of 368 MB through gloo), the NCCL rank at a period of 0 beside the
# single-GPU app with the same monitor.
SHARDED = dict(APP, size=(626, 625, 235), world=2, backend="gloo",
               device="cuda:0", join_timeout_s=600, monitor_period_scans=2.0,
               min_snapshots=3)
# eval.pcd2tsdf and eval.pcd_registration through their CLIs at the
# defaults (the synthetic BoxWorld scan, 201 x 201 x 121 at 64 mm, up to
# 200 iterations), on the card and then on the CPU in the same process.
# JAX's CLI on the CPU leaves these average re-projection errors (mm) on
# the same cloud (tests/_jax_offline_reference.py); it recovers neither
# translation case to the 120 mm that tests/test_torch_eval.py holds on its
# smaller room, so a case's bound is the larger of that (idle: 20 mm) and
# twice JAX's.  The card takes the CPU run's iterations in every case, and
# in each case that JAX recovers (its bound the test's) ends within cpu_mm
# of the CPU run's average.  The two it does not recover stop at 200
# iterations wherever their float sums led them: the CPU run and JAX's
# part by 5 and 34 mm there, the card and the CPU run by ~90.
OFFLINE_JAX_AVG_MM = {"idle": 5.343475980760351,
                      "translation": 307.39163578914645,
                      "rotation": 42.298168682340716,
                      "rotation_inv": 34.725766719801534,
                      "translation+rotation": 291.12442625326736}
OFFLINE = dict(idle_bound_mm=20.0, case_bound_mm=120.0, cpu_mm=1.0)
# feature_compare on one synthetic 128 x 1024 scan, with capacities above
# the scan's feature counts so the device sets are not cut
FEATURE_COMPARE = dict(channels=128, columns=1024, edge_capacity=4096,
                       surf_capacity=32768)
# K2's seeded windows: full-range int16 values, weights nonzero with this
# probability (on every face too), checked at these taus
FIELDS_SEED = 7
FIELDS_WEIGHT_SHARE = 0.7
FIELDS_TAUS = (600, 1000)
# K2 is also timed per launch over runs of this many back-to-back launches
K2_LAUNCHES = 10
# REGLOOP: the loop kernel (K3, the statistics, and K4, the step, in one
# launch a registration) against the plain versions and the host loop, on
# FULL's fused map (packed and exact fields, the fast LM with a coarse
# phase of 3 iterations and the gather freeze) and DEFAULT's (parity fields
# and GN at configs/default.yaml's settings), from 3 seeded pretransforms
# of 1 degree and 141 mm; the LM also from the host loop's end pose of the
# first moved by each of near_mm, where its steps fall below the freeze
# before it stops (so the cached mode runs).  Tolerances: K3's sums run in
# another order than the plain version's matmul (relative 1e-5, H and g
# against their largest entry, c exact); K4 and its plain version run the
# same float32 operations (every traced step equal to the bit); the loops:
# equal iterations, PARITY_POSE_BOUND_MM and 1e-4 rad.
# SHARDLOOP (b) holds shard_iter_kernel to its plain version at this many
# traced iterations of each REGLOOP problem (parity's run to 200)
FUSED_ITERATIONS = 8
REGLOOP = dict(seed=9, poses=3, rot_deg=1.0, trans_mm=141.0,
               coarse_iterations=3, lm_max_iterations=50,
               near_mm=((8.0, -6.0, 4.0), (20.0, 10.0, -15.0)),
               k3_rtol=1e-5, rot_bound_rad=1e-4)
# float32 operations of K3 (csrc/registration.cu) per valid point, counted
# from its source (arithmetic, conversion, abs each one): fast layouts
# with the interpolated residual 91 (gradient 6, residual 10, lever 6,
# cross 9, scales 3, the 29 sums 57), parity 79; invalid points do
# integer work only.  K4's per step: the lanes' sums of the 29 columns
# 232 (plus one add a column a CTA row, counted by row), the system 50, the
# LU 233, xi_to_transform and the pose product 230, the tests 25.
K3_OPS_FAST = 91
K3_OPS_PARITY = 79
K4_OPS_STEP = 770


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
    """nvcc for each kernel source and g++ for the native runtime, all
    started together, then loaded."""
    from concurrent.futures import ThreadPoolExecutor

    from warpsense_tpu_torch import native
    from warpsense_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    names = ("fusion", "fields", "registration")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        jobs = [pool.submit(_build._build, name) for name in names]
        jobs.append(pool.submit(native.build))
        for job in jobs:
            job.result()
    for name in names:
        _build.load(name)
    native.load()
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


def case_window(torch, cfg, state, case, pts, mask):
    """(state, mask) of one K1 case: the state is ``state`` or, for a ring
    case, a view of its planes with the ring moved; the mask keeps a
    wedge case's wedge."""
    device = state.pos.device
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
    return state, mask


def case_inputs(torch, cfg, state, case, pts, mask):
    """(state, fusion_inputs) of one K1 case (``case_window``)."""
    from warpsense_tpu_torch.ops.tsdf_projective import fusion_inputs
    state, mask = case_window(torch, cfg, state, case, pts, mask)
    spos = torch.tensor(case["scanner"], dtype=torch.int32,
                        device=state.pos.device)
    return state, fusion_inputs(
        state, pts, mask, spos, case["R"], size=cfg["size"],
        tau=cfg["tau"], resolution=cfg["res"], channels=cfg["channels"],
        columns=cfg["columns"], vfov_deg=cfg["vfov_deg"])


def case_rows(torch, cfg, state, case, pts, mask):
    """(state, fusion_inputs, beams, rowmax) of one K1 case: K1's prepared
    rows and row maxima (``beam_rows``) of ``fusion_inputs``' table, the
    one table that K1 and its plain version are fed."""
    from warpsense_tpu_torch.ops.tsdf_projective import beam_rows
    state, inputs = case_inputs(torch, cfg, state, case, pts, mask)
    rng_tab, endpoint, smm = inputs[:3]
    beams, rowmax = beam_rows(rng_tab, endpoint, smm,
                              columns=cfg["columns"])
    return state, inputs, beams, rowmax


def room_points(torch, cfg, device):
    from warpsense_tpu_torch.io.synthetic import box_room_cloud
    X, Y, Z = cfg["size"]
    half = min(X, Y) * cfg["res"] * 45 // 100
    zhalf = Z * cfg["res"] * 40 // 100
    pts = torch.as_tensor(box_room_cloud(cfg["n"], half, zhalf),
                          device=device)
    return pts, torch.ones(pts.shape[0], dtype=torch.bool, device=device)


def check_fusion(torch, cfg, device):
    """K1 vs plain on identical inputs (one beam table per fusion, its
    prepared rows fed to both).  Returns (kernel state, per-case
    report)."""
    from warpsense_tpu_torch.kernels.fusion import fusion_sweep_merge
    from warpsense_tpu_torch.map.local_map import clone_state, create_state
    from warpsense_tpu_torch.ops.tsdf_projective import sweep_rows_plain
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
        sk, inputs, beams, rowmax = case_rows(torch, cfg, st_k, c, pts,
                                              mask)
        cx, cy, cz = inputs[3:]
        fusion_sweep_merge(sk.value, sk.weight, cx, cy, cz, beams, rowmax,
                           c["R"], max_weight=mw, level=c["level"], **kw)
        sweep_rows_plain(st_p.value, st_p.weight, cx, cy, cz, beams, c["R"],
                         max_weight=mw, **kw)
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


def check_fusion_table(torch, cfg, device):
    """The fusion's table step (``kernels/fusion.fusion_table``: a memset,
    the bin kernel and prepare_kernel, one call of ``csrc/fusion.cu``)
    against its plain version on the card, PyTorch's own table, in every
    K1 case at ``cfg``'s window: rows, maxima and coordinates equal to the
    bit.  Then its times in the level and tilt cases: ``ms``, one call
    between CUDA events (median of REPS, as K1's); ``device_us``, its
    launches' device time under torch.profiler; ``host_ms``, a call and a
    sync on the host clock; the plain table's (``fusion_inputs``, the
    eager path the app ran before) ``plain_ms`` and ``plain_host_ms``
    beside them.  Its floor: the bytes it must move (the points and mask
    read, the rows, maxima and coordinates written) at HBM_BYTES_PER_S,
    and its launches, which the profiler counts (``launches_by_kernel``,
    a call): one of each of TABLE_KERNELS.  ``max_abs_err`` is the largest |kernel - plain|
    over every output and case."""
    from warpsense_tpu_torch.kernels.fusion import fusion_table
    from warpsense_tpu_torch.map.local_map import LocalMapState
    from warpsense_tpu_torch.ops.tsdf_projective import (fusion_inputs,
                                                         fusion_table_plain)
    kw = dict(tau=cfg["tau"], resolution=cfg["res"],
              channels=cfg["channels"], columns=cfg["columns"],
              vfov_deg=cfg["vfov_deg"])
    X, Y, Z = cfg["size"]
    pts, mask = room_points(torch, cfg, device)
    # the window without planes: the table step reads its ring alone
    st = LocalMapState(
        value=torch.empty((X, Y, Z), dtype=torch.int16, device="meta"),
        weight=None, pos=torch.zeros(3, dtype=torch.int32, device=device),
        offset=torch.tensor([s // 2 for s in cfg["size"]],
                            dtype=torch.int32, device=device))
    out = {"cases": []}
    for c in fusion_cases(torch):
        sk, m = case_window(torch, cfg, st, c, pts, mask)
        args = (pts, m, sk.pos, sk.offset, c["scanner"], c["R"])
        got = fusion_table(*args, size=cfg["size"], **kw)
        want = fusion_table_plain(*args, size=cfg["size"], **kw)
        names = ("beams", "rowmax", "cx", "cy", "cz")
        bad = {n: int((g.contiguous().view(torch.int32)
                       != w.contiguous().view(torch.int32)).sum())
               for n, g, w in zip(names, got, want)}
        # equal values (a hole's +inf on both sides too) differ by 0
        err = max(float(torch.where(g == w, 0.0, (g - w).abs()).max())
                  for g, w in zip(got, want))
        case = dict(name=c["name"], size=list(cfg["size"]),
                    hits=int(torch.isfinite(got[0][:, 3]).sum()),
                    mismatch=bad, max_abs_err=err)
        log("[table]", json.dumps(case))
        out["cases"].append(case)
        if any(bad.values()):
            raise AssertionError(f"the table step disagrees with its "
                                 f"plain version: {case}")
        if c["name"] not in ("level", "tilt"):
            continue

        def step():
            fusion_table(*args, size=cfg["size"], **kw)

        def plain():
            fusion_inputs(sk, pts, m, c["scanner"], c["R"],
                          size=cfg["size"], **kw)

        def synced(fn):
            return lambda: (fn(), torch.cuda.synchronize())

        n = int(pts.shape[0])
        nbytes = n * 13 + 16 * cfg["channels"] * cfg["columns"] \
            + 4 * (cfg["columns"] + X + Y + Z)
        dev_us, per_call = kernel_profile(torch, step, TABLE_KERNELS)
        # the profiler may lose a record (49 memsets of 50 calls, seen on
        # an H100): a second launch of a kind would read ~2 a call
        launches = sum(round(v) for v in per_call.values())
        if any(round(v) != 1 for v in per_call.values()):
            raise AssertionError(f"the table step launched {per_call} a "
                                 f"call, not one of each")
        ms = time_ms(torch, step)
        t = dict(ms=ms, device_us=dev_us,
                 device_us_total=sum(dev_us.values()),
                 host_ms=time_host_ms(synced(step), reps=REPS),
                 plain_ms=time_ms(torch, plain),
                 plain_host_ms=time_host_ms(synced(plain), reps=REPS),
                 launches=launches, launches_by_kernel=per_call,
                 library_ms=None, **bound(nbytes, 0, ms))
        out[c["name"]] = t
        log(f"[time table {c['name']}]", json.dumps(t))
    out["max_abs_err"] = max(c["max_abs_err"] for c in out["cases"])
    return out


def preprocess_inputs(torch, capacity, device, seed=5):
    """One rendered 128 x 1024 scan as the app feeds it: a uniform draw of
    ``capacity`` of its points in their order, valid where nonzero, and a
    pose (mm) off the origin, on the host."""
    import numpy as np

    from warpsense_tpu_torch.io.synthetic import BoxWorld, render_scan
    rng = np.random.default_rng(seed)
    sensor = np.eye(4)
    sensor[:3, 3] = (1.5, -0.8, 0.3)
    scan = render_scan(BoxWorld.default(), sensor, channels=128,
                       columns=1024, noise_std=0.002, rng=rng)
    flat = scan.reshape(-1, 3).astype(np.float32)
    flat = flat[np.sort(rng.choice(len(flat), capacity, replace=False))]
    a = 0.3
    pose = np.eye(4, dtype=np.float32)
    pose[:2, :2] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
    pose[:3, 3] = (1500.0, -800.0, 300.0)
    return (torch.as_tensor(flat, device=device),
            torch.as_tensor(np.any(flat != 0.0, axis=1), device=device),
            pose)


def check_preprocess(torch, device):
    """The preprocessing kernel (``kernels/preprocess.preprocess``, one
    launch of ``csrc/preprocess.cu``) against its plain version on the
    card (``preprocess_plain``, the pose a card tensor) at the apps'
    shapes, APP's 32,766 points in fast mode (``snap`` off) and PARITY's
    32,768 snapped, and snapped at 100 mm: points and mask equal to the
    bit (``max_abs_err``, the largest |kernel - plain| over both and
    every case, reads 0).  Then at each app shape: ``ms``, one call between CUDA events
    (median of REPS); ``device_us``, its launch's device time under
    torch.profiler, which must count one launch a call; ``host_ms``, a
    call and a sync on the host clock; and the plain version as the app
    ran it (the pose copied to the card, then the eager ops),
    ``plain_ms`` and ``plain_host_ms``.  Its floor: the bytes it must move
    (the points and valid bytes read, the points and mask written) at
    HBM_BYTES_PER_S."""
    from warpsense_tpu_torch.kernels.preprocess import preprocess
    from warpsense_tpu_torch.ops.preprocess import preprocess_plain
    out = {"cases": []}
    for name, n, snap, res in (("fast", APP["capacity"], False, APP["res"]),
                               ("parity", PARITY["capacity"], True,
                                PARITY["res"]),
                               ("res100", APP["capacity"], True, 100)):
        cloud, valid, pose = preprocess_inputs(torch, n, device)
        kw = dict(resolution=res, capacity=n, snap=snap)

        def step():
            return preprocess(cloud, valid, pose, **kw)

        def plain():
            return preprocess_plain(cloud, valid,
                                    torch.as_tensor(pose, device=device),
                                    **kw)

        got, want = step(), plain()
        bad = [int((g != w).sum()) for g, w in zip(got, want)]
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        case = dict(name=name, n=n, snap=snap, res=res,
                    unique=int(want[1].sum()), mismatch=sum(bad),
                    max_abs_err=err)
        log("[preprocess]", json.dumps(case))
        out["cases"].append(case)
        if any(bad):
            raise AssertionError(f"the preprocessing kernel disagrees with "
                                 f"its plain version: {case}")
        if name == "res100":
            continue

        def synced(fn):
            return lambda: (fn(), torch.cuda.synchronize())

        dev_us, per_call = kernel_profile(torch, step, ("preprocess_kernel",))
        if round(per_call["preprocess_kernel"]) != 1:
            raise AssertionError(f"the preprocessing kernel launched "
                                 f"{per_call} a call, not once")
        ms = time_ms(torch, step)
        t = dict(ms=ms, device_us=dev_us["preprocess_kernel"],
                 host_ms=time_host_ms(synced(step), reps=REPS),
                 plain_ms=time_ms(torch, plain),
                 plain_host_ms=time_host_ms(synced(plain), reps=REPS),
                 launches=round(per_call["preprocess_kernel"]),
                 library_ms=None, **bound(2 * 13 * n, 0, ms))
        out[name] = t
        log(f"[time preprocess {name}]", json.dumps(t))
    out["max_abs_err"] = max(c["max_abs_err"] for c in out["cases"])
    return out


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


def check_fields_parity(torch, state, name):
    """K2's parity mode against ``precompute_fields`` on ``state``: 0
    mismatching int32 words required in each of the three planes."""
    from warpsense_tpu_torch.kernels.fields import fields_parity
    from warpsense_tpu_torch.ops.registration import precompute_fields
    k, p = fields_parity(state), precompute_fields(state)
    report = dict(name=name, size=list(state.value.shape),
                  parity_mismatch=[int((a != b).sum()) for a, b in zip(k, p)],
                  max_abs_err=max(int((a.long() - b.long()).abs().max())
                                  for a, b in zip(k, p)),
                  valid=int((k.vw >> 16).ne(0).sum()),
                  gradients=[int(g.ne(0).sum()) for g in (
                      k.gxy & 0xFFFF, k.gxy >> 16, k.gz)])
    log("[K2 parity]", json.dumps(report))
    if any(report["parity_mismatch"]):
        raise AssertionError(f"K2's parity mode disagrees with "
                             f"precompute_fields: {report}")
    if report["valid"] == 0 or 0 in report["gradients"]:
        raise AssertionError(f"K2's parity mode saw no weight or no "
                             f"gradient: {report}")
    return report


def misaligned_weight(torch, state):
    """``state`` with its weight plane moved to a view that starts 2 bytes
    past the value plane's offset from a 16-byte boundary (a window cut
    from a larger buffer at another offset)."""
    n = state.weight.numel()
    buf = torch.empty(n + 8, dtype=state.weight.dtype,
                      device=state.weight.device)
    shift = ((state.value.data_ptr() - buf.data_ptr()) % 16 // 2 + 1) % 8
    view = buf[shift:shift + n].view(state.weight.shape)
    view.copy_(state.weight)
    if view.data_ptr() % 16 == state.value.data_ptr() % 16:
        raise AssertionError("the weight view is not misaligned")
    return state._replace(weight=view)


def check_fields_all(torch, state, tau, device):
    """K2 on the fused map ``state`` (also with its weight plane misaligned
    against its value plane: the wrapper stages an aligned copy), then on
    seeded full-range windows at FULL and at the default shapes, each at
    tau 600 and 1000; its parity mode on the same windows (tau plays no
    part there).  The seeded windows carry weight on every face, so every
    wrap path is exercised."""
    from warpsense_tpu_torch.kernels.fields import fields_packed, fields_parity
    report = [check_fields(torch, state, tau, "fused"),
              check_fields_parity(torch, state, "fused")]
    copies = fields_packed.staged_copies, fields_parity.staged_copies
    skewed = misaligned_weight(torch, state)
    report.append(check_fields(torch, skewed, tau, "fused_misaligned_weight"))
    report.append(check_fields_parity(torch, skewed,
                                      "fused_misaligned_weight"))
    staged = (fields_packed.staged_copies - copies[0],
              fields_parity.staged_copies - copies[1])
    if staged != (2, 1):
        raise AssertionError(f"K2 did not stage the misaligned weight: "
                             f"{staged} copies (packed and exact, parity)")
    del skewed
    torch.cuda.empty_cache()
    for label, size in (("full", FULL["size"]),
                        ("default", default_fusion_cfg()["size"])):
        seeded = seeded_fields_state(torch, size, device)
        if min(face_weight_shares(seeded)) < FIELDS_WEIGHT_SHARE - 0.05:
            raise AssertionError("a seeded face lacks weight")
        for t in FIELDS_TAUS:
            report.append(check_fields(torch, seeded, t,
                                       f"seeded_{label}_tau{t}"))
        report.append(check_fields_parity(torch, seeded, f"seeded_{label}"))
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
    """K1 times of the named fusion cases on ``state``: K1 alone on the
    case's prepared rows, as the app launches it after the table step
    (each run starts from a copy of ``state``; the copy and the rows are
    made outside the timed region); with ``bounds``, also the plain
    sweep's times on the same rows and each case's bound, counted from its
    table (``fusion_work`` on ``fusion_inputs``' table)."""
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
        _, inputs, beams, rowmax = case_rows(torch, cfg, state, c, pts,
                                             mask)
        rng_tab, endpoint, smm, cx, cy, cz = inputs
        level = c["level"]
        k_ms = time_ms(torch, lambda: fusion_sweep_merge(
            work[0], work[1], cx, cy, cz, beams, rowmax, c["R"],
            max_weight=mw, level=level, **kw), setup=reset)
        out[c["name"]] = dict(size=list(cfg["size"]), tau=cfg["tau"],
                              ms=k_ms)
        if bounds:
            from warpsense_tpu_torch.ops.tsdf_projective import (
                fusion_work, sweep_rows_plain)
            p_ms = time_ms(torch, lambda: sweep_rows_plain(
                work[0], work[1], cx, cy, cz, beams, c["R"], max_weight=mw,
                **kw), setup=reset, reps=5)
            counts = fusion_work(cx, cy, cz, rng_tab, endpoint, smm, c["R"],
                                 level=level, **kw)
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


# int32 planes K2 writes in each mode (``time_fields``'s ``modes``)
FIELDS_PLANES = {"packed": 1, "exact": 2, "parity": 3}


def time_fields(torch, cfg, state, modes=("packed", "exact")):
    """K2 times on ``state`` in each of ``modes``, each beside its bound:
    the int16 value and weight planes read once and the mode's int32
    planes written (``FIELDS_PLANES``).  Its work is integer work, far
    below the float32 rate, so bytes bound it.  ``ms`` is one wrapper call
    between two events, as K1's, so it holds the host's work before the
    launch; ``per_launch_ms`` is the same call in runs of back-to-back
    calls (``time_per_launch``), without that gap.  Beside them ``copy_ms``: a device-to-device ``copy_`` that
    moves as many bytes (half of them read, half written), timed per
    launch, the rate the card reaches in practice, and ``share_of_copy`` =
    copy_ms / per_launch_ms."""
    from warpsense_tpu_torch.kernels import fields as kf
    nvox = state.value.numel()
    out = {}
    for mode in modes:
        def call():
            if mode == "parity":
                kf.fields_parity(state)
            else:
                kf.fields_packed(state, tau=cfg["tau"],
                                 exact=mode == "exact")
        k_ms = time_ms(torch, call)
        pl_ms = time_per_launch(torch, call)
        moved = (4 + 4 * FIELDS_PLANES[mode]) * nvox
        src = torch.empty(moved // 2, dtype=torch.uint8,
                          device=state.value.device)
        dst = torch.empty_like(src)
        c_ms = time_per_launch(torch, lambda: dst.copy_(src))
        del src, dst
        out[mode] = dict(
            size=list(state.value.shape), ms=k_ms, library_ms=None,
            **bound(moved, 0, k_ms), per_launch_ms=pl_ms, copy_ms=c_ms,
            share_of_copy=c_ms / pl_ms)
    return out


def time_fields_plain(torch, cfg, state, times):
    """The plain versions' times into ``times`` (``time_fields``'s, each
    mode it timed), taken after all the kernel times: the plain versions'
    heavy traffic slows a kernel timed right after them."""
    from warpsense_tpu_torch.ops.registration import (
        precompute_fields, precompute_fields_packed, precompute_fields_packed2)
    plain = {"packed": lambda: precompute_fields_packed(state, tau=cfg["tau"]),
             "exact": lambda: precompute_fields_packed2(state),
             "parity": lambda: precompute_fields(state)}
    for name, t in times.items():
        t["plain_ms"] = time_ms(torch, plain[name], reps=5)
        log(f"[time K2 {name}]", json.dumps(t))
    return times


def time_fields_parity(torch, device):
    """K2's parity mode timed (``time_fields``, then its plain version) on
    the seeded full-range window at the default 625 x 625 x 391, the
    window the shipped parity configuration computes its fields on."""
    cfg = default_fusion_cfg()
    state = seeded_fields_state(torch, cfg["size"], device)
    times = time_fields_plain(torch, cfg, state,
                              time_fields(torch, cfg, state, ("parity",)))
    del state
    torch.cuda.empty_cache()
    return times["parity"]


# ------------------------------------------------------------- phase 5b
def regloop_poses(torch, cfg=None):
    """REGLOOP's pretransforms: each a rotation of REGLOOP["rot_deg"] about
    a seeded axis and a translation of REGLOOP["trans_mm"] in a seeded
    direction."""
    import numpy as np
    cfg = cfg or REGLOOP
    rng = np.random.default_rng(cfg["seed"])
    poses = []
    for _ in range(cfg["poses"]):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        a = math.radians(cfg["rot_deg"])
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        pose = np.eye(4)
        pose[:3, :3] = np.eye(3) + math.sin(a) * K + (1 - math.cos(a)) * K @ K
        d = rng.normal(size=3)
        pose[:3, 3] = cfg["trans_mm"] * d / np.linalg.norm(d)
        poses.append(torch.tensor(pose, dtype=torch.float32))
    return poses


def regloop_problems(torch, full_state, default_state, device):
    """The three layouts' RegProblems: K2's packed and exact fields of
    FULL's fused map (the fast LM with a coarse phase and the gather
    freeze, so one loop runs every K3 mode) and the plain parity fields of
    DEFAULT's (the parity GN at configs/default.yaml's settings), each
    with its fused room cloud."""
    from warpsense_tpu_torch.kernels.fields import fields_packed
    from warpsense_tpu_torch.ops import registration as treg
    out = {}
    pts, mask = room_points(torch, FULL, device)
    lm = dict(pos=full_state.pos, offset=full_state.offset, points=pts,
              mask=mask, size=FULL["size"], resolution=FULL["res"],
              tau=FULL["tau"], interp=True, normalize=False, lm=True,
              recenter=True, coarse_iterations=REGLOOP["coarse_iterations"],
              split=True, max_iterations=REGLOOP["lm_max_iterations"],
              epsilon=0.03, it_weight_gradient=0.0,
              freeze_step_mm=float(FULL["res"]))
    out["packed"] = treg.RegProblem(
        fields=fields_packed(full_state, tau=FULL["tau"]),
        layout=treg.LAYOUT_PACKED, **lm)
    out["exact"] = treg.RegProblem(
        fields=fields_packed(full_state, tau=FULL["tau"], exact=True),
        layout=treg.LAYOUT_EXACT, **lm)
    dcfg = default_fusion_cfg()
    reg = default_params().registration
    dpts, dmask = room_points(torch, dcfg, device)
    out["parity"] = treg.RegProblem(
        fields=treg.precompute_fields(default_state),
        pos=default_state.pos, offset=default_state.offset, points=dpts,
        mask=dmask, size=dcfg["size"], resolution=dcfg["res"],
        tau=dcfg["tau"], layout=treg.LAYOUT_PARITY, interp=False,
        normalize=False, lm=False, recenter=False, coarse_iterations=0,
        split=False, max_iterations=reg.max_iterations,
        epsilon=reg.epsilon, it_weight_gradient=reg.it_weight_gradient,
        freeze_step_mm=0.0)
    return out


def count_syncs(torch, fn, where=None):
    """(fn's result, the synchronizing CUDA operations it ran), counted by
    PyTorch's sync debug mode (every device-to-host copy, host-to-device
    copy from pageable memory and stream wait warns once); ``where``
    (a dict) collects each one's Python file:line and its two callers'."""
    import traceback
    import warnings
    syncs = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            syncs.append(" < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                    for f in reversed(stack[-3:])))
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # the mode switch's own warning (once a process) is not fn's
        warnings.showwarning = lambda *a, **k: None
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = hook
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if where is not None:
        for key in syncs:
            where[key] = where.get(key, 0) + 1
    return out, len(syncs)


def rot_err_rad(a, b) -> float:
    import numpy as np
    m = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    v = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v) / 2.0)))


def loop_traced(torch, prob, pose, where=None):
    """One registration through ``run_registration`` with a trace:
    (state, header, trace, synchronizing operations)."""
    from warpsense_tpu_torch.kernels import registration as kreg
    from warpsense_tpu_torch.ops import registration as treg
    trace = torch.zeros((prob.max_iterations, kreg.TRACE_WIDTH),
                        device=pose.device)
    (st, head), syncs = count_syncs(torch, lambda: treg.run_registration(
        prob, pose, trace=trace), where)
    return st, head, trace, syncs


def trace_stats(prob, trace, iterations, rows=None) -> dict:
    """REGLOOP (a) on one traced run (``ops/registration.trace_stats``;
    ``rows``: a rank's rows of a sharded trace, ``prob`` its slab): c
    equal and H / g / e within REGLOOP["k3_rtol"] in every iteration; the
    worst of each, the modes the run went through, each iteration's mode
    and c (valid points) and the iterations that fail.  Without ``rows``
    it runs on an older checkout's package too (tools/kernel_ab.py)."""
    from warpsense_tpu_torch.ops import registration as treg
    its = treg.trace_stats(trace, iterations, prob, *(
        () if rows is None else (rows,)))
    keys = ("H_rel", "g_rel", "e_rel")
    worst = {k: max((r[k] for r in its), default=0.0) for k in keys}
    bad = [dict(iteration=k, **r) for k, r in enumerate(its)
           if not (r["c"] == r["c_plain"] and r["c"] > 0
                   and max(r[k] for k in keys) <= REGLOOP["k3_rtol"])]
    modes = [r["mode"] for r in its]
    return dict(worst, modes=sorted(set(modes)), mode_by_iteration=modes,
                valid=[int(r["c"]) for r in its], bad=bad)


def step_margins(prob, tests) -> dict:
    """Each test of one step (``reg_step_plain``'s returned values) as a
    signed margin: below 0 the test holds.  LM: accept (err - acc_err),
    window (the larger distance to prev[2] and prev[0], less epsilon),
    tiny and freeze (rot2 and tr2 less their thresholds); GN: window."""
    import numpy as np
    f = np.float32
    t = {k: (v.double().numpy() if hasattr(v, "double") else v)
         for k, v in tests.items()}
    err = t["err2"] if prob.lm else t["err"]
    prev = t["prev"]
    out = dict(window=float(max(abs(err - prev[2]), abs(err - prev[0]))
                            - f(prob.epsilon)))
    if prob.lm:
        out.update(accept=float(t["err"] - t["acc_err"]),
                   tiny_rot=float(t["rot2"] - f(1e-7)),
                   tiny_tr=float(t["tr2"] - f(0.25)),
                   freeze_tr=float(t["tr2"] - f(prob.freeze_step_mm ** 2)),
                   freeze_rot=float(t["rot2"] - f(1e-6)))
    return out


def damped_condition(prob, before, after, rows) -> float:
    """The 2-norm condition number (float64) of the damped system one step
    solved: LM the accepted H after the step with the step's alpha times
    its diagonal (plus 1e-12); GN H from the step's rows plus alpha c D^2
    (alpha before the step)."""
    import numpy as np

    from warpsense_tpu_torch.ops import registration as treg
    if prob.lm:
        A = after[treg.S_ACCH:treg.S_ACCH + 36].double().numpy().reshape(6, 6)
        d = np.diag(A).copy()
        A[np.diag_indices(6)] = d + float(after[treg.S_ALPHA]) * (d + 1e-12)
    else:
        tot = treg.sum_partials(rows.reshape(-1, treg.PARTIALS)).double()
        A = tot[treg._FULL].numpy().reshape(6, 6)
        D2 = np.array([treg._SC ** 2] * 3 + [treg._SG ** 2] * 3)
        A[np.diag_indices(6)] += float(before[treg.S_ALPHA]) * float(
            tot[28]) * D2
    return float(np.linalg.cond(A))


def cell_changes(torch, prob, a, b) -> dict:
    """What the trial poses of two carries change of the cloud's discrete
    state: the entries of the fixed-point matrix trunc(T * 32768) that
    differ, and the points (of all, mask aside) whose transformed integer
    mm or whose voxel differ."""
    from warpsense_tpu_torch.core.consts import MATRIX_RESOLUTION
    from warpsense_tpu_torch.core.geometry import transform_point_fixed
    from warpsense_tpu_torch.ops import registration as treg
    out = []
    for c in (a, b):
        T = c[treg.S_TRIAL:treg.S_TRIAL + 16].reshape(4, 4).to(
            prob.points.device)
        m = torch.trunc(T * MATRIX_RESOLUTION).to(torch.int32)
        pts = transform_point_fixed(prob.points, m)
        out.append((m, pts, torch.div(pts, prob.resolution,
                                      rounding_mode="floor")))
    return dict(matrix_entries=int((out[0][0] != out[1][0]).sum()),
                points_mm=int((out[0][1] != out[1][1]).any(1).sum()),
                points_voxel=int((out[0][2] != out[1][2]).any(1).sum()),
                points=int(prob.points.shape[0]))


def loop_parting(prob, dev, host) -> dict:
    """Where the loop kernel's run and the host loop's part.  A decision:
    the first step after which a flag of their carries (finished, frozen,
    improved, ok) differs, with each side's margins at that step
    (``step_margins``) and the pose difference before it.  Without one,
    where their poses grow apart by more than 1e-3 mm at the end: each
    step's pose difference, the first step after which it reaches a tenth
    of the last, that step's damped system's condition number and the
    relative difference of the two runs' statistics there (the float
    order's part, amplified by the solve), and the first step whose
    statistics differ by more than 1e-4 relative with what the two trial
    poses change of the cloud there (``cell_changes``).  None when the
    runs end within 1e-3 mm with every decision equal.  ``dev`` and
    ``host``: (end state, trace, the replay's tests)."""
    import torch

    from warpsense_tpu_torch.ops import registration as treg
    flags = {"finished": treg.S_FIN, "frozen": treg.S_FROZEN,
             "improved": treg.S_IMPROVED, "ok": treg.S_OK}
    pose_of = treg.S_ACC if prob.lm else treg.S_TRIAL

    def carry(run, k):
        st, tr, _ = run
        return (tr[k, :treg.STATE_LEN] if k < int(st[treg.S_I]) else st).cpu()

    def pose_mm(a, b):
        return float((a[pose_of:pose_of + 16] - b[pose_of:pose_of + 16])
                     .reshape(4, 4)[:3, 3].abs().max())
    n = min(int(dev[0][treg.S_I]), int(host[0][treg.S_I]))
    for k in range(n):
        a, b = carry(dev, k + 1), carry(host, k + 1)
        differ = [f for f, i in flags.items() if float(a[i]) != float(b[i])]
        if differ:
            return dict(step=k, flags=differ,
                        margins_device=step_margins(prob, dev[2][k]),
                        margins_host=step_margins(prob, host[2][k]),
                        pose_mm_before=pose_mm(carry(dev, k),
                                               carry(host, k)))
    by_step = [pose_mm(carry(dev, k + 1), carry(host, k + 1))
               for k in range(n)]
    if not by_step or by_step[-1] < 1e-3:
        return None
    def stats_rel(j):
        sd, sh = (treg.sum_partials(run[1][j, treg.STATE_LEN:].cpu()
                                    .reshape(-1, treg.PARTIALS)).double()
                  for run in (dev, host))
        return float((sd[:27] - sh[:27]).abs().max() / sh[:27].abs().max())
    rel_by_step = [stats_rel(j) for j in range(n)]
    k = next(j for j, d in enumerate(by_step) if d >= 0.1 * by_step[-1])
    ks = next((j for j, r in enumerate(rel_by_step) if r > 1e-4), None)
    return dict(step=None, flags=[], pose_mm_by_step=by_step,
                stats_rel_by_step=rel_by_step, grows_at=k,
                condition=damped_condition(
                    prob, carry(dev, k), carry(dev, k + 1),
                    dev[1][k, treg.STATE_LEN:].cpu()),
                stats_part_at=ks,
                cell_changes=None if ks is None else cell_changes(
                    torch, prob, carry(dev, ks), carry(host, ks)))


def check_loops(torch, probs, poses) -> dict:
    """REGLOOP (a)-(c) from every start in each layout (the LM's also near
    its solution: REGLOOP["near_mm"]), each registration
    one launch of the loop kernel with a trace: (a) ``trace_stats``, and
    a second launch tracing the same bits; (b) every traced step replayed
    by reg_step_plain (``replay_trace``) equal to the bit; (c) against the
    host loop (the plain versions, the state on the CPU, the statistics
    on the card): equal iterations, poses within PARITY_POSE_BOUND_MM and
    REGLOOP["rot_bound_rad"], the first step at which their decisions
    part (``loop_parting``); each loop's host-clock time and the loop
    kernel's synchronizing operations (one header read)."""
    import numpy as np

    from warpsense_tpu_torch.ops import registration as treg
    report = {}
    for name, prob in probs.items():
        pose_of = treg.S_ACC if prob.lm else treg.S_TRIAL
        loop_traced(torch, prob, poses[0])                  # warm-up
        runs, where = [], {}
        starts = list(poses)
        if prob.lm:
            end = treg.run_registration(prob, poses[0], host=True)[0]
            for d in REGLOOP["near_mm"]:
                near = end[treg.S_ACC:treg.S_ACC + 16].reshape(4, 4).clone()
                near[:3, 3] += torch.tensor(d)
                starts.append(near.to(poses[0].device))
        for j, pose in enumerate(starts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, head, trace, syncs = loop_traced(torch, prob, pose,
                                                 where=where)
            dev_ms = (time.perf_counter() - t0) * 1e3
            st2, _, trace2, _ = loop_traced(torch, prob, pose)
            n = int(head[treg.S_I])
            stats = trace_stats(prob, trace, n)
            _, differ, tests, step_err = treg.replay_trace(trace, st,
                                                           prob)
            htrace = torch.zeros((prob.max_iterations, treg.trace_width(1)))
            t0 = time.perf_counter()
            hst, hhead = treg.run_registration(prob, pose, host=True,
                                               trace=htrace)
            host_ms = (time.perf_counter() - t0) * 1e3
            _, hdiffer, htests, _ = treg.replay_trace(htrace, hst, prob)
            d = st[pose_of:pose_of + 16].reshape(4, 4).cpu().numpy()
            h = hst[pose_of:pose_of + 16].reshape(4, 4).numpy()
            runs.append(dict(
                pose=j, iterations=n, host_iterations=int(hhead[treg.S_I]),
                pose_mm=float(np.abs(d[:3, 3] - h[:3, 3]).max()),
                rot_rad=rot_err_rad(d, h),
                moved_mm=float(np.abs(d[:3, 3] - pose[:3, 3].cpu().numpy())
                               .max()),
                repeat_bit_equal=bool(torch.equal(st, st2)
                                      and torch.equal(trace, trace2)),
                steps_replayed=len(tests), steps_differ=differ,
                step_max_abs_err=step_err,
                host_steps_differ=hdiffer,
                parting=loop_parting(prob, (st, trace, tests),
                                     (hst, htrace, htests)),
                device_loop_ms=dev_ms, host_loop_ms=host_ms,
                device_syncs=syncs, **{k: stats[k] for k in (
                    "H_rel", "g_rel", "e_rel", "modes", "valid", "bad")}))
        report[name] = runs
        log(f"[REGLOOP {name}]", json.dumps(dict(
            runs=runs, device_syncs_at=where, k3_rtol=REGLOOP["k3_rtol"])))
        for r in runs:
            if r["bad"] or not r["repeat_bit_equal"]:
                raise AssertionError(f"the loop kernel's statistics differ "
                                     f"from the plain version's ({name}): "
                                     f"{r}")
            if r["steps_differ"] or r["host_steps_differ"] \
                    or r["steps_replayed"] != r["iterations"]:
                raise AssertionError(f"a traced step differs from the "
                                     f"plain step ({name}): {r}")
            if not (r["iterations"] == r["host_iterations"]
                    and r["pose_mm"] < PARITY_POSE_BOUND_MM
                    and r["rot_rad"] < REGLOOP["rot_bound_rad"]):
                raise AssertionError(f"the loop kernel and the host loop "
                                     f"differ ({name}): {r}")
            # the header read, and nothing else
            if r["device_syncs"] != 1:
                raise AssertionError(f"the loop kernel's registration "
                                     f"synchronized {r['device_syncs']} "
                                     f"times ({name}; at {where})")
    modes = set().union(*(r["modes"] for runs in report.values()
                          for r in runs))
    if modes != {"full", "coarse", "gather", "cached"}:
        raise AssertionError(f"REGLOOP ran the statistics in {modes} only")
    return report


def loop_cost(prob, modes, valid, rows=None, iteration_bytes=0) -> tuple:
    """Bytes and float32 ops of one registration of the loop kernel, from
    its trace's modes and valid counts: per iteration each point's int32
    xyz and mask byte read once (every 4th point in the coarse phase), each
    valid point's gathered words (4 B packed, 8 exact, 12 parity), the
    gather's per-point cache written (29 B) or the cached mode's read (its
    valid byte a point, 28 B a valid point) in place of mask and gather;
    the carry read and written once; K3_OPS_* a valid point and K4_OPS_STEP
    plus one add a column a row of statistics (``rows``, the cluster's
    CTAs by default) a step.  ``iteration_bytes``: bytes an iteration moves
    besides (the sharded loop's carry and rows through device memory)."""
    from warpsense_tpu_torch.kernels.registration import CLUSTER
    from warpsense_tpu_torch.ops import registration as treg
    rows = CLUSTER if rows is None else rows
    n = prob.points.shape[0]
    gathered = {treg.LAYOUT_PACKED: 4, treg.LAYOUT_EXACT: 8,
                treg.LAYOUT_PARITY: 12}[prob.layout]
    per_point = (K3_OPS_PARITY if prob.layout == treg.LAYOUT_PARITY
                 else K3_OPS_FAST)
    nbytes, ops = 8 * treg.STATE_LEN, 0
    for mode, v in zip(modes, valid):
        if mode == "cached":
            nbytes += 13 * n + 28 * v
        else:
            pts = -(-n // 4) if mode == "coarse" else n
            nbytes += 13 * pts + gathered * v + (29 * n if mode == "gather"
                                                 else 0)
        nbytes += iteration_bytes
        ops += per_point * v + K4_OPS_STEP + treg.SUMS * rows
    return nbytes, ops


def time_host_ms(fn, setup=None, reps=5) -> float:
    """Median host-clock time of ``fn`` (CPU work) over ``reps`` runs
    after a warm-up; ``setup`` runs before each, outside the clock."""
    times = []
    for _ in range(reps + 1):
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times = sorted(times[1:])
    return times[len(times) // 2]


def registration_report(launches, name, *, check=True) -> dict:
    """The registrations of one path from its counts (``read_launches``):
    their iterations, the loop kernel's launches, the header reads (host
    syncs) and the loop's host-clock time, each per registration.  With
    ``check``: every registration was one launch of the loop kernel and
    one read of the card."""
    n = launches["registrations"]
    rep = dict(registrations=n, iterations=launches["reg_iterations"],
               syncs=launches["reg_syncs"],
               loop_kernel_launches=launches["reg_loop"])
    if n:
        rep.update(iterations_per_registration=rep["iterations"] / n,
                   syncs_per_registration=rep["syncs"] / n,
                   loop_ms_per_registration=launches["reg_seconds"] * 1e3
                   / n)
    log(f"[registration {name}]", json.dumps(rep))
    if check and not (n > 0 and rep["loop_kernel_launches"] == n
                      and rep["syncs"] == n):
        raise AssertionError(f"{name}: a registration was not one launch "
                             f"of the loop kernel and one read: {rep}")
    return rep


def time_loops(torch, probs, poses) -> dict:
    """REGLOOP (e): each timed problem from the first pose: one
    registration between CUDA events (``ms``, the state made outside
    them), the loop kernel's device time (torch.profiler) and the empty
    cluster loop's at as many iterations, each per registration and per
    iteration, beside the registration's bound (``loop_cost`` of its
    trace) and the loop's device time per iteration on every 1,024th
    point (the step, the reductions and the barrier without the
    statistics' work).  The timed problems: the fast app's (packed, the
    freeze, no coarse phase), REGLOOP's three."""
    from warpsense_tpu_torch.kernels import registration as kreg
    from warpsense_tpu_torch.ops import registration as treg
    dev = poses[0].device
    timed = dict(packed_app=probs["packed"]._replace(coarse_iterations=0),
                 **probs)
    out = {}
    sink = torch.zeros(32, device=dev)
    for name, prob in timed.items():
        st0 = treg.init_state(prob, poses[0], dev)
        trace = torch.zeros((prob.max_iterations, kreg.TRACE_WIDTH),
                            device=dev)
        st = st0.clone()
        kreg.reg_loop(st, prob, trace=trace)
        n = int(st[treg.S_I])
        stats = trace_stats(prob, trace, n)
        k_ms = time_ms(torch, lambda: kreg.reg_loop(st, prob),
                       setup=lambda: st.copy_(st0))
        us = kernel_device_us(torch, lambda: (
            st.copy_(st0), kreg.reg_loop(st, prob),
            kreg.launch_cluster_empty(sink, n)),
            ("loop_kernel", "empty_cluster_loop"), reps=20)
        nbytes, ops = loop_cost(prob, stats["mode_by_iteration"],
                                stats["valid"])
        # the same loop on every 1,024th point (one a thread at most;
        # epsilon 0, so only the step's own tests stop it): the
        # iteration's cost without its statistics' work
        few = prob._replace(points=prob.points[::1024],
                            mask=prob.mask[::1024], epsilon=0.0,
                            max_iterations=max(n, 2))
        st_f0 = treg.init_state(few, poses[0], dev)
        st_f = st_f0.clone()
        kreg.reg_loop(st_f, few)
        n_few = int(st_f[treg.S_I])
        us_few = kernel_device_us(torch, lambda: (
            st_f.copy_(st_f0), kreg.reg_loop(st_f, few)),
            ("loop_kernel",), reps=20)
        t = dict(cluster=kreg.CLUSTER, iterations=n, ms=k_ms,
                 device_ms=us["loop_kernel"] / 1e3,
                 empty_cluster_device_ms=us["empty_cluster_loop"] / 1e3,
                 few_points_iterations=n_few,
                 few_points_device_ms_per_iteration=us_few[
                     "loop_kernel"] / 1e3 / max(n_few, 1),
                 **bound(nbytes, ops, us["loop_kernel"] / 1e3))
        for key in ("ms", "device_ms", "empty_cluster_device_ms",
                    "bound_ms"):
            t[f"{key}_per_iteration"] = t[key] / max(n, 1)
        out[name] = t
        log(f"[time loop {name}]", json.dumps(t))
    return out


def time_plain(torch, probs, poses) -> dict:
    """The halves' plain versions and yardsticks: reg_stats_plain in its
    full mode on the packed FULL problem (the fast app's iteration) and on
    the parity one (on the card), reg_step_plain on the CPU, an empty
    kernel (one launch's floor) and torch.linalg.solve_ex on one 6x6
    system (K4's library yardstick), each one call between events."""
    from warpsense_tpu_torch.kernels import registration as kreg
    from warpsense_tpu_torch.ops import registration as treg
    dev = poses[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = dict(empty_ms=time_ms(torch, lambda: kreg.launch_empty(stream)))
    for name in ("packed", "parity"):
        prob = probs[name]._replace(coarse_iterations=0, split=False)
        st = treg.init_state(prob, poses[0], dev)
        out[f"K3_plain_{name}_ms"] = time_ms(
            torch, lambda: treg.reg_stats_plain(st, prob, {}), reps=5)
    prob = probs["parity"]
    st_p = treg.init_state(prob, poses[0], "cpu")
    row = treg.reg_stats_plain(st_p.to(dev), prob, {}).cpu()
    ref = st_p.clone()
    out["K4_plain_ms"] = time_host_ms(
        lambda: treg.reg_step_plain(st_p, row, prob),
        setup=lambda: st_p.copy_(ref))
    A = torch.eye(6, device=dev) * 2.0 + 0.1
    b = torch.ones(6, device=dev)
    out["solve_ex_ms"] = time_ms(torch, lambda: torch.linalg.solve_ex(A, b))
    # the sharded iteration's plain version on the card: the step on the
    # fast app's problem's first rows, then the next statistics
    prob = probs["packed"]._replace(coarse_iterations=0, split=False)
    src = torch.zeros(treg.CARRY_LEN, device=dev)
    treg.init_state(prob, poses[0], dev, out=src[:treg.STATE_LEN])
    src[treg.PENDING] = 1.0
    rows = treg.reg_stats_plain(src[:treg.STATE_LEN], prob, {})
    dst = torch.zeros_like(src)
    row = torch.zeros_like(rows)
    out["fused_plain_ms"] = time_ms(torch, lambda: treg.fused_iteration_plain(
        src, dst, rows, row, prob, {}), reps=5)
    log("[time plain]", json.dumps(out))
    return out


def check_shard_loops(torch, probs, poses) -> dict:
    """SHARDLOOP (a): the sharded loop at a world of one (no group) from
    each of REGLOOP's starts, traced, on a fresh mesh: its first
    registration launched from the host, the second from its captured
    chunk, each against the loop kernel's traced registration from the
    same start: end state, header and every trace row equal to the bit;
    its synchronizing operations (the header reads:
    ``shard_reads(iterations)``), its kernel's launches (CHUNK a read: one
    an iteration) and, from the graph, one replay a read and one
    capture."""
    from warpsense_tpu_torch.kernels import registration as kreg
    from warpsense_tpu_torch.ops import registration as treg
    from warpsense_tpu_torch.parallel.sharded import (
        make_mesh, run_registration_sharded)
    report = {}
    for name, prob in probs.items():
        runs, where = [], {}
        for j, pose in enumerate(poses):
            st, head, trace, _ = loop_traced(torch, prob, pose)
            n = int(head[treg.S_I])
            mesh = make_mesh(pose.device)
            for replayed in (False, True):
                strace = torch.zeros_like(trace)
                before = (kreg.shard_iter.launches, kreg.shard_iter.replays,
                          kreg.shard_iter.captures)
                (sst, shead), syncs = count_syncs(
                    torch, lambda: run_registration_sharded(
                        prob, pose, mesh, trace=strace), where)
                runs.append(dict(
                    pose=j, replayed=replayed, iterations=n,
                    shard_iterations=int(shead[treg.S_I]),
                    bit_equal=bool(torch.equal(sst, st) and shead == head
                                   and torch.equal(strace, trace)),
                    syncs=syncs, reads=treg.shard_reads(n),
                    launches=kreg.shard_iter.launches - before[0],
                    replays=kreg.shard_iter.replays - before[1],
                    captures=kreg.shard_iter.captures - before[2]))
        report[name] = runs
        log(f"[SHARDLOOP {name}]", json.dumps(dict(runs=runs,
                                                   syncs_at=where)))
        for r in runs:
            if not r["bit_equal"]:
                raise AssertionError(f"the sharded loop at a world of one "
                                     f"is not the loop kernel's ({name}): "
                                     f"{r}")
            if r["syncs"] != r["reads"] or r["launches"] != \
                    r["reads"] * treg.CHUNK or r["replays"] != (
                        r["reads"] if r["replayed"] else 0):
                raise AssertionError(f"the sharded loop did not read its "
                                     f"header once a chunk of CHUNK "
                                     f"launches ({name}; at {where}): {r}")
            if r["captures"] != int(r["replayed"]):
                raise AssertionError(f"the chunk of {name} was not captured "
                                     f"once, at a mesh's second "
                                     f"registration: {r}")
    return report


def check_fused_kernel(torch, probs, poses) -> dict:
    """SHARDLOOP (b): shard_iter_kernel against its plain version
    (``fused_iteration_plain`` on the card, the same carry slot and rows)
    at the carries of the loop kernel's traced registration from the first
    start, its first FUSED_ITERATIONS iterations in order (so both gather
    their freeze caches at the same carries): the first with no rows
    pending (statistics only), then each traced carry with its traced rows
    pending (the step, then the next statistics), launched at parity 0
    and 1.  The new carry slot equal to the plain version's and to the
    next traced carry, to the bit; the slot and rows read unchanged (the
    double buffer); the rows' sum within REGLOOP["k3_rtol"] of the plain
    row, c equal.  Returns each problem's worst relative error and the
    carries that differ."""
    from warpsense_tpu_torch.kernels import registration as kreg
    from warpsense_tpu_torch.ops import registration as treg
    dev = poses[0].device
    out = {}
    for name, prob in probs.items():
        st, head, trace, _ = loop_traced(torch, prob, poses[0])
        n = min(int(head[treg.S_I]), FUSED_ITERATIONS)
        bufs = kreg.shard_buffers(dev, 1, shared=True)
        plan = kreg.shard_plan(bufs, prob)
        cache: dict = {}
        worst, differ, kept = 0.0, [], True
        for i in range(n):
            for parity in (0, 1):
                src = torch.zeros(treg.CARRY_LEN, device=dev)
                rows_in = torch.zeros((kreg.CLUSTER, treg.PARTIALS),
                                      device=dev)
                if i == 0:
                    src[:treg.STATE_LEN] = trace[0, :treg.STATE_LEN]
                else:
                    src[:treg.STATE_LEN] = trace[i - 1, :treg.STATE_LEN]
                    src[treg.PENDING] = 1.0
                    rows_in = trace[i - 1, treg.STATE_LEN:].reshape(
                        kreg.CLUSTER, treg.PARTIALS).clone()
                bufs.carry[parity].copy_(src)
                bufs.rows[parity].copy_(rows_in)
                bufs.carry[1 - parity].fill_(-1.0)
                kreg.shard_iter(plan, parity)
                want = torch.full((treg.CARRY_LEN,), -1.0, device=dev)
                row = torch.zeros((1, treg.PARTIALS), device=dev)
                treg.fused_iteration_plain(src.clone(), want, rows_in, row,
                                           prob, cache)
                torch.cuda.synchronize()
                got = bufs.carry[1 - parity]
                kept = kept and bool(torch.equal(bufs.carry[parity], src)
                                     and torch.equal(bufs.rows[parity],
                                                     rows_in))
                if not (torch.equal(got[:treg.PENDING + 1],
                                    want[:treg.PENDING + 1])
                        and torch.equal(got[:treg.STATE_LEN],
                                        trace[i, :treg.STATE_LEN])):
                    differ.append((i, parity))
                g = treg.sum_partials(bufs.rows[1 - parity]).double()
                w = row[0].double()
                if g[28] != w[28]:
                    differ.append((i, parity, "c"))
                for lo, hi in ((0, 21), (21, 27), (27, 28)):
                    worst = max(worst, float(
                        (g[lo:hi] - w[lo:hi]).abs().max()
                        / max(float(w[lo:hi].abs().max()), 1e-30)))
        out[name] = dict(iterations=n, max_rel_err=worst, differ=differ,
                         double_buffer_kept=kept)
        log(f"[fused kernel {name}]", json.dumps(out[name]))
        if differ or not kept or worst > REGLOOP["k3_rtol"]:
            raise AssertionError(f"shard_iter_kernel differs from its "
                                 f"plain version ({name}): {out[name]}")
    return out


def time_shard_loops(torch, probs, poses) -> dict:
    """SHARDLOOP (c): time_loops' problems through the sharded loop at a
    world of one (no group) from the first pose: one registration between
    CUDA events from its captured chunk (``ms``) and, launched from the
    host, a fresh mesh's first one (``ms_eager``: its buffers made, then
    the host loop), the host clock of one after a sync, median of 11
    (``host_ms``, ``host_ms_eager``), and the device time of
    shard_iter_kernel (torch.profiler over the graph's replays), per
    registration and per iteration (every launch of the registration,
    those after the carry finished included), beside the bound of the
    same work: ``loop_cost`` of its trace with CLUSTER rows an iteration
    plus the carry's trips through device memory (the state and its
    PENDING flag read and written once an iteration) and the rows'
    (written, then read).  On the fast app's problem also the operators
    of one registration's host time (torch.profiler)."""
    from warpsense_tpu_torch.kernels.registration import CLUSTER
    from warpsense_tpu_torch.ops import registration as treg
    from warpsense_tpu_torch.parallel.sharded import (
        make_mesh, run_registration_sharded)
    dev = poses[0].device
    mesh = make_mesh(dev)
    timed = dict(packed_app=probs["packed"]._replace(coarse_iterations=0),
                 **probs)
    name_k = "shard_iter_kernel"
    out = {}
    for name, prob in timed.items():
        trace = torch.zeros((prob.max_iterations,
                             treg.trace_width(CLUSTER)), device=dev)
        st, head = run_registration_sharded(prob, poses[0], mesh,
                                            trace=trace)
        n = int(head[treg.S_I])
        launches = treg.shard_reads(n) * treg.CHUNK

        def reg():
            return run_registration_sharded(prob, poses[0], mesh)

        def reg_eager():
            return run_registration_sharded(prob, poses[0], make_mesh(dev))
        stats = trace_stats(prob, trace, n)
        ms = time_ms(torch, reg)
        ms_eager = time_ms(torch, reg_eager)
        host = {}
        for key, fn in (("graph", reg), ("eager", reg_eager)):
            t = []
            for _ in range(11):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                t.append((time.perf_counter() - t0) * 1e3)
            host[key] = sorted(t)[5]
        us = kernel_device_us(torch, reg, (name_k,), reps=20)
        row_bytes = CLUSTER * treg.PARTIALS * 4
        nbytes, ops = loop_cost(prob, stats["mode_by_iteration"],
                                stats["valid"], rows=CLUSTER,
                                iteration_bytes=2 * 4 * (treg.STATE_LEN + 1)
                                + 2 * row_bytes)
        dev_ms = us[name_k] * launches / 1e3
        t = dict(iterations=n, launches=launches, ms=ms, ms_eager=ms_eager,
                 host_ms=host["graph"], host_ms_eager=host["eager"],
                 device_ms=dev_ms, device_us_per_launch=us[name_k],
                 **bound(nbytes, ops, dev_ms))
        for key in ("ms", "device_ms", "bound_ms"):
            t[f"{key}_per_iteration"] = t[key] / max(n, 1)
        if name == "packed_app":
            from torch.profiler import ProfilerActivity, profile
            reg()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                reg()
                torch.cuda.synchronize()
            ops_ = sorted(prof.key_averages(),
                          key=lambda e: -e.cpu_time_total)
            t["host_profile"] = [dict(
                name=e.key[:60], count=e.count, host_us=e.cpu_time_total,
                device_us=getattr(e, "self_device_time_total", 0))
                for e in ops_[:12]]
        out[name] = t
        log(f"[time shard loop {name}]", json.dumps(t))
    return out


def kernel_device_us(torch, fn, names, reps=50) -> dict:
    """Mean device time (us) of each kernel whose name holds one of
    ``names``, over ``reps`` calls of ``fn`` under torch.profiler."""
    out = {}
    for e in profiled_kernels(torch, fn, reps):
        t = getattr(e, "self_device_time_total", 0)
        for n in names:
            if n in e.key and t > 0:
                out[n] = t / e.count
    missing = [n for n in names if n not in out]
    if missing:
        raise AssertionError(f"the profiler saw no {missing}")
    return out


def kernel_profile(torch, fn, names, reps=50) -> tuple[dict, dict]:
    """(mean device time in us of one launch, launches per call of ``fn``)
    of the kernels whose names hold each of ``names``, summed over every
    kernel that matches, over ``reps`` calls of ``fn`` under
    torch.profiler."""
    total = {n: 0.0 for n in names}
    count = {n: 0 for n in names}
    for e in profiled_kernels(torch, fn, reps):
        t = getattr(e, "self_device_time_total", 0)
        for n in names:
            if n in e.key and t > 0:
                total[n] += t
                count[n] += e.count
    missing = [n for n in names if not count[n]]
    if missing:
        raise AssertionError(f"the profiler saw no {missing}")
    return ({n: total[n] / count[n] for n in names},
            {n: count[n] / reps for n in names})


def profiled_kernels(torch, fn, reps):
    """torch.profiler's averages by name over ``reps`` calls of ``fn``
    (after one call outside the profile)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def run_regloop(torch, full_state, default_state, device) -> dict:
    """REGLOOP: (a)-(c) the loop kernel against the plain versions and
    the host loop, then (e)'s times; SHARDLOOP: the sharded loop at a
    world of one against the loop kernel, then its times.  Their own
    launches are not the main paths'."""
    probs = regloop_problems(torch, full_state, default_state, device)
    poses = [p.to(device) for p in regloop_poses(torch)]
    out = dict(loops=check_loops(torch, probs, poses),
               times=time_loops(torch, probs, poses),
               plain=time_plain(torch, probs, poses),
               shard_loops=check_shard_loops(torch, probs, poses),
               fused=check_fused_kernel(torch, probs, poses),
               shard_times=time_shard_loops(torch, probs, poses))
    runs = [r for rs in out["loops"].values() for r in rs]
    out["max_abs_err"] = dict(
        K3=max(max(r["H_rel"], r["g_rel"], r["e_rel"]) for r in runs),
        K4=max(r["step_max_abs_err"] for r in runs),
        fused=max(r["max_rel_err"] for r in out["fused"].values()))
    return out


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
    rep["registration"] = registration_report(
        launches, "tilt_app" if "pitch_deg" in cfg else "fast_app")
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
    from warpsense_tpu_torch.kernels.fields import fields_packed, fields_parity
    from warpsense_tpu_torch.kernels.fusion import (fusion_sweep_merge,
                                                    fusion_table)
    from warpsense_tpu_torch.kernels.preprocess import preprocess
    from warpsense_tpu_torch.kernels.registration import (reg_loop,
                                                          shard_iter)
    from warpsense_tpu_torch.ops.registration import \
        reset_registration_counts
    fusion_sweep_merge.launches = 0
    fusion_sweep_merge.general_launches = 0
    fusion_table.launches = 0
    preprocess.launches = 0
    fields_packed.launches = 0
    fields_packed.staged_copies = 0
    fields_parity.launches = 0
    fields_parity.staged_copies = 0
    reg_loop.launches = 0
    shard_iter.launches = 0
    shard_iter.replays = 0
    shard_iter.captures = 0
    reset_registration_counts()


def read_launches() -> dict:
    """K1's launches ("fusion", of which "fusion_general" ran the general
    sweep), the table step's ("fusion_table"), the preprocessing
    kernel's ("preprocess"), K2's ("fields", and its aligned copies
    "fields_staged"; its parity mode's "fields_parity" and "fields_parity_staged"), the loop
    kernel's ("reg_loop", which runs K3 and K4), the sharded loop's
    ("shard_iter": its fused K4 + K3 iteration, launched from the host or
    replayed in a captured chunk; "shard_replays" and "shard_captures"
    count the chunk's graphs), and the registrations' counts:
    registrations, their iterations, header reads (host syncs) and host
    seconds."""
    from warpsense_tpu_torch.kernels.fields import fields_packed, fields_parity
    from warpsense_tpu_torch.kernels.fusion import (fusion_sweep_merge,
                                                    fusion_table)
    from warpsense_tpu_torch.kernels.preprocess import preprocess
    from warpsense_tpu_torch.kernels.registration import (reg_loop,
                                                          shard_iter)
    from warpsense_tpu_torch.ops.registration import run_registration
    return {"fusion": fusion_sweep_merge.launches,
            "fusion_general": fusion_sweep_merge.general_launches,
            "fusion_table": fusion_table.launches,
            "preprocess": preprocess.launches,
            "fields": fields_packed.launches,
            "fields_staged": fields_packed.staged_copies,
            "fields_parity": fields_parity.launches,
            "fields_parity_staged": fields_parity.staged_copies,
            "reg_loop": reg_loop.launches,
            "shard_iter": shard_iter.launches,
            "shard_replays": shard_iter.replays,
            "shard_captures": shard_iter.captures,
            "registrations": run_registration.calls,
            "reg_iterations": run_registration.iterations,
            "reg_syncs": run_registration.syncs,
            "reg_seconds": run_registration.seconds}


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
    misses = app.eval.counters()["fields_cache_miss"]
    pose_err = [float(np.abs(p[:3, 3] - np.asarray(j)).max())
                for p, j in zip(poses, PARITY_JAX_MM)]
    rep = dict(window=list(app.local_map.size), scans=len(scans),
               scans_per_s=(len(scans) - cfg["warmup"]) / wall,
               stage_avg_ms={r["task"]: r["avg"] / 1000.0
                             for r in ev.to_rows()},
               stage_count={r["task"]: r["count"] for r in ev.to_rows()},
               window_pos=windows, pose_err_vs_jax_mm=pose_err,
               ate_m=ate_m(poses, gt), launches=launches,
               fields_cache_miss=misses,
               finite=bool(np.all(np.isfinite(np.stack(poses)))))
    app.terminate()
    rep["registration"] = registration_report(launches, "parity_app")
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
    if not launches["fields_parity"] == misses > 0:
        raise AssertionError(f"K2's parity mode not launched once a fields "
                             f"computation ({misses}): {launches}")
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


# ---------------------------------------------------------------- phase 9b
def run_offline(torch, device):
    """eval.pcd2tsdf and eval.pcd_registration through their CLIs at the
    defaults on the card, then the same calls with --device cpu in this
    process as the yardstick: pcd2tsdf's exact agreement with its host twin
    1.0, and every volume it builds the CPU's bit for bit; each
    registration case within its bound, in the CPU run's iterations and,
    where JAX recovers it, within OFFLINE["cpu_mm"] of the CPU run's
    average; one launch of K2's parity mode, one loop-kernel launch and
    one sync a registration on the card."""
    import contextlib
    import io

    import numpy as np

    from warpsense_tpu_torch.eval import pcd2tsdf, pcd_registration
    from warpsense_tpu_torch.ops import registration as treg
    volume, register = pcd2tsdf.tsdf_volume, treg.register_cloud
    volumes, cases, now = {}, {}, {}

    def kept(*a, **kw):
        state, ms = volume(*a, **kw)
        volumes.setdefault(now["dev"], []).append(state)
        return state, ms

    def counted(*a, **kw):
        before = read_launches()
        t0 = time.perf_counter()
        pose = register(*a, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        after = read_launches()
        cases.setdefault(now["dev"], []).append(dict(
            {k: after[k] - before[k] for k in (
                "fields_parity", "reg_loop", "registrations",
                "reg_iterations", "reg_syncs")},
            ms=ms))
        return pose

    out = {}
    pcd2tsdf.tsdf_volume, treg.register_cloud = kept, counted
    try:
        for dev in (str(device), "cpu"):
            now["dev"] = dev
            reset_launches()
            run = {}
            for name, mod in (("pcd2tsdf", pcd2tsdf),
                              ("pcd_registration", pcd_registration)):
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    run[name] = mod.main(["--device", dev])
                run[name + "_s"] = time.perf_counter() - t0
            if dev != "cpu":
                torch.cuda.synchronize()
                run["launches"] = read_launches()
            out[dev] = run
    finally:
        pcd2tsdf.tsdf_volume, treg.register_cloud = volume, register
    card, cpu = out[str(device)], out["cpu"]
    mismatches = [int((a.value.cpu() != b.value).sum()
                      + (a.weight.cpu() != b.weight).sum())
                  for a, b in zip(volumes[str(device)], volumes["cpu"])]
    reg = {}
    for i, name in enumerate(card["pcd_registration"]):
        got, want = card["pcd_registration"][name], cpu["pcd_registration"][
            name]
        jax = OFFLINE_JAX_AVG_MM[name]
        bound = (OFFLINE["idle_bound_mm"] if name == "idle" else max(
            OFFLINE["case_bound_mm"], 2 * jax))
        reg[name] = dict(avg_mm=got["avg"], cpu_avg_mm=want["avg"],
                         jax_avg_mm=jax, bound_mm=bound,
                         jax_recovers=2 * jax <= OFFLINE["case_bound_mm"],
                         max_mm=got["max"], **cases[str(device)][i],
                         cpu_ms=cases["cpu"][i]["ms"],
                         cpu_iterations=cases["cpu"][i]["reg_iterations"])
    launches = card["launches"]
    rep = dict(pcd2tsdf=dict(card=card["pcd2tsdf"], cpu=cpu["pcd2tsdf"],
                             volumes=len(mismatches),
                             volume_mismatches=mismatches,
                             seconds=card["pcd2tsdf_s"],
                             cpu_seconds=cpu["pcd2tsdf_s"]),
               pcd_registration=reg,
               pcd_registration_seconds=card["pcd_registration_s"],
               pcd_registration_cpu_seconds=cpu["pcd_registration_s"],
               launches=launches,
               registration=registration_report(launches, "offline"))
    log("[offline]", json.dumps(rep))
    p = rep["pcd2tsdf"]
    if not (p["card"]["exact_agreement"] == 1.0 == p["cpu"][
            "exact_agreement"] and len(mismatches) == 3
            and not any(mismatches)
            and p["card"]["touched_voxels_device"]
            == p["cpu"]["touched_voxels_device"] > 0):
        raise AssertionError(f"pcd2tsdf on the card: {p}")
    for name, c in reg.items():
        if not (np.isfinite(c["avg_mm"]) and c["avg_mm"] < c["bound_mm"]
                and c["reg_iterations"] == c["cpu_iterations"]
                and (abs(c["avg_mm"] - c["cpu_avg_mm"]) <= OFFLINE["cpu_mm"]
                     or not c["jax_recovers"])
                and c["fields_parity"] == c["reg_loop"]
                == c["registrations"] == c["reg_syncs"] == 1):
            raise AssertionError(f"pcd_registration {name} on the card: {c}")
    if len(reg) != len(OFFLINE_JAX_AVG_MM):
        raise AssertionError(f"pcd_registration ran {list(reg)}")
    return rep


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


# ---------------------------------------------------------------- phase 11
def fastsense_imu(gt):
    """Each scan's orientation IMU sample: the sensor's rotation in the
    first sensor's frame as an (x, y, z, w) quaternion."""
    from warpsense_tpu_torch.io.trajectory import _quat_from_mat
    return [_quat_from_mat(gt[0][:3, :3].T @ p[:3, :3]) for p in gt]


def fastsense_run(torch, cfg, params, gt, scans, device, *, replay,
                  on_scan=None):
    """One FastsenseApp run through its callbacks, profiled (its spans,
    each published update's steps, ``FastsenseApp.update_ms``, and each
    scan's GN iterations): with ``replay``, ``sync()`` after each scan.
    Returns (app after terminate, poses, the report's fields)."""
    import numpy as np

    from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator
    from warpsense_tpu_torch.pipeline.fastsense import FastsenseApp
    from warpsense_tpu_torch.utils.imu import ImuSample
    app = FastsenseApp(params, in_memory_map=True, capacity=cfg["capacity"],
                       update_frequency=cfg["update_frequency"],
                       update_distance_m=cfg["update_distance_m"],
                       device=device, profile=True)
    ev = RuntimeEvaluator.get_instance()
    ev.clear()
    poses = []
    reset_launches()
    for i, (scan, q) in enumerate(zip(scans, fastsense_imu(gt))):
        if i == cfg["warmup"]:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        app.imu_callback(ImuSample(0.1 * i - 1e-3, np.zeros(3), q))
        poses.append(app.cloud_callback(scan, 0.1 * i))
        if on_scan is not None:
            on_scan(i, app)
        if replay:
            app.sync()
    wall = time.perf_counter() - t_start
    t0 = time.perf_counter()
    app.terminate()
    torch.cuda.synchronize()
    launches = read_launches()
    rep = dict(scans=len(scans), scans_per_s=(len(scans) - cfg["warmup"])
               / wall, terminate_s=time.perf_counter() - t0,
               jobs=app._jobs_submitted, published=app.updates_published,
               launches=launches, ate_m=ate_m(poses, gt),
               registration=registration_report(
                   launches, "fastsense_replay" if replay
                   else "fastsense_async"),
               finite=bool(np.all(np.isfinite(np.stack(poses)))),
               gn_iterations=app.gn_iterations,
               stage_avg_ms={r["task"]: r["avg"] / 1000.0
                             for r in ev.to_rows()},
               update_avg_ms={
                   k: float(np.mean([u[k] for u in app.update_ms if k in u]))
                   for k in ("shift", "clone", "fusion", "fields")
                   if any(k in u for u in app.update_ms)},
               update_ms=app.update_ms)
    return app, poses, rep


def fastsense_held(torch, cfg, params, device):
    """FastsenseApp without ``sync()`` on a scan from the walk's start and
    then ``held_scans`` scans from one pose half a voxel from it on each
    axis, the gate every second scan: every worker update fuses without a
    voxel move, so it fuses a clone of the published state while the
    caller registers.  A snapshot of the published (state, fields) pair
    is taken after each scan and compared at the end."""
    import numpy as np

    from warpsense_tpu_torch.io.synthetic import (BoxWorld, render_scan,
                                                  walk_trajectory)
    from warpsense_tpu_torch.pipeline.fastsense import FastsenseApp
    from warpsense_tpu_torch.utils.imu import ImuSample
    start = walk_trajectory(1, step_m=cfg["step_m"])[0]
    held = start.copy()
    held[:3, 3] += start[:3, :3] @ np.full(3, params.map.resolution / 2000.0)
    rng = np.random.default_rng(5)
    app = FastsenseApp(params, in_memory_map=True, capacity=cfg["capacity"],
                       update_frequency=2,
                       update_distance_m=cfg["update_distance_m"],
                       device=device, profile=True)
    snaps = []
    for i, pose in enumerate([start] + [held] * cfg["held_scans"]):
        scan = render_scan(BoxWorld.default(), pose, channels=cfg["channels"],
                           columns=cfg["columns"], noise_std=cfg["noise"],
                           rng=rng)
        app.imu_callback(ImuSample(0.1 * i - 1e-3, np.zeros(3),
                                   np.array([0.0, 0.0, 0.0, 1.0])))
        app.cloud_callback(scan, 0.1 * i)
        with app._snap_lock:
            pair = (*app.state, *app._fields)
        if not snaps or pair[0] is not snaps[-1][0][0]:   # a new snapshot
            snaps.append((pair, [t.clone() for t in pair]))
    app.terminate()
    torch.cuda.synchronize()
    return dict(
        scans=cfg["held_scans"] + 1, snapshots=len(snaps),
        jobs=app._jobs_submitted, published=app.updates_published,
        clones=sum("clone" in u for u in app.update_ms),
        shifts=sum("shift" in u for u in app.update_ms),
        snapshots_unchanged=all(torch.equal(a, b) for pair, copy in snaps
                                for a, b in zip(pair, copy)),
        map_moved_on=not torch.equal(snaps[0][0][1], snaps[-1][0][1]),
        update_ms=app.update_ms)


def run_fastsense(torch, cfg, device):
    """FastsenseApp at the default config: the deterministic replay (ATE
    against the JAX app's, every fusion one launch of K1's general sweep,
    a snapshot taken before the first worker update unchanged after the
    last), then the same scans without ``sync()``."""
    params = default_params()
    if params.registration.mode != "parity":
        raise AssertionError("configs/default.yaml is not in parity mode")
    gt, scans = app_scans(cfg)
    snap = {}

    def take(i, app):
        if i == 0:                 # before any worker job was submitted
            with app._snap_lock:
                pair = (*app.state, *app._fields)
            snap.update(pair=pair, copy=[t.clone() for t in pair],
                        published=app.updates_published)
    app, poses, rep = fastsense_run(torch, cfg, params, gt, scans, device,
                                    replay=True, on_scan=take)
    rep["snapshot_unchanged"] = all(
        torch.equal(a, b) for a, b in zip(snap["pair"], snap["copy"]))
    rep["snapshot_published_after"] = rep["published"] - snap["published"]
    rep["jax_ate_m"] = FASTSENSE_JAX_ATE_M
    del snap, app
    torch.cuda.empty_cache()
    _, async_poses, async_rep = fastsense_run(torch, cfg, params, gt, scans,
                                              device, replay=False)
    rep["async"] = async_rep
    torch.cuda.empty_cache()
    rep["held"] = held = fastsense_held(torch, cfg, params, device)
    torch.cuda.empty_cache()
    log("[fastsense]", json.dumps(rep))
    launches = rep["launches"]
    if not (rep["finite"] and async_rep["finite"]):
        raise AssertionError("non-finite fastsense pose")
    if not rep["ate_m"] <= 2 * FASTSENSE_JAX_ATE_M:
        raise AssertionError(f"fastsense ATE {rep['ate_m']:.4f} m > twice "
                             f"JAX's {FASTSENSE_JAX_ATE_M} m")
    if not (launches["fusion"] == launches["fusion_general"]
            == rep["published"] == rep["jobs"] + 1):
        raise AssertionError(f"fastsense fusions are not one general K1 "
                             f"launch per published update: {rep}")
    if rep["jobs"] < 2 or rep["snapshot_published_after"] < 2:
        raise AssertionError(f"too few worker updates: {rep}")
    if not rep["snapshot_unchanged"]:
        raise AssertionError("a published snapshot changed after a later "
                             "update")
    if async_rep["published"] != async_rep["jobs"] + 1:
        raise AssertionError(f"async fastsense left jobs unpublished: "
                             f"{async_rep}")
    if not (async_rep["launches"]["fusion_general"]
            == async_rep["launches"]["fields_parity"]
            == async_rep["published"]):
        raise AssertionError(f"async fastsense launches: {async_rep}")
    if launches["fields_parity"] != rep["published"]:
        raise AssertionError(f"fastsense fields are not one launch of K2's "
                             f"parity mode per published update: {rep}")
    if not (held["published"] == held["jobs"] + 1
            == held["clones"] + 1 == cfg["held_scans"] // 2 + 1):
        raise AssertionError(f"held fastsense updates were not each one "
                             f"clone without a shift: {held}")
    if not (held["snapshots"] >= 2 and held["snapshots_unchanged"]
            and held["map_moved_on"]):
        raise AssertionError(f"a published snapshot changed after a later "
                             f"update without a voxel move: {held}")
    return rep


# ---------------------------------------------------------------- phase 12
def run_slam_eval(torch, device):
    """eval.slam_eval in-process: the warpsense run (fast mode: K1 level
    and K2 on the card) and the featsense run, each ATE within twice the
    JAX CLI's on the same arguments."""
    from warpsense_tpu_torch.eval import slam_eval
    out = {}
    for name, args in SLAM_EVAL_ARGS.items():
        reset_launches()
        t0 = time.perf_counter()
        stats = slam_eval.main(args + ["--device", str(device),
                                       "--in-memory-map"])
        torch.cuda.synchronize()
        launches = read_launches()
        stats.update(seconds=time.perf_counter() - t0, launches=launches,
                     jax_ate_rmse_m=SLAM_EVAL_JAX_ATE_M[name],
                     registration=registration_report(
                         launches, f"slam_eval_{name}",
                         check=name == "warpsense"))
        out[name] = stats
        log(f"[slam_eval {name}]", json.dumps(stats))
        bound = 2 * SLAM_EVAL_JAX_ATE_M[name]
        if not stats["ate_rmse_m"] <= bound:
            raise AssertionError(f"slam_eval {name} ATE {stats['ate_rmse_m']}"
                                 f" m > {bound} m")
    launches = out["warpsense"]["launches"]
    if min(launches["fusion"], launches["fields"]) == 0:
        raise AssertionError(f"slam_eval warpsense did not launch K1 and K2: "
                             f"{launches}")
    if launches["fusion_general"] != 0:
        raise AssertionError(f"slam_eval's level walk ran the general sweep: "
                             f"{launches}")
    out["launches"] = {k: sum(r["launches"][k] for r in out.values())
                       for k in launches}
    return out


# ---------------------------------------------------------------- phase 13
def _snapshot_digest(snap) -> str:
    import numpy as np
    h = hashlib.sha256()
    for plane in snap:
        h.update(np.ascontiguousarray(plane).tobytes())
    return h.hexdigest()


def _publish_copy_s(size) -> float:
    """Host seconds of the copy ``LiveMonitor.publish_map`` makes of a
    gathered window of ``size`` (value and weight, int16), on this host."""
    import numpy as np
    plane = np.ones(size, np.int16)
    t0 = time.perf_counter()
    np.array(plane)
    np.array(plane)
    return time.perf_counter() - t0


def _monitored_run(torch, cfg, mesh, scans, period_s, single=False):
    """The sharded app on ``scans`` again, with a LiveMonitor of
    ``period_s`` on this rank: each map snapshot held to this rank's slab
    at its scan (its rows of the window, value and weight, and pos and
    offset, bit for bit) and digested, each gather timed on the host
    clock; the monitor's path and status.  The snapshot callback only
    keeps the snapshot and a device copy of the slab; the checks run after
    the scans, off the monitor's clock.  With ``single`` the single-GPU
    WarpsenseApp with the same monitor period steps beside it, scan by
    scan, and each of its snapshots must be the sharded app's."""
    import numpy as np

    from warpsense_tpu_torch.obs.live import LiveMonitor
    from warpsense_tpu_torch.pipeline import warpsense_sharded as ws
    from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp
    device = mesh.device
    lo, hi = ws.slab_rows(mesh, cfg["size"][0])
    gather, gather_ms = ws.gather_state, []

    def timed_gather(state, m):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = gather(state, m)          # host arrays: the work has ended
        gather_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    poses, kept, last = [], [], {}

    def on_map(snap):
        kept.append((len(poses), snap, [t.clone() for t in app.state]))
        last["sharded"] = snap

    def watched():
        mon = LiveMonitor(map_snapshot_period_s=period_s)
        mon.subscribe("map", on_map)
        return mon

    mon = watched()
    kw = dict(in_memory_map=True, capacity=cfg["capacity"],
              window_size=cfg["size"], sync_shift=True)
    ws.gather_state = timed_gather
    try:
        app = ws.ShardedWarpsenseApp(app_params(cfg), mesh=mesh, monitor=mon,
                                     **kw)
        if single:
            one_mon = LiveMonitor(map_snapshot_period_s=period_s)
            one_mon.subscribe("map", lambda s: last.__setitem__("one", s))
            one = WarpsenseApp(app_params(cfg), force_odd=False,
                               fusion="projective-level", device=device,
                               monitor=one_mon, **kw)
            single_poses, single_equal = [], []
        for i, scan in enumerate(scans):
            last.clear()
            poses.append(app.cloud_callback(scan, 0.1 * i))
            if single:
                single_poses.append(one.cloud_callback(scan, 0.1 * i))
                a, b = last.get("sharded"), last.get("one")
                single_equal.append(a is not None and b is not None and all(
                    np.array_equal(x, y.cpu().numpy()) for x, y in zip(a, b)))
        app.terminate()
    finally:
        ws.gather_state = gather
    snaps = []
    for scan, snap, own in kept:
        own = [t.cpu().numpy() for t in own]
        snaps.append(dict(
            scan=scan, shape=list(snap.value.shape),
            digest=_snapshot_digest(snap),
            own_rows_equal=bool(
                np.array_equal(snap.value[lo:hi], own[0])
                and np.array_equal(snap.weight[lo:hi], own[1])
                and np.array_equal(snap.pos, own[2])
                and np.array_equal(snap.offset, own[3]))))
    del kept[:]
    status = json.loads(mon.status_json())
    out = dict(period_s=period_s, snapshots=snaps, gather_ms=gather_ms,
               poses=np.stack(poses).tolist(),
               path_equal=len(mon.path) == len(poses) and all(
                   np.array_equal(p, q.astype(np.float64))
                   for (_, p), q in zip(mon.path, poses)),
               status={k: status.get(k) for k in (
                   "scans", "map_epoch", "shifts", "last_shift_pos")})
    if single:
        one.terminate()
        out.update(single_poses=np.stack(single_poses).tolist(),
                   single_snapshots_equal=single_equal,
                   single_status={k: json.loads(one_mon.status_json()).get(k)
                                  for k in out["status"]})
    return out


def _sharded_rank(rank, world, backend, store, out_dir, cfg):
    """One rank of the SHARDED phase (a spawned process)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from warpsense_tpu_torch.kernels.fields import fields_packed
    from warpsense_tpu_torch.kernels.registration import CLUSTER
    from warpsense_tpu_torch.map.local_map import LocalMapState, create_state
    from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator
    from warpsense_tpu_torch.ops import registration as treg
    from warpsense_tpu_torch.ops.preprocess import preprocess
    from warpsense_tpu_torch.ops.tsdf_projective import \
        tsdf_update_projective
    from warpsense_tpu_torch.parallel import sharded as sh
    from warpsense_tpu_torch.parallel.distributed import gather_state
    from warpsense_tpu_torch.pipeline.warpsense_sharded import \
        ShardedWarpsenseApp

    device = torch.device(cfg["device"])
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    # every registration of the app through the sharded loop: its
    # iterations and synchronizing operations (sync debug mode: the header
    # reads, and with gloo the rows' staging), and the last one's problem,
    # pretransform and end state
    run_loop = sh.run_registration_sharded
    regs, last, where = [], [], {}

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = run_loop(*a, **kw)
        return out, (time.perf_counter() - t0) * 1e3

    def counted(prob, pretransform, mesh, **kw):
        # host clock of the loop alone: count_syncs waits for the queued
        # work first
        ((state, head), ms), syncs = count_syncs(torch, lambda: timed(
            prob, pretransform, mesh, **kw), where) if cuda else (
            timed(prob, pretransform, mesh, **kw), 0)
        regs.append(dict(iterations=int(head[treg.S_I]), syncs=syncs,
                         ms=ms))
        last[:] = [prob, pretransform, state]
        return state, head
    sh.run_registration_sharded = counted
    if backend == "nccl":
        # NCCL creates its communicator at the group's first collective
        # (with host syncs): set-up, before the app
        dist.all_reduce(torch.zeros(1, device=device))
        sync()
    try:
        mesh = sh.make_mesh(device)
        _, scans = app_scans(cfg)
        params = app_params(cfg)
        app = ShardedWarpsenseApp(params, mesh=mesh, in_memory_map=True,
                                  capacity=cfg["capacity"],
                                  window_size=cfg["size"], sync_shift=True,
                                  profile=True)
        fused = []
        update = app._update_tsdf

        def counted(*a, **k):
            fused.append(len(poses))
            return update(*a, **k)
        app._update_tsdf = counted
        ev = RuntimeEvaluator.get_instance()
        ev.clear()
        poses, scan_ms = [], []
        reset_launches()
        for i, scan in enumerate(scans):
            t0 = time.perf_counter()
            poses.append(app.cloud_callback(scan, 0.1 * i))
            sync()
            scan_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        sh.run_registration_sharded = run_loop
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        stages = {r["task"]: r["avg"] / 1000.0 for r in ev.to_rows()}
        out = dict(rank=rank, world=world, backend=backend,
                   poses=np.stack(poses).tolist(), scan_ms=scan_ms,
                   fused_scans=fused, launches=launches,
                   registrations=regs, syncs_at=where,
                   stage_avg_ms=stages, peak_bytes=peak,
                   slab=list(sh.slab_rows(mesh, cfg["size"][0])),
                   window_pos=app.state.pos.cpu().tolist())
        # the last registration again, traced: every step replayed by the
        # plain step, the end state the app's, the trace's digest (equal
        # on every rank)
        prob, pretransform, app_state = last
        trace = torch.zeros((prob.max_iterations, treg.trace_width(
            world * (CLUSTER if cuda else 1))), device=device)
        st, head = run_loop(prob, pretransform, mesh, trace=trace)
        _, differ, tests, err = treg.replay_trace(trace, st, prob)
        # this rank's rows of each traced iteration (shard_iter_kernel on
        # its slab) against reg_stats_plain on the slab
        k = CLUSTER if cuda else 1
        stats = trace_stats(prob, trace, int(head[treg.S_I]),
                            slice(rank * k, (rank + 1) * k))
        out["traced"] = dict(
            iterations=int(head[treg.S_I]), steps_replayed=len(tests),
            steps_differ=differ, max_abs_err=err,
            slab=list(treg.slab_of(prob)), stats_modes=stats["modes"],
            stats_valid=stats["valid"], stats_bad=stats["bad"],
            stats_max_rel_err=max(stats[key] for key in (
                "H_rel", "g_rel", "e_rel")),
            equal_to_app=bool(torch.equal(st, app_state)),
            digest=hashlib.sha256(trace.cpu().numpy().tobytes()
                                  + st.cpu().numpy().tobytes()).hexdigest())
        del trace, st
        # the last registration's host clock repeated (after a sync, no
        # sync debug mode), and where one registration's host time goes
        # (torch.profiler: each operator's host and device time)
        ms = []
        for _ in range(11):
            sync()
            t0 = time.perf_counter()
            run_loop(prob, pretransform, mesh)
            ms.append((time.perf_counter() - t0) * 1e3)
        out["loop_ms_repeated"] = sorted(ms)[5]
        if cuda:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_loop(prob, pretransform, mesh)
                sync()
            ops = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)
            out["loop_profile"] = [dict(
                name=e.key[:60], count=e.count,
                host_us=e.cpu_time_total,
                device_us=getattr(e, "self_device_time_total", 0))
                for e in ops[:10]]
        del last[:]
        # the same scans with a live monitor, after the counts were read:
        # with ``single_app`` (the NCCL rank) at a period of 0 beside the
        # single-GPU app at the same window and settings, in this process;
        # else at monitor_period_scans of this rank's median scan after
        # the monitor's own copy of a snapshot (the clock runs on through
        # it)
        single = bool(cfg.get("single_app"))
        period = 0.0 if single else (
            cfg["monitor_period_scans"] * float(np.median(scan_ms)) / 1e3
            + _publish_copy_s(cfg["size"]))
        out["monitor"] = _monitored_run(torch, cfg, mesh, scans, period,
                                        single=single)
        if single:
            out["single_poses"] = out["monitor"].pop("single_poses")
        if world > 1:
            # the sharded fields of the app's map, gathered, against
            # the single-GPU kernel on the gathered window
            f = sh.precompute_fields_packed_sharded(app.state, mesh=mesh,
                                                    tau=600)
            planes = sh.gather_rows(f.plane, mesh)
            full = gather_state(app.state, mesh)
            del f
            if rank == 0:
                whole = LocalMapState(
                    *(torch.as_tensor(x, device=device) for x in full))
                one = fields_packed(whole, tau=600).plane.cpu()
                out["fields_mismatches"] = int((one != planes).sum())
                out["fields_weighted_voxels"] = int(
                    (whole.weight != 0).sum())
                del whole, one
            del planes, full
            # one fusion of the first scan from a fresh window, gathered,
            # against the single-GPU K1 fusion of the same scan
            cloud = torch.as_tensor(
                scans[0].reshape(-1, 3)[:cfg["capacity"]], device=device)
            valid = torch.any(cloud != 0, dim=1)
            pts, mask = preprocess(cloud, valid, torch.eye(4),
                                   resolution=cfg["res"],
                                   capacity=cfg["capacity"], snap=False)
            kw = dict(size=cfg["size"], tau=600, max_weight=32 * 64,
                      resolution=cfg["res"], channels=cfg["channels"],
                      columns=cfg["columns"], vfov_deg=45.0, level=True)
            zero = torch.zeros(3, dtype=torch.int32, device=device)
            fresh = create_state(cfg["size"], 600, 0, force_odd=False)
            st = sh.tsdf_update_projective_sharded(
                sh.shard_state(fresh, mesh), pts, mask, zero,
                torch.eye(3), mesh=mesh, **kw)
            full = gather_state(st, mesh)
            if rank == 0:
                one = tsdf_update_projective(
                    LocalMapState(*(torch.as_tensor(x, device=device)
                                    for x in fresh)),
                    pts, mask, zero, torch.eye(3), **kw)
                out["fusion_mismatches"] = int(
                    (one.value.cpu().numpy() != full.value).sum()
                    + (one.weight.cpu().numpy() != full.weight).sum())
                out["fusion_weighted_voxels"] = int(
                    (full.weight != 0).sum())
                del one
            del st, full
            # the gloo staging on one card: the halo exchange of one
            # padded slab (4 planes through host memory) and one
            # iteration's all-gather of the rows (CLUSTER rows of 32
            # floats a rank, through host memory), host clock after a sync
            from warpsense_tpu_torch.kernels.registration import \
                shard_buffers
            halo, stats = [], []
            bufs = shard_buffers(device, world)
            bufs.rows.fill_(1.0)
            rows_gather = sh.rows_gather(mesh, bufs)

            def gather():
                rows_gather(0)
            for _ in range(7):
                sync()
                t0 = time.perf_counter()
                sh._padded(app.state, mesh)
                sync()
                halo.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                gather()
                sync()
                stats.append((time.perf_counter() - t0) * 1e3)
            out["halo_ms"] = sorted(halo)[3]
            out["rows_gather_ms"] = sorted(stats)[3]
        app.terminate()
        with open(Path(out_dir) / f"sharded_{backend}_{rank}.json",
                  "w") as fh:
            json.dump(out, fh)
    finally:
        sh.run_registration_sharded = run_loop
        dist.destroy_process_group()


def _spawn_ranks(world, backend, cfg, out_dir):
    """Run ``_sharded_rank`` on ``world`` spawned processes on the card;
    returns their reports in rank order.  The ranks are killed if they
    do not finish within the phase's timeout."""
    import torch.multiprocessing as mp
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / f"sharded_{backend}.store"
    if store.exists():
        store.unlink()
    ctx = mp.start_processes(
        _sharded_rank, args=(world, backend, str(store), str(out_dir), cfg),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + cfg["join_timeout_s"]
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} {backend} ranks did not finish "
                                   f"in {cfg['join_timeout_s']} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    reps = []
    for r in range(world):
        with open(out_dir / f"sharded_{backend}_{r}.json") as fh:
            reps.append(json.load(fh))
    return reps


def shard_registration_report(rank: dict, name: str) -> dict:
    """One rank's ``[registration sharded]`` report: its registrations,
    their iterations, the sharded loop's kernel launches (one an
    iteration of each chunk), its captured chunk's replays and captures,
    header reads and loop time, each per registration, and the
    synchronizing operations of each registration (sync debug mode)."""
    la = rank["launches"]
    n = la["registrations"]
    rep = dict(rank=rank["rank"], backend=rank["backend"], registrations=n,
               iterations=la["reg_iterations"],
               shard_iter_launches=la["shard_iter"],
               graph_replays=la["shard_replays"],
               graph_captures=la["shard_captures"],
               header_reads=la["reg_syncs"], loop_kernel_launches=la[
                   "reg_loop"],
               syncs_by_registration=[r["syncs"] for r in
                                      rank["registrations"]],
               syncs_at=rank["syncs_at"],
               ms_by_registration=[r["ms"] for r in rank["registrations"]],
               loop_ms_repeated=rank["loop_ms_repeated"],
               loop_profile=rank.get("loop_profile"))
    if n:
        rep.update(iterations_per_registration=rep["iterations"] / n,
                   header_reads_per_registration=rep["header_reads"] / n,
                   launches_per_iteration=rep["shard_iter_launches"]
                   / max(rep["iterations"], 1),
                   loop_ms_per_registration=la["reg_seconds"] * 1e3 / n)
    log(f"[registration {name}]", json.dumps(rep))
    return rep


def check_sharded_rank(rank: dict, rep: dict) -> None:
    """Every registration of the rank ran the sharded loop's kernel: CHUNK
    launches a header read (one an iteration of each chunk), its header
    read ``shard_reads(iterations)`` times, no loop kernel; over NCCL the
    first registration launched from the host, then the chunk captured
    once and replayed once a read for every later one; over gloo no
    graph; the traced registration repeats the app's last and every step
    is the plain step's."""
    from warpsense_tpu_torch.ops.registration import CHUNK, shard_reads
    n = rep["registrations"]
    regs = rank["registrations"]
    reads = [shard_reads(r["iterations"]) for r in regs]
    graphs = ((1, sum(reads[1:])) if rank["backend"] == "nccl" and n > 1
              else (0, 0))
    if not (n > 0 and n == len(regs)
            and rep["shard_iter_launches"] == CHUNK * rep["header_reads"]
            and rep["header_reads"] == sum(reads)
            and (rep["graph_captures"], rep["graph_replays"]) == graphs
            and rep["loop_kernel_launches"] == 0):
        raise AssertionError(f"rank {rank['rank']} ({rank['backend']}): "
                             f"the sharded loop's kernel was not launched "
                             f"CHUNK times a header read, or its chunk not "
                             f"captured and replayed as planned: {rep}")
    t = rank["traced"]
    if t["steps_differ"] or t["steps_replayed"] != t["iterations"] \
            or not t["equal_to_app"]:
        raise AssertionError(f"rank {rank['rank']} ({rank['backend']}): "
                             f"a traced sharded step differs from the "
                             f"plain step, or the traced run from the "
                             f"app's: {t}")
    if t["stats_bad"] or len(t["stats_valid"]) != t["iterations"]:
        raise AssertionError(f"rank {rank['rank']} ({rank['backend']}): "
                             f"the statistics of its slab {t['slab']} "
                             f"differ from reg_stats_plain's (c equal, H / "
                             f"g / e within {REGLOOP['k3_rtol']}): {t}")


def run_sharded(torch, cfg):
    """ShardedWarpsenseApp over two gloo ranks on the card, then an NCCL
    group of one rank beside the single-GPU app, on APP's scans."""
    import numpy as np

    from warpsense_tpu_torch.ops.registration import shard_reads
    out_dir = ROOT / "chiprun_out" / "sharded"
    ranks = _spawn_ranks(cfg["world"], cfg["backend"], cfg, out_dir)
    gt, _ = app_scans(cfg)
    poses = [np.asarray(r["poses"], np.float32) for r in ranks]
    equal = all(np.array_equal(poses[0], p) for p in poses[1:])
    rep = dict(
        world=cfg["world"], backend=cfg["backend"], size=cfg["size"],
        ranks=[{k: r[k] for k in (
            "rank", "slab", "launches", "fused_scans", "scan_ms",
            "stage_avg_ms", "peak_bytes", "window_pos", "halo_ms",
            "rows_gather_ms", "traced")} for r in ranks],
        poses_equal_every_scan=equal,
        traces_equal=len({r["traced"]["digest"] for r in ranks}) == 1,
        ate_m=ate_m(poses[0], gt),
        fusion_mismatches=ranks[0]["fusion_mismatches"],
        fusion_weighted_voxels=ranks[0]["fusion_weighted_voxels"],
        fields_mismatches=ranks[0]["fields_mismatches"],
        fields_weighted_voxels=ranks[0]["fields_weighted_voxels"])
    log("[sharded]", json.dumps(rep))
    reg_reps = [shard_registration_report(r, "sharded") for r in ranks]
    nccl = _spawn_ranks(1, "nccl", dict(cfg, single_app=True), out_dir)[0]
    nccl_poses = np.asarray(nccl["poses"], np.float32)
    nccl_rep = {k: nccl[k] for k in (
        "world", "backend", "launches", "fused_scans", "scan_ms",
        "stage_avg_ms", "peak_bytes", "traced")}
    nccl_rep.update(
        single_app_equal=bool(np.array_equal(
            nccl_poses, np.asarray(nccl["single_poses"], np.float32))),
        ate_m=ate_m(nccl_poses, gt))
    log("[sharded nccl]", json.dumps(nccl_rep))
    nccl_reg = shard_registration_report(nccl, "sharded_nccl")
    if not equal or not rep["traces_equal"]:
        raise AssertionError("the ranks' poses or traced registrations "
                             "differ")
    for r, rr in zip(ranks + [nccl], reg_reps + [nccl_reg]):
        check_sharded_rank(r, rr)
    if not nccl_rep["single_app_equal"]:
        raise AssertionError("the NCCL rank of one is not the single-GPU "
                             "app's poses")
    over = [r for r in nccl["registrations"]
            if r["syncs"] > shard_reads(r["iterations"])]
    if over:
        raise AssertionError(f"an NCCL registration synchronized more than "
                             f"once a chunk: {over}")
    for a in (rep["ate_m"], nccl_rep["ate_m"]):
        if not a < cfg["ate_bound_m"]:
            raise AssertionError(f"sharded ATE {a:.4f} m >= "
                                 f"{cfg['ate_bound_m']} m")
    if rep["fusion_mismatches"] or rep["fields_mismatches"]:
        raise AssertionError(f"sharded K1/K2 differ from the single-GPU "
                             f"kernels: {rep}")
    if min(rep["fusion_weighted_voxels"], rep["fields_weighted_voxels"]) \
            < 100_000:
        raise AssertionError(f"the sharded checks fused too little: {rep}")
    for r in ranks + [nccl]:
        if r["launches"]["fusion"] != len(r["fused_scans"]) or not \
                r["fused_scans"] or r["launches"]["fields"] == 0:
            raise AssertionError(f"rank {r['rank']} ({r['backend']}): K1 "
                                 f"not launched once per fused scan, or "
                                 f"K2 not launched: {r['launches']}, fused "
                                 f"{r['fused_scans']}")
    if not np.all(np.isfinite(nccl_poses)):
        raise AssertionError("non-finite pose in the NCCL run")
    monitor = check_sharded_monitor(cfg, ranks, nccl)
    launches = {k: sum(r["launches"][k] for r in ranks) for k in
                ranks[0]["launches"]}
    return dict(rep, launches=launches, nccl_launches=nccl["launches"],
                registration=reg_reps, nccl=nccl_rep,
                nccl_registration=nccl_reg, monitor=monitor)


def check_sharded_monitor(cfg, ranks, nccl) -> dict:
    """The monitored runs: on every rank the unmonitored run's poses to the
    bit, the monitor's path those poses, every snapshot this rank's slab at
    its scan; the gloo ranks' snapshots (at least min_snapshots) and status
    equal, the NCCL rank's snapshot every scan the single-GPU app's."""
    import numpy as np
    reps = []
    for r in ranks + [nccl]:
        m = r["monitor"]
        snaps = m["snapshots"]
        rep = dict(rank=r["rank"], backend=r["backend"],
                   period_s=m["period_s"], snapshots=len(snaps),
                   snapshot_scans=[sn["scan"] for sn in snaps],
                   gather_ms=m["gather_ms"],
                   gather_ms_median=(float(np.median(m["gather_ms"]))
                                     if m["gather_ms"] else None),
                   status=m["status"],
                   poses_equal_unmonitored=bool(np.array_equal(
                       np.asarray(m["poses"], np.float32),
                       np.asarray(r["poses"], np.float32))),
                   path_equal=m["path_equal"],
                   own_rows_equal=all(sn["own_rows_equal"] for sn in snaps),
                   shape_ok=all(sn["shape"] == list(cfg["size"])
                                for sn in snaps))
        if "single_snapshots_equal" in m:
            rep.update(single_snapshots_equal=m["single_snapshots_equal"],
                       single_status=m["single_status"])
        reps.append(rep)
        log("[sharded monitor]", json.dumps(rep))
        if not (rep["poses_equal_unmonitored"] and rep["path_equal"]
                and rep["own_rows_equal"] and rep["shape_ok"] and snaps
                and rep["status"]["map_epoch"] == len(snaps)
                and rep["status"]["scans"] == len(r["poses"])
                and (rep["status"]["shifts"] or 0) >= 1):
            raise AssertionError(f"rank {r['rank']} ({r['backend']}): the "
                                 f"monitored run differs: {rep}")
    gloo, one = reps[:-1], reps[-1]
    digests = [[sn["digest"] for sn in r["monitor"]["snapshots"]]
               for r in ranks]
    if len(gloo[0]["snapshot_scans"]) < cfg["min_snapshots"] or any(
            d != digests[0] for d in digests) or any(
            g["status"] != gloo[0]["status"]
            or g["snapshot_scans"] != gloo[0]["snapshot_scans"]
            for g in gloo):
        raise AssertionError(f"the gloo ranks' monitors differ or took "
                             f"fewer than {cfg['min_snapshots']} snapshots: "
                             f"{gloo}")
    if not (one["snapshots"] == len(nccl["poses"])
            and len(one["single_snapshots_equal"]) == len(nccl["poses"])
            and all(one["single_snapshots_equal"])
            and one["single_status"] == one["status"]):
        raise AssertionError(f"the NCCL rank's snapshots are not the "
                             f"single-GPU app's: {one}")
    return dict(ranks=gloo, nccl=one)


# ---------------------------------------------------------------- phase 14
def run_device_query(torch):
    """utils.device_query with --bandwidth, one JSON line per card."""
    from warpsense_tpu_torch.utils import device_query
    infos = device_query.main(["--bandwidth"])
    if len(infos) != torch.cuda.device_count() or not all(
            i["copy_gbps"] > 0 for i in infos):
        raise AssertionError(f"device_query: {infos}")
    return infos


# ---------------------------------------------------------------- phase 15
def run_feature_compare(torch, device, cfg):
    """eval.feature_compare on the card on one synthetic scan: the device
    picks equal to the host twin's, and the F-LOAM counts."""
    from warpsense_tpu_torch.eval import feature_compare
    reset_launches()
    rep = feature_compare.run(
        feature_compare.synthetic_scan(cfg["channels"], cfg["columns"]),
        edge_capacity=cfg["edge_capacity"],
        surf_capacity=cfg["surf_capacity"], device=device)
    log("[feature_compare]", json.dumps(rep))
    # the float32 feature stage and its float64 host twin break a few
    # curvature near-ties apart: on this scan 15,027 surfs against the
    # twin's 15,026 (Jaccard 0.9991), on the card and on the CPU alike
    # (tools/feature_card_vs_cpu.py: no bit of curvature, range,
    # occlusion or pick differs between them); so the check holds the
    # stage to 1% of the twin
    for group in ("edges", "surfs"):
        g = rep[group]
        if g["device"] >= cfg[f"{group[:-1]}_capacity"] or not (
                abs(g["device"] - g["host"]) <= 0.01 * g["host"]
                and g["host"] > 0 and g["jaccard"] >= 0.99
                and g["floam"] > 0):
            raise AssertionError(f"feature_compare {group}: {g}")
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
    table = phase("fusion_table", check_fusion_table, torch, FULL, device)
    pre = phase("preprocess", check_preprocess, torch, device)
    k2 = phase("fields_check", check_fields_all, torch, state, FULL["tau"],
               device)
    k1_times = phase("fusion_times", time_fusion, torch, FULL, state,
                     ("level", "tilt"))
    k2_times = phase("fields_times", time_fields, torch, FULL, state)
    phase("fields_plain_times", time_fields_plain, torch, FULL, state,
          k2_times)
    torch.cuda.empty_cache()
    k2_parity = phase("fields_parity_times", time_fields_parity, torch,
                      device)
    default_cfg = default_fusion_cfg()
    state_default, k1_default = phase("fusion_check_default", check_fusion,
                                      torch, default_cfg, device)
    k1_times_default = phase("fusion_times_default", time_fusion, torch,
                             default_cfg, state_default, ("level", "tilt"))
    table_default = phase("fusion_table_default", check_fusion_table, torch,
                          default_cfg, device)
    torch.cuda.empty_cache()
    regloop = phase("regloop", run_regloop, torch, state, state_default,
                    device)
    del state, state_default
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
    offline = phase("offline", run_offline, torch, device)
    torch.cuda.empty_cache()
    feats = phase("featsense_app", run_featsense_app, torch, FEATSENSE,
                  device)
    torch.cuda.empty_cache()
    fast = phase("fastsense", run_fastsense, torch, FASTSENSE_APP, device)
    torch.cuda.empty_cache()
    evals = phase("slam_eval", run_slam_eval, torch, device)
    torch.cuda.empty_cache()
    sharded = phase("sharded", run_sharded, torch, SHARDED)
    phase("device_query", run_device_query, torch)
    phase("feature_compare", run_feature_compare, torch, device,
          FEATURE_COMPARE)
    paths = {"fast_app": app["launches"], "tilt_app": tilt["launches"],
             "parity_app": parity["launches"],
             "offline": offline["launches"],
             "featsense_app": feats["launches"],
             "fastsense": fast["launches"], "slam_eval": evals["launches"],
             "sharded": sharded["launches"],
             "sharded_nccl": sharded["nccl_launches"]}

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
    from warpsense_tpu_torch.kernels.registration import CLUSTER
    loop_times = regloop["times"]
    plain = regloop["plain"]
    app_loop = loop_times["packed_app"]

    shard_app = regloop["shard_times"]["packed_app"]

    def reg_entry(name, replaces, also, plain_ms, library_ms):
        """K3 or K4: both halves of one launch of the loop kernel, so both
        carry its time per iteration on the fast app's problem; on the
        sharded paths both are halves of shard_iter_kernel (its own
        entry), whose device time an iteration on the same problem at a
        world of one is beside."""
        t = app_loop
        key, kernel = "shard_iter", "shard_iter_kernel"
        return {"name": name, "route": "cuda",
                "source": "warpsense_tpu_torch/csrc/registration.cu",
                "launched_as": "loop_kernel", "cluster": CLUSTER,
                "replaces": replaces, "also_replaces": also,
                "launches": app["launches"]["reg_loop"],
                "iterations": app["launches"]["reg_iterations"],
                "launches_by_path": {k: v["reg_loop"]
                                     for k, v in paths.items()},
                "iterations_by_path": {k: v["reg_iterations"]
                                       for k, v in paths.items()},
                "max_abs_err": regloop["max_abs_err"][name[-2:]],
                "ms": t["ms_per_iteration"], "plain_ms": plain_ms,
                "bound_ms": t["bound_ms_per_iteration"],
                "bound_by": t["bound_by"],
                "share_of_bound": t["share_of_bound"],
                "library_ms": library_ms,
                "device_ms": t["device_ms_per_iteration"],
                "empty_cluster_loop_ms":
                    t["empty_cluster_device_ms_per_iteration"],
                "empty_kernel_ms": plain["empty_ms"],
                "ms_per_registration": t["ms"],
                "device_ms_per_registration": t["device_ms"],
                "sharded_launched_as": kernel,
                "sharded_launches_by_path": {
                    k: paths[k][key] for k in ("sharded", "sharded_nccl")},
                "sharded_device_us_per_launch": shard_app[
                    "device_us_per_launch"],
                "sharded_loop": {k: shard_app[k] for k in (
                    "iterations", "launches", "ms_per_iteration",
                    "device_ms_per_iteration", "bound_ms_per_iteration",
                    "bound_by")}}

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
        {"name": "fusion_table", "route": "cuda",
         "source": "warpsense_tpu_torch/csrc/fusion.cu",
         "launched_as": "ws_fusion_table: memset, bin_kernel, "
                        "prepare_kernel",
         "replaces": "none: XLA, warpsense_tpu/ops/tsdf_projective.py:"
                     + str(JAX_BEAM_TABLE_LINE),
         "launches": app["launches"]["fusion_table"],
         "launches_by_path": {k: v["fusion_table"]
                              for k, v in paths.items()},
         "max_abs_err": max(table["max_abs_err"],
                            table_default["max_abs_err"]),
         **entry(table["level"], "device_us_total", "host_ms",
                 "plain_host_ms", "launches_by_kernel"),
         "cases": {f"{k}_{w}": t[k] for w, t in (("full", table), (
             "default", table_default)) for k in ("level", "tilt")}},
        {"name": "preprocess", "route": "cuda",
         "source": "warpsense_tpu_torch/csrc/preprocess.cu",
         "launched_as": "preprocess_kernel",
         "replaces": "none: XLA, warpsense_tpu/ops/preprocess.py:"
                     + str(JAX_PREPROCESS_LINE),
         "launches": app["launches"]["preprocess"],
         "launches_by_path": {k: v["preprocess"] for k, v in paths.items()},
         "max_abs_err": pre["max_abs_err"],
         **entry(pre["fast"], "device_us", "host_ms", "plain_host_ms"),
         "cases": {k: pre[k] for k in ("fast", "parity")}},
        {"name": "fields_K2", "route": "cuda",
         "source": "warpsense_tpu_torch/csrc/fields.cu",
         "replaces": "warpsense_tpu/kernels/fields_pallas.py:79",
         "launches": app["launches"]["fields"],
         "launches_by_path": {k: v["fields"] for k, v in paths.items()},
         "max_abs_err": max(c["max_abs_err"] for c in k2),
         **k2_cases["packed_full"], "cases": k2_cases},
        {"name": "fields_K2_parity", "route": "cuda",
         "source": "warpsense_tpu_torch/csrc/fields.cu",
         "launched_as": "fields_kernel<kParity>",
         "replaces": "warpsense_tpu/ops/registration.py:81 (XLA)",
         "launches": parity["launches"]["fields_parity"],
         "launches_by_path": {k: v["fields_parity"]
                              for k, v in paths.items()},
         "max_abs_err": max(c["max_abs_err"] for c in k2
                            if "parity_mismatch" in c),
         **entry(k2_parity, "per_launch_ms", "copy_ms", "share_of_copy"),
         "size": k2_parity["size"]},
        dict(reg_entry("reg_stats_K3",
                       "warpsense_tpu/ops/registration.py:454",
                       ["warpsense_tpu/ops/registration.py:106",
                        "warpsense_tpu/ops/registration.py:512"],
                       plain["K3_plain_packed_ms"], None),
             loop=loop_times, shard_loop=regloop["shard_times"],
             # each SHARDED rank's traced rows on its own slab against
             # reg_stats_plain on that slab (relative, as max_abs_err)
             sharded_max_abs_err=max(
                 r["traced"]["stats_max_rel_err"]
                 for r in sharded["ranks"] + [sharded["nccl"]])),
        reg_entry("reg_step_K4", "warpsense_tpu/ops/registration.py:572",
                  ["warpsense_tpu/ops/registration.py:212"],
                  plain["K4_plain_ms"], plain["solve_ex_ms"]),
        {"name": "shard_iter_K4K3", "route": "cuda",
         "source": "warpsense_tpu_torch/csrc/registration.cu",
         "launched_as": "shard_iter_kernel",
         "replaces": "warpsense_tpu/parallel/sharded.py:397",
         "also_replaces": ["warpsense_tpu/parallel/sharded.py:145"],
         "launches": sum(paths[k]["shard_iter"]
                         for k in ("sharded", "sharded_nccl")),
         "launches_by_path": {k: paths[k]["shard_iter"]
                              for k in ("sharded", "sharded_nccl")},
         "graph_replays_by_path": {k: paths[k]["shard_replays"]
                                   for k in ("sharded", "sharded_nccl")},
         "graph_captures_by_path": {k: paths[k]["shard_captures"]
                                    for k in ("sharded", "sharded_nccl")},
         "max_abs_err": regloop["max_abs_err"]["fused"],
         "ms": shard_app["device_ms_per_iteration"],
         "plain_ms": plain["fused_plain_ms"],
         "bound_ms": shard_app["bound_ms_per_iteration"],
         "bound_by": shard_app["bound_by"],
         "share_of_bound": shard_app["share_of_bound"],
         "library_ms": None, "k4_library_ms": plain["solve_ex_ms"],
         "device_us_per_launch": shard_app["device_us_per_launch"],
         "ms_per_registration": shard_app["ms"],
         "ms_per_registration_eager": shard_app["ms_eager"],
         "host_ms_per_registration": shard_app["host_ms"],
         "host_ms_per_registration_eager": shard_app["host_ms_eager"],
         "loop": {k: {key: v[key] for key in (
             "iterations", "launches", "device_ms_per_iteration",
             "bound_ms_per_iteration", "ms", "ms_eager", "host_ms",
             "host_ms_eager")} for k, v in regloop["shard_times"].items()}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
