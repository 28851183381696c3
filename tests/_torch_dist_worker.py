"""Rank processes of the port's multi-GPU layer for the CPU tests.

``launch`` spawns a gloo group of CPU ranks (``torch.multiprocessing``,
spawn), rendezvous through a ``FileStore`` in the test's tmp_path, runs one
of the ``run_*`` functions below on every rank and waits for them with a
timeout, after which it kills the ranks and fails the test.  Each rank
writes ``<name>_<rank>.npz``.  Nothing here imports JAX: the test process
runs the JAX functions and compares.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from warpsense_tpu_torch.core.consts import MATRIX_RESOLUTION, \
    WEIGHT_RESOLUTION
from warpsense_tpu_torch.map.local_map import create_state

TAU, RES = 600, 64
SIZE = (80, 41, 41)            # X divisible by 2, 4 and 8 ranks
CH, COLS = 32, 128
JOIN_TIMEOUT_S = 180.0


# ------------------------------------------------------------------ inputs

def raymarch_cloud(n=4000, half=1200.0, seed=3):
    """tests/test_sharded.py's box room (int32 mm)."""
    rng = np.random.default_rng(seed)
    pts = []
    for ax in range(3):
        for s in (-1, 1):
            p = rng.uniform(-half, half, size=(n // 6, 3))
            p[:, ax] = s * half
            pts.append(p)
    return np.round(np.concatenate(pts)).astype(np.int32)


def flat_room_cloud(n=4002, half=1200.0, zhalf=400.0, seed=7):
    """tests/test_sharded_fast.py's flat room (int32 mm)."""
    rng = np.random.default_rng(seed)
    pts = []
    for ax in range(3):
        for s in (-1, 1):
            p = np.stack([rng.uniform(-half, half, n // 6),
                          rng.uniform(-half, half, n // 6),
                          rng.uniform(-zhalf, zhalf, n // 6)], axis=1)
            p[:, ax] = s * (zhalf if ax == 2 else half)
            pts.append(p)
    return np.round(np.concatenate(pts)).astype(np.int32)


def tilt(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]], np.float32)


def perturbation(t, yaw_deg):
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = t
    th = np.deg2rad(yaw_deg)
    pert[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0],
                             [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                            np.float32)
    return pert


PROJ_KW = dict(size=SIZE, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
               resolution=RES, channels=CH, columns=COLS, vfov_deg=45.0)
PARITY_REG_KW = dict(size=SIZE, resolution=RES, max_iterations=60,
                     it_weight_gradient=0.1, epsilon=0.0)
PACKED_REG_KW = dict(size=SIZE, resolution=RES, tau=TAU, max_iterations=50,
                     epsilon=0.03)
PERT = perturbation([90, -60, 40], 0.7)
PERT_FREEZE = perturbation([70, -50, 30], 0.0)


def rot_err(a, b) -> float:
    """Angle (rad) of a^T b from its skew part, in float64 (arccos of the
    trace loses ~sqrt(eps) near the identity)."""
    m = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    v = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v) / 2.0)))


def assert_pose_close(got, want, mm=0.5, rad=1e-4) -> None:
    """The port's registration tolerance: 0.5 mm and 1e-4 rad."""
    assert np.max(np.abs(got[:3, 3] - want[:3, 3])) <= mm, (got, want)
    assert rot_err(got, want) <= rad, (rot_err(got, want), got, want)


# ----------------------------------------------------------------- ranks

def run_ops(mesh) -> dict:
    """Every sharded op once on this rank; gathered windows, planes and
    poses."""
    from warpsense_tpu_torch.ops.tsdf import plan_raymarch
    from warpsense_tpu_torch.parallel import sharded as sh
    from warpsense_tpu_torch.parallel.distributed import (gather_state,
                                                          run_demo)

    out = {}

    def fresh():
        return sh.shard_state(create_state(SIZE, TAU, 0, force_odd=False),
                              mesh)

    def keep(name, state):
        full = gather_state(state, mesh)
        out[name + "_value"], out[name + "_weight"] = full.value, full.weight

    ms, mi = plan_raymarch(TAU, RES, 4000)
    pts = torch.as_tensor(raymarch_cloud())
    mask = torch.ones(len(pts), dtype=torch.bool)
    zero = torch.zeros(3, dtype=torch.int32)
    up = torch.tensor([0, 0, MATRIX_RESOLUTION], dtype=torch.int32)
    ray = sh.tsdf_update_sharded(
        fresh(), pts, mask, zero, up, mesh=mesh, size=SIZE, tau=TAU,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=RES, max_steps=ms,
        max_isteps=mi)
    keep("ray", ray)
    out["parity_pose"] = sh.register_cloud_sharded(
        ray, pts, mask, torch.as_tensor(PERT), mesh=mesh,
        **PARITY_REG_KW).numpy()

    pts = torch.as_tensor(flat_room_cloud())
    mask = torch.ones(len(pts), dtype=torch.bool)
    eye = torch.eye(3, dtype=torch.float32)
    level = sh.tsdf_update_projective_sharded(
        fresh(), pts, mask, zero, eye, mesh=mesh, level=True, **PROJ_KW)
    keep("level", level)
    f = sh.precompute_fields_packed_sharded(level, mesh=mesh, tau=TAU)
    out["packed"] = sh.gather_rows(f.plane, mesh).numpy()
    f2 = sh.precompute_fields_packed_sharded(level, mesh=mesh, tau=TAU,
                                             exact=True)
    out["exact_a"] = sh.gather_rows(f2.plane_a, mesh).numpy()
    out["exact_b"] = sh.gather_rows(f2.plane_b, mesh).numpy()
    pose, iters, err = sh.register_cloud_packed_sharded(
        f, level.pos, level.offset, pts, mask, torch.as_tensor(PERT),
        mesh=mesh, **PACKED_REG_KW)
    out["packed_pose"], out["packed_iters"] = pose.numpy(), iters
    pose, _, _ = sh.register_cloud_packed_sharded(
        f, level.pos, level.offset, pts, mask, torch.as_tensor(PERT_FREEZE),
        mesh=mesh, gather_freeze=True, **PACKED_REG_KW)
    out["freeze_pose"] = pose.numpy()
    # a second fusion from a moved origin runs the merge
    sh.tsdf_update_projective_sharded(
        level, pts, mask, zero + 2, eye, mesh=mesh, level=True, **PROJ_KW)
    keep("level2", level)
    tilted = sh.tsdf_update_projective_sharded(
        fresh(), pts, mask, zero, torch.as_tensor(tilt(4.0)), mesh=mesh,
        level=False, **PROJ_KW)
    keep("tilt", tilted)

    report, full, pose = run_demo(mesh, SIZE)
    out["demo_value"], out["demo_weight"] = full.value, full.weight
    out["demo_pose"] = pose
    out["demo_slab"] = np.asarray(report["slab"])
    return out


LOOP_NAMES = ("packed", "packed_freeze", "exact", "gn_parity", "gn_fast")
LOOP_CHUNKS = (1, 3, 8)
# the fast-mode GN's iterations where it is held against JAX's sharded one:
# from the 8th on, JAX's own single-window and sharded fast GN part
# (tests/test_torch_sharded_loop.py)
FAST_GN_ITERATIONS = 5


def loop_scenes():
    """The sharded loop tests' whole windows on the CPU: the flat room
    fused on the level grid and the box room ray-marched, each with its
    cloud (int32 mm) as (state, points, mask)."""
    from warpsense_tpu_torch.ops.tsdf import plan_raymarch, tsdf_update
    from warpsense_tpu_torch.ops.tsdf_projective import \
        tsdf_update_projective

    zero = torch.zeros(3, dtype=torch.int32)
    pts = torch.as_tensor(flat_room_cloud())
    mask = torch.ones(len(pts), dtype=torch.bool)
    level = tsdf_update_projective(
        create_state(SIZE, TAU, 0, force_odd=False), pts, mask, zero,
        torch.eye(3, dtype=torch.float32), level=True, **PROJ_KW)
    rpts = torch.as_tensor(raymarch_cloud())
    rmask = torch.ones(len(rpts), dtype=torch.bool)
    ms, mi = plan_raymarch(TAU, RES, 4000)
    ray = tsdf_update(
        create_state(SIZE, TAU, 0, force_odd=False), rpts, rmask, zero,
        torch.tensor([0, 0, MATRIX_RESOLUTION], dtype=torch.int32),
        size=SIZE, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
        resolution=RES, max_steps=ms, max_isteps=mi)
    return (level, pts, mask), (ray, rpts, rmask)


def loop_problems(scenes, rows=None) -> dict:
    """name -> (RegProblem, pretransform) of the sharded loop tests on
    ``loop_scenes()``, on the window's rows ``rows`` = (lo, hi) (the whole
    window by default):
    the LM over packed fields without and with the gather freeze and over
    exact fields (PACKED_REG_KW), the GN in its parity and fast modes
    (PARITY_REG_KW); the fields are the whole window's, cut to the rows
    (the sharded fields' bits: tests/test_torch_sharded.py)."""
    from warpsense_tpu_torch.ops import registration as treg
    (level, pts, mask), (ray, rpts, rmask) = scenes
    lo, hi = rows or (0, SIZE[0])

    def cut(fields):
        return type(fields)(*(p[lo:hi].contiguous() for p in fields))

    lm = dict(pos=level.pos, offset=level.offset, points=pts, mask=mask,
              size=SIZE, resolution=RES, tau=TAU, interp=True,
              normalize=False, lm=True, recenter=True, coarse_iterations=0,
              max_iterations=PACKED_REG_KW["max_iterations"],
              epsilon=PACKED_REG_KW["epsilon"], it_weight_gradient=0.0,
              freeze_step_mm=float(RES), x_lo=lo, x_rows=hi - lo)
    packed = cut(treg.precompute_fields_packed(level, tau=TAU))
    out = {"packed": (treg.RegProblem(fields=packed,
                                      layout=treg.LAYOUT_PACKED,
                                      split=False, **lm), PERT),
           "packed_freeze": (treg.RegProblem(fields=packed,
                                             layout=treg.LAYOUT_PACKED,
                                             split=True, **lm), PERT_FREEZE),
           "exact": (treg.RegProblem(
               fields=cut(treg.precompute_fields_packed2(level)),
               layout=treg.LAYOUT_EXACT, split=False, **lm), PERT)}
    parity = cut(treg.precompute_fields(ray))
    for mode in ("parity", "fast"):
        out["gn_" + mode] = (treg.RegProblem(
            fields=parity, pos=ray.pos, offset=ray.offset, points=rpts,
            mask=rmask, size=SIZE, resolution=RES, tau=TAU,
            layout=treg.LAYOUT_PARITY, interp=False,
            normalize=mode == "fast", lm=False, recenter=mode == "fast",
            coarse_iterations=0, split=False,
            max_iterations=PARITY_REG_KW["max_iterations"],
            epsilon=PARITY_REG_KW["epsilon"],
            it_weight_gradient=PARITY_REG_KW["it_weight_gradient"],
            freeze_step_mm=0.0, x_lo=lo, x_rows=hi - lo), PERT)
    return {k: (prob, torch.as_tensor(pose)) for k, (prob, pose)
            in out.items()}


def two_phase_loop(prob, pose, mesh, trace=None):
    """The sharded loop in its two-phase order, the yardstick of the fused
    one: at each iteration this rank's ``reg_stats_plain`` row on its
    slab, the ranks' rows all-gathered in rank order (no collective
    without a group), then ``reg_step_plain`` on them; ``trace`` row i
    gets the carry before step i and the rows.  Returns the end state."""
    from warpsense_tpu_torch.ops import registration as treg
    state = treg.init_state(prob, pose, "cpu")
    rows_all = torch.zeros((mesh.world, treg.PARTIALS))
    parts = list(rows_all.chunk(mesh.world))
    cache: dict = {}
    while not treg.stopped(state, prob):
        row = treg.reg_stats_plain(state, prob, cache)
        if mesh.group is None:
            rows_all.copy_(row)
        else:
            dist.all_gather(parts, row.contiguous(), group=mesh.group)
        if trace is not None:
            t = trace[int(state[treg.S_I])]
            t[:treg.STATE_LEN] = state
            t[treg.STATE_LEN:] = rows_all.reshape(-1)
        treg.reg_step_plain(state, rows_all, prob)
    return state


def run_loop(mesh) -> dict:
    """The sharded loops on this rank: every ``loop_problems`` registration
    on the rank's slab through ``run_registration_sharded`` at each of
    LOOP_CHUNKS, traced (end state, header, trace), and the public entry
    points from the rank's sharded map (pose, and the LM's iterations)."""
    from warpsense_tpu_torch.ops import registration as treg
    from warpsense_tpu_torch.parallel import sharded as sh

    out = {}
    scenes = loop_scenes()
    for name, (prob, pose) in loop_problems(
            scenes, sh.slab_rows(mesh, SIZE[0])).items():
        for chunk in LOOP_CHUNKS:
            trace = torch.zeros((prob.max_iterations,
                                 treg.trace_width(mesh.world)))
            st, head = sh.run_registration_sharded(prob, pose, mesh,
                                                   chunk=chunk, trace=trace)
            out[f"{name}_state_{chunk}"] = st.numpy()
            out[f"{name}_head_{chunk}"] = np.asarray(head)
            out[f"{name}_trace_{chunk}"] = trace.numpy()
        trace = torch.zeros((prob.max_iterations,
                             treg.trace_width(mesh.world)))
        out[f"{name}_two_phase_state"] = two_phase_loop(
            prob, pose, mesh, trace).numpy()
        out[f"{name}_two_phase_trace"] = trace.numpy()
    (level, pts, mask), (ray, rpts, rmask) = scenes
    kw = dict(PACKED_REG_KW)
    for name, exact, freeze, pose in (("packed", False, False, PERT),
                                      ("packed_freeze", False, True,
                                       PERT_FREEZE),
                                      ("exact", True, False, PERT)):
        slab = sh.shard_state(level, mesh)
        f = sh.precompute_fields_packed_sharded(slab, mesh=mesh, tau=TAU,
                                                exact=exact)
        got, iters, _ = sh.register_cloud_packed_sharded(
            f, slab.pos, slab.offset, pts, mask, torch.as_tensor(pose),
            mesh=mesh, gather_freeze=freeze, **kw)
        out[f"{name}_pose"], out[f"{name}_iters"] = got.numpy(), iters
    for mode in ("parity", "fast"):
        out[f"gn_{mode}_pose"] = sh.register_cloud_sharded(
            sh.shard_state(ray, mesh), rpts, rmask, torch.as_tensor(PERT),
            mesh=mesh, mode=mode, **PARITY_REG_KW).numpy()
    out["gn_fast_early_pose"] = sh.register_cloud_sharded(
        sh.shard_state(ray, mesh), rpts, rmask, torch.as_tensor(PERT),
        mesh=mesh, mode="fast", **dict(
            PARITY_REG_KW, max_iterations=FAST_GN_ITERATIONS)).numpy()
    return out


WINDOW = (160, 101, 41)       # tests/test_sharded_app.py's window
APP_CH, APP_COLS = 32, 512


def app_config(shift=8.0) -> dict:
    """tests/test_sharded_app.py's fast-mode configuration."""
    return {
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 20, "y": 12, "z": 5}, "shift": shift,
                "update_distance": 0.08},
        "registration": {"max_iterations": 60, "epsilon": 0.0,
                         "it_weight_gradient": 0.1, "mode": "fast"},
        "lidar": {"channels": APP_CH, "hresolution": APP_COLS},
    }


def featsense_config(shift=8.0) -> dict:
    """tests/test_featsense_sharded.py's configuration."""
    return {
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 20, "y": 12, "z": 5}, "shift": shift,
                "update_distance": 0.05},
        "floam": {"min_distance": 0.5, "max_distance": 40.0,
                  "edge_threshold": 0.5, "surf_threshold": 0.05,
                  "edge_resolution": 0.15, "optimization_steps": 3,
                  "enrich": 4, "vgicp_fitness_score": 6.0},
        "lidar": {"channels": APP_CH, "hresolution": APP_COLS},
    }


FEATSENSE_KW = dict(edge_capacity=1024, surf_capacity=2048,
                    cloud_capacity=8192,
                    odom_kwargs=dict(edge_map_capacity=4096,
                                     surf_map_capacity=8192))


def walk_scans(n=6):
    """(ground-truth poses, scans) of the walk: 0.1 m steps, seed 0."""
    from warpsense_tpu_torch.io.synthetic import (BoxWorld, render_scan,
                                                  walk_trajectory)
    poses = walk_trajectory(n, step_m=0.1)
    world = BoxWorld.default()
    rng = np.random.default_rng(0)
    return poses, [render_scan(world, p, channels=APP_CH, columns=APP_COLS,
                               noise_std=0.002, rng=rng) for p in poses]


COLLECTIVES = ("all_reduce", "all_gather")


@contextlib.contextmanager
def counting_collectives(counts: dict):
    """Add to ``counts[name]`` each call of ``torch.distributed.<name>``
    (the names of COLLECTIVES) made inside the block."""
    saved = {n: getattr(dist, n) for n in COLLECTIVES}

    def counted(name):
        def call(*a, **kw):
            counts[name] += 1
            return saved[name](*a, **kw)
        return call
    for n in COLLECTIVES:
        setattr(dist, n, counted(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def _walk(app, scans, mesh, windows=False) -> dict:
    """``app`` on the walk: its poses, the collectives its scans called
    and, with ``windows``, the window gathered from the slabs after each
    scan (outside the count)."""
    from warpsense_tpu_torch.parallel.distributed import gather_state
    counts = dict.fromkeys(COLLECTIVES, 0)
    traj, seen = [], []
    for i, scan in enumerate(scans):
        with counting_collectives(counts):
            traj.append(app.cloud_callback(scan, float(i)))
        if windows:
            seen.append(gather_state(app.state, mesh))
    out = dict(traj=np.stack(traj), **counts)
    for k in ("value", "weight", "pos", "offset") if windows else ():
        out["window_" + k] = np.stack([getattr(s, k) for s in seen])
    return out


def monitor_report(mon, snaps, shifts) -> dict:
    """What a LiveMonitor received: every map snapshot's planes, the path,
    the shift positions and the status."""
    out = dict(path=np.stack([p for _, p in mon.path]),
               stamps=np.asarray([s for s, _ in mon.path]),
               shifts=np.asarray(shifts, np.int64).reshape(-1, 3),
               status=np.asarray(mon.status_json()))
    for k in ("value", "weight", "pos", "offset"):
        out["snap_" + k] = np.stack([np.asarray(getattr(s, k))
                                     for s in snaps])
    return out


def watched(period_s=0.0):
    """(LiveMonitor, its map snapshots, its shift positions)."""
    from warpsense_tpu_torch.obs.live import LiveMonitor
    mon = LiveMonitor(map_snapshot_period_s=period_s)
    snaps, shifts = [], []
    mon.subscribe("map", snaps.append)
    mon.subscribe("shift", lambda pos: shifts.append(np.asarray(pos)))
    return mon, snaps, shifts


def run_app(mesh, outdir: str) -> dict:
    """The sharded app on the walk with a 0.25 m shift (each rank persists
    its own rows), a resume from those files, the same walk with a live
    monitor on every rank (period 0) and on rank 0 only, and the featsense
    mesh back end on the same scans with a 0.15 m shift."""
    from warpsense_tpu_torch.core.config import Params
    from warpsense_tpu_torch.parallel.distributed import gather_state
    from warpsense_tpu_torch.pipeline.featsense import FeatsenseApp
    from warpsense_tpu_torch.pipeline.warpsense_sharded import \
        ShardedWarpsenseApp

    _, scans = walk_scans()
    kw = dict(mesh=mesh, map_path=f"{outdir}/mh.h5", capacity=8192,
              window_size=WINDOW)
    app = ShardedWarpsenseApp(Params.from_dict(app_config(0.25)), **kw)
    plain = _walk(app, scans, mesh)
    traj = plain["traj"]
    pos = app.state.pos.numpy().copy()
    app.terminate()
    out = {"plain_" + k: plain[k] for k in COLLECTIVES}
    for name, on in (("mon", True), ("r0", mesh.rank == 0)):
        mon, snaps, shifts = watched() if on else (None, None, None)
        mapp = ShardedWarpsenseApp(Params.from_dict(app_config(0.25)),
                                   **dict(kw, map_path=f"{outdir}/{name}.h5"),
                                   monitor=mon)
        got = _walk(mapp, scans, mesh, windows=name == "mon")
        mapp.terminate()
        if on:
            got.update(monitor_report(mon, snaps, shifts))
        out.update({f"{name}_{k}": v for k, v in got.items()})
    again = ShardedWarpsenseApp(Params.from_dict(app_config(0.25)),
                                resume=True, **kw)
    resumed = gather_state(again.state, mesh)
    out.update(traj=traj, pos=pos, resumed_pose=again.pose.copy(),
               resumed_initialized=np.asarray(again.initialized),
               resumed_weight=resumed.weight, resumed_pos=resumed.pos)
    again.terminate()

    fapp = FeatsenseApp(Params.from_dict(featsense_config(0.15)),
                        map_path=f"{outdir}/fs.h5", mesh=mesh,
                        window_size=WINDOW, device="cpu", **FEATSENSE_KW)
    for i, scan in enumerate(scans):
        fapp.process_scan(scan, float(i))
    full = gather_state(fapp.mapping.state, mesh)
    out.update(gicp=np.stack(fapp.mapping.gicp_path), fs_value=full.value,
               fs_weight=full.weight, fs_pos=full.pos)
    fapp.terminate()
    return out


# ---------------------------------------------------------------- launch

def _entry(rank, world, store_path, name, outdir, kwargs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from warpsense_tpu_torch.parallel.sharded import make_mesh
        out = globals()[f"run_{name}"](make_mesh("cpu"), **kwargs)
        np.savez(Path(outdir) / f"{name}_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def launch(name: str, world: int, tmp_path, timeout_s=JOIN_TIMEOUT_S,
           **kwargs) -> list[dict]:
    """Run ``run_<name>(mesh, **kwargs)`` on ``world`` gloo CPU ranks;
    returns each rank's arrays, in rank order.  Set OMP_NUM_THREADS=1 in
    the environment first (the ranks inherit it)."""
    tmp_path = Path(tmp_path)
    store = tmp_path / f"{name}_{world}.store"
    ctx = mp.start_processes(
        _entry, args=(world, str(store), name, str(tmp_path), kwargs),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of run_{name} did not "
                                   f"finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    outs = []
    for r in range(world):
        with np.load(tmp_path / f"{name}_{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def env_one_thread(monkeypatch) -> None:
    """Ranks start with one OpenMP thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
