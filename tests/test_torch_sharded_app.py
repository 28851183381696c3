"""Port vs JAX: the sharded warpsense app (``pipeline/warpsense_sharded``)
and the featsense mesh back end, at a world of 2 gloo CPU ranks (spawned,
tests/_torch_dist_worker.py) and a world of 1 (in this process).

The walk, the window (160 x 101 x 41) and the settings are
tests/test_sharded_app.py's and test_distributed.py's.  Tolerances:

* every rank holds the same poses, bit for bit (the statistics are summed
  in rank order);
* at a world of 1 the sharded app gives the single-GPU app's poses bit for
  bit (fusion, fields and statistics are the same arithmetic);
* against JAX's ShardedWarpsenseApp on the same scans (a 4-device mesh,
  synchronous shift): within 0.5 mm and 1e-4 rad, the port's registration
  tolerance (measured below 0.1 mm), and both within test_sharded_app.py's
  0.15 m of the truth;
* the merged per-rank map files (``eval/merge_maps``) hold the voxels the
  world-of-1 run persists, and agree with it where a few voxels along the
  last fusions' surfaces differ by the poses' float noise (measured
  agreement below);
* featsense: the TSDF back end does not feed the poses, so the world-2
  mesh back end gives the single-GPU app's refined poses and window bit
  for bit;
* the live monitor (period 0: a snapshot every scan): at a world of 1 the
  single-GPU app's snapshots, path and status bit for bit; at a world of
  2 every snapshot is the ranks' slabs gathered in rank order, both ranks'
  monitors hold the same path and status, and the poses are the
  unmonitored run's bits (also with a monitor on rank 0 only); status
  counts and shift positions equal JAX's monitored sharded app's, and its
  last window agrees with JAX's to the merged-map test's share.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import _torch_dist_worker as w
from warpsense_tpu.core.config import Params as JParams
from warpsense_tpu.obs.live import LiveMonitor as JLiveMonitor
from warpsense_tpu.parallel.sharded import make_mesh as jmake_mesh
from warpsense_tpu.pipeline.warpsense_sharded import \
    ShardedWarpsenseApp as JShardedApp
from warpsense_tpu_torch.core.config import Params
from warpsense_tpu_torch.eval.merge_maps import merge
from warpsense_tpu_torch.map.global_map import GlobalMap
from warpsense_tpu_torch.obs.live import LiveMonitor
from warpsense_tpu_torch.parallel.sharded import make_mesh
from warpsense_tpu_torch.pipeline import warpsense_sharded as ws
from warpsense_tpu_torch.pipeline.featsense import FeatsenseApp
from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp

AREA = (np.asarray([-20, -50, -20]), np.asarray([80, 50, 20]))


@pytest.fixture(scope="module")
def walk():
    return w.walk_scans()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("world2")
    mp = pytest.MonkeyPatch()
    w.env_one_thread(mp)
    try:
        ranks = w.launch("app", 2, d, outdir=str(d))
    finally:
        mp.undo()
    return ranks, d


@pytest.fixture(scope="module")
def world1(tmp_path_factory, walk):
    """The sharded app at a world of one, synchronous shift, in this
    process."""
    d = tmp_path_factory.mktemp("world1")
    _, scans = walk
    app = ws.ShardedWarpsenseApp(
        Params.from_dict(w.app_config(0.25)), mesh=make_mesh("cpu"),
        map_path=d / "single.h5", capacity=8192, window_size=w.WINDOW,
        sync_shift=True)
    traj = np.stack([app.cloud_callback(s, float(i))
                     for i, s in enumerate(scans)])
    app.terminate()
    return traj, d / "single.h5"


@pytest.fixture(scope="module")
def jax_run(walk, tmp_path_factory):
    """JAX's ShardedWarpsenseApp on the walk (a 4-device mesh, synchronous
    shift) with a JAX LiveMonitor (period 0): poses, the monitor's status,
    shift positions and map snapshots."""
    _, scans = walk
    mon = JLiveMonitor(map_snapshot_period_s=0.0)
    snaps, shifts = [], []
    mon.subscribe("map", snaps.append)
    mon.subscribe("shift", lambda pos: shifts.append(np.asarray(pos)))
    app = JShardedApp(JParams.from_dict(w.app_config(0.25)),
                      mesh=jmake_mesh(4),
                      map_path=tmp_path_factory.mktemp("jax") / "j.h5",
                      capacity=8192,
                      window_size=w.WINDOW, sync_shift=True, monitor=mon)
    try:
        traj = np.stack([app.cloud_callback(s, float(i))
                         for i, s in enumerate(scans)])
    finally:
        app.terminate()
    return dict(traj=traj, status=json.loads(mon.status_json()),
                shifts=np.asarray(shifts, np.int64).reshape(-1, 3),
                snaps=[[np.asarray(x) for x in s] for s in snaps])


@pytest.fixture(scope="module")
def jax_traj(jax_run):
    return jax_run["traj"]


def _truth_err(traj, truth):
    return float(np.linalg.norm(traj[-1, :3, 3] / 1000.0
                                - (truth[-1][:3, 3] - truth[0][:3, 3])))


def test_ranks_hold_equal_poses(world2):
    ranks, _ = world2
    np.testing.assert_array_equal(ranks[0]["traj"], ranks[1]["traj"])
    assert np.any(ranks[0]["pos"] != 0), "the window never shifted"


def test_world2_matches_jax_mesh_app(world2, jax_traj, walk):
    truth, _ = walk
    got = world2[0][0]["traj"]
    assert len(got) == len(jax_traj) == 6
    for a, b in zip(got, jax_traj):
        w.assert_pose_close(a, b)
    assert _truth_err(got, truth) < 0.15
    assert _truth_err(jax_traj, truth) < 0.15


def test_world1_is_the_single_gpu_app(world1, walk, tmp_path):
    """At a world of one the sharded app is the single-GPU app's
    arithmetic: the same poses, bit for bit."""
    _, scans = walk
    app = WarpsenseApp(Params.from_dict(w.app_config(0.25)),
                       map_path=tmp_path / "one.h5", capacity=8192,
                       fusion="projective-level", force_odd=False,
                       window_size=w.WINDOW, sync_shift=True, device="cpu")
    traj = np.stack([app.cloud_callback(s, float(i))
                     for i, s in enumerate(scans)])
    app.terminate()
    np.testing.assert_array_equal(world1[0], traj)


def test_world2_poses_near_world1(world2, world1):
    for a, b in zip(world2[0][0]["traj"], world1[0]):
        w.assert_pose_close(a, b)


def _area(path):
    gm = GlobalMap(path, 600, 0, truncate=False)
    try:
        return gm.read_area(*AREA)
    finally:
        gm.close()


def test_merged_rank_files_hold_the_world1_map(world2, world1):
    _, d = world2
    r0, r1 = _area(d / "mh.p0.h5"), _area(d / "mh.p1.h5")
    # the ranks own disjoint rows: no voxel has weight in both files
    assert not np.any(((r0 >> 16) != 0) & ((r1 >> 16) != 0))
    stats = merge([d / "mh.p0.h5", d / "mh.p1.h5"], d / "merged.h5")
    assert stats["poses"] == 6
    merged = _area(d / "merged.h5")
    np.testing.assert_array_equal(merged, np.where((r0 >> 16) != 0, r0, r1))
    single = _area(world1[1])
    w_single = (single >> 16) != 0
    assert w_single.sum() > 1000
    np.testing.assert_array_equal((merged >> 16) != 0, w_single)
    agree = float((merged[w_single] == single[w_single]).mean())
    assert agree > 0.99, agree


def test_resume_from_rank_files(world2):
    ranks, _ = world2
    r = ranks[0]
    assert bool(r["resumed_initialized"])
    # the file keeps the pose rounded to 1 mm and its quaternion to 1e-3
    w.assert_pose_close(r["resumed_pose"], r["traj"][-1], mm=0.5, rad=2e-3)
    # the resumed window is centered on the last pose's voxel
    np.testing.assert_array_equal(
        r["resumed_pos"], np.floor(r["resumed_pose"][:3, 3] / 128.0))
    assert int((r["resumed_weight"] != 0).sum()) > 1000


def test_featsense_mesh_world2_is_the_single_gpu_app(world2, walk, tmp_path):
    """The mesh back end at two ranks (shifting each rank's rows) against
    the single-GPU app with the level-grid projective fusion."""
    from warpsense_tpu_torch.parallel.distributed import gather_state
    ranks, _ = world2
    _, scans = walk
    # the ranks run one thread each; PyTorch's CPU reductions split their
    # sums by the thread count, so the single-GPU run uses one thread too
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        app = FeatsenseApp(Params.from_dict(w.featsense_config(0.15)),
                           map_path=tmp_path / "fs.h5",
                           fusion="projective-level", window_size=w.WINDOW,
                           device="cpu", **w.FEATSENSE_KW)
        for i, scan in enumerate(scans):
            app.process_scan(scan, float(i))
    finally:
        torch.set_num_threads(threads)
    gicp = np.stack(app.mapping.gicp_path)
    full = gather_state(app.mapping.state, make_mesh("cpu"))
    app.terminate()
    assert len(gicp) >= 4
    for r in ranks:
        np.testing.assert_array_equal(r["gicp"], gicp)
        np.testing.assert_array_equal(r["fs_pos"], full.pos)
        np.testing.assert_array_equal(r["fs_value"], full.value)
        np.testing.assert_array_equal(r["fs_weight"], full.weight)
    assert np.any(full.pos != 0), "featsense window never shifted"


def test_staged_shift_persist_and_resume(tmp_path, walk):
    """World of one with the staged (overlapped) shift: it tracks, the
    window moves, map and poses persist, and a resume continues."""
    truth, scans = walk
    params = Params.from_dict(w.app_config(0.25))
    kw = dict(mesh=make_mesh("cpu"), map_path=tmp_path / "shift.h5",
              capacity=8192, window_size=w.WINDOW)
    app = ws.ShardedWarpsenseApp(params, **kw)
    traj = np.stack([app.cloud_callback(s, float(i))
                     for i, s in enumerate(scans)])
    app.terminate()
    assert _truth_err(traj, truth) < 0.15
    assert np.any(app.local_map.state.pos != 0)
    import h5py
    with h5py.File(tmp_path / "shift.h5") as f:
        assert len(f["map"]) > 0 and len(f["poses"]) == len(scans)
    again = ws.ShardedWarpsenseApp(params, resume=True, **kw)
    assert again.initialized
    assert int((again.state.weight != 0).sum()) > 1000
    again.terminate()


def test_fields_cached_across_scans(tmp_path, walk, monkeypatch):
    """The sharded fields are computed once per map epoch."""
    _, scans = walk
    app = ws.ShardedWarpsenseApp(
        Params.from_dict(w.app_config()), mesh=make_mesh("cpu"),
        in_memory_map=True, capacity=8192, window_size=w.WINDOW)
    calls = []
    orig = ws.precompute_fields_packed_sharded

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(ws, "precompute_fields_packed_sharded", counting)
    app.cloud_callback(scans[0], 0.0)          # bootstrap fuse, then fields
    assert len(calls) == 1
    app.params.map.update_distance = 100.0     # gate fusion away
    app.cloud_callback(scans[1], 1.0)
    app.cloud_callback(scans[2], 2.0)
    assert len(calls) == 1
    app.params.map.update_distance = 0.0001    # fuses after registering
    app.cloud_callback(scans[3], 3.0)
    assert len(calls) == 1
    app.cloud_callback(scans[4], 4.0)
    assert len(calls) == 2
    app.terminate()


def test_attitude_fallback_and_limits(monkeypatch):
    """Beyond the tilt budget the sharded fusion bins with the sensor
    attitude (K1's general sweep); the app takes a monitor; parity mode, a
    coarse phase and an x extent that does not divide the world raise."""
    from warpsense_tpu_torch.io.synthetic import BoxWorld, render_scan
    app = ws.ShardedWarpsenseApp(
        Params.from_dict(w.app_config()), mesh=make_mesh("cpu"),
        in_memory_map=True, capacity=8192, window_size=w.WINDOW)
    calls = []
    orig = ws.tsdf_update_projective_sharded

    def capture(state, pts, mask, spos, rotation, **kw):
        calls.append((np.asarray(rotation), kw["level"]))
        return orig(state, pts, mask, spos, rotation, **kw)

    monkeypatch.setattr(ws, "tsdf_update_projective_sharded", capture)
    t = np.radians(12.0)
    pitched = np.eye(4)
    pitched[:3, :3] = [[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                       [-np.sin(t), 0, np.cos(t)]]
    world = BoxWorld.default()
    rng = np.random.default_rng(3)
    app.cloud_callback(render_scan(world, np.eye(4), channels=w.APP_CH,
                                   columns=w.APP_COLS, noise_std=0.002,
                                   rng=rng), 0.0)
    app.pose = pitched.astype(np.float32)
    app.initialized = False
    app.cloud_callback(render_scan(world, pitched, channels=w.APP_CH,
                                   columns=w.APP_COLS, noise_std=0.002,
                                   rng=rng), 1.0)
    app.terminate()
    np.testing.assert_allclose(calls[0][0], np.eye(3), atol=1e-6)
    assert calls[0][1] is True
    np.testing.assert_allclose(calls[-1][0], pitched[:3, :3], atol=1e-5)
    assert calls[-1][1] is False

    cfg = w.app_config()
    cfg["registration"]["mode"] = "parity"
    with pytest.raises(ValueError, match="fast"):
        ws.ShardedWarpsenseApp(Params.from_dict(cfg), mesh=make_mesh("cpu"),
                               in_memory_map=True)
    cfg = w.app_config()
    cfg["registration"]["coarse_iterations"] = 5
    with pytest.raises(ValueError, match="coarse_iterations"):
        ws.ShardedWarpsenseApp(Params.from_dict(cfg), mesh=make_mesh("cpu"),
                               in_memory_map=True)
    mon = LiveMonitor()
    watched = ws.ShardedWarpsenseApp(Params.from_dict(w.app_config()),
                                     mesh=make_mesh("cpu"),
                                     in_memory_map=True, capacity=8192,
                                     window_size=w.WINDOW, monitor=mon)
    watched.cloud_callback(render_scan(world, np.eye(4), channels=w.APP_CH,
                                       columns=w.APP_COLS), 0.0)
    watched.terminate()
    st = json.loads(mon.status_json())
    assert st["scans"] == 1 and st["map_epoch"] == 1
    mesh2 = dataclasses.replace(make_mesh("cpu"), world=2)
    with pytest.raises(ValueError, match="divide"):
        ws.ShardedWarpsenseApp(Params.from_dict(w.app_config()),
                               mesh=mesh2, in_memory_map=True,
                               window_size=(161, 101, 41))


# ------------------------------------------------------------ live monitor

STATUS_KEYS = ("scans", "stamp", "position_m", "map_epoch", "shifts",
               "last_shift_pos")
PLANES = ("value", "weight", "pos", "offset")


def _status(mon_or_json):
    st = json.loads(mon_or_json if isinstance(mon_or_json, str)
                    else mon_or_json.status_json())
    return {k: st.get(k) for k in STATUS_KEYS}


def test_world1_monitor_is_the_single_gpu_apps(world1, walk):
    """At a world of one the sharded app publishes what the single-GPU app
    publishes, bit for bit: each scan's snapshot (a copy, not the app's
    planes), the path, the shifts, the status, the TUM path and the PLY;
    and its poses are the unmonitored run's."""
    _, scans = walk
    runs = []
    for sharded in (True, False):
        mon, snaps, shifts = w.watched()
        kw = dict(in_memory_map=True, capacity=8192, window_size=w.WINDOW,
                  sync_shift=True, monitor=mon)
        params = Params.from_dict(w.app_config(0.25))
        app = (ws.ShardedWarpsenseApp(params, mesh=make_mesh("cpu"), **kw)
               if sharded else
               WarpsenseApp(params, fusion="projective-level",
                            force_odd=False, device="cpu", **kw))
        traj = np.stack([app.cloud_callback(s, float(i))
                         for i, s in enumerate(scans)])
        if sharded:
            assert not np.shares_memory(snaps[-1].value,
                                        app.state.value.numpy())
        app.terminate()
        runs.append((traj, mon, w.monitor_report(mon, snaps, shifts)))
    (traj, mon, got), (_, single_mon, want) = runs
    np.testing.assert_array_equal(traj, world1[0])
    assert len(got["snap_value"]) == len(scans)
    for k, v in want.items():
        if k != "status":
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(got["path"], traj.astype(np.float64))
    assert len(got["shifts"]) >= 1
    assert _status(mon) == _status(single_mon)
    assert mon.tum_path() == single_mon.tum_path()
    assert mon.map_ply_bytes() == single_mon.map_ply_bytes()


def test_world2_monitor_snapshots_are_the_gathered_slabs(world2):
    """Every rank's monitor receives, after each scan, the window gathered
    from the ranks' slabs in rank order at that scan."""
    ranks, _ = world2
    for r in ranks:
        assert len(r["mon_snap_value"]) == len(r["traj"])
        for k in PLANES:
            np.testing.assert_array_equal(r["mon_snap_" + k],
                                          r["mon_window_" + k], err_msg=k)
    assert int((ranks[0]["mon_snap_weight"][-1] != 0).sum()) > 1000


def test_world2_monitors_hold_equal_paths_and_status(world2):
    ranks, _ = world2
    a, b = ranks
    for k in ("path", "stamps", "shifts"):
        np.testing.assert_array_equal(a["mon_" + k], b["mon_" + k])
    np.testing.assert_array_equal(a["mon_path"],
                                  a["traj"].astype(np.float64))
    assert _status(str(a["mon_status"])) == _status(str(b["mon_status"]))
    assert _status(str(a["mon_status"]))["map_epoch"] == len(a["traj"])


def test_world2_monitor_keeps_poses_and_collectives(world2):
    """The poses are the unmonitored run's bits, with a monitor on every
    rank and on rank 0 only; without a monitor a scan calls no all-reduce,
    with one a scan calls one (the snapshot decision) and a snapshot two
    all-gathers (value and weight)."""
    ranks, _ = world2
    for r in ranks:
        np.testing.assert_array_equal(r["mon_traj"], r["traj"])
        np.testing.assert_array_equal(r["r0_traj"], r["traj"])
        assert int(r["plain_all_reduce"]) == 0
        n = len(r["traj"])
        for run in ("mon", "r0"):
            assert int(r[run + "_all_reduce"]) == n
            assert int(r[run + "_all_gather"]) \
                == int(r["plain_all_gather"]) + 2 * n
    assert "r0_snap_value" not in ranks[1]
    for k in PLANES:
        np.testing.assert_array_equal(ranks[0]["r0_snap_" + k],
                                      ranks[0]["mon_snap_" + k], err_msg=k)


def test_world2_monitor_matches_jax_sharded_app(world2, jax_run):
    """Status counts and shift positions are JAX's monitored sharded
    app's on the same scans; each snapshot's weighted voxels are JAX's,
    and their contents agree where the poses' float noise lets them (the
    merged-map test's share; measured: all of them for four scans, then
    0.99998 of 263,128)."""
    got = world2[0][0]
    status = _status(str(got["mon_status"]))
    for k in ("scans", "map_epoch", "shifts", "last_shift_pos"):
        assert status[k] == jax_run["status"][k], k
    assert len(got["mon_snap_value"]) == len(jax_run["snaps"])
    np.testing.assert_array_equal(got["mon_shifts"], jax_run["shifts"])
    for i, (value, weight, pos, offset) in enumerate(jax_run["snaps"]):
        np.testing.assert_array_equal(got["mon_snap_pos"][i], pos)
        np.testing.assert_array_equal(got["mon_snap_offset"][i], offset)
        mask = weight != 0
        assert mask.sum() > 1000
        np.testing.assert_array_equal(got["mon_snap_weight"][i] != 0, mask)
        agree = float(((got["mon_snap_value"][i] == value)
                       & (got["mon_snap_weight"][i] == weight))[mask].mean())
        assert agree > 0.99, (i, agree)
