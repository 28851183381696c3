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
  for bit.
"""
import numpy as np
import pytest
import torch

import _torch_dist_worker as w
from warpsense_tpu.core.config import Params as JParams
from warpsense_tpu.parallel.sharded import make_mesh as jmake_mesh
from warpsense_tpu.pipeline.warpsense_sharded import \
    ShardedWarpsenseApp as JShardedApp
from warpsense_tpu_torch.core.config import Params
from warpsense_tpu_torch.eval.merge_maps import merge
from warpsense_tpu_torch.map.global_map import GlobalMap
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
def jax_traj(walk, tmp_path_factory):
    _, scans = walk
    app = JShardedApp(JParams.from_dict(w.app_config(0.25)),
                      mesh=jmake_mesh(4),
                      map_path=tmp_path_factory.mktemp("jax") / "j.h5",
                      capacity=8192,
                      window_size=w.WINDOW, sync_shift=True)
    try:
        traj = np.stack([app.cloud_callback(s, float(i))
                         for i, s in enumerate(scans)])
    finally:
        app.terminate()
    return traj


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
    attitude (K1's general sweep); parity mode, a coarse phase, a monitor
    and an x extent that does not divide the world raise."""
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
    with pytest.raises(ValueError, match="monitor"):
        ws.ShardedWarpsenseApp(Params.from_dict(w.app_config()),
                               mesh=make_mesh("cpu"), in_memory_map=True,
                               monitor=object())
    mesh2 = make_mesh("cpu")._replace(world=2)
    with pytest.raises(ValueError, match="divide"):
        ws.ShardedWarpsenseApp(Params.from_dict(w.app_config()),
                               mesh=mesh2, in_memory_map=True,
                               window_size=(161, 101, 41))
