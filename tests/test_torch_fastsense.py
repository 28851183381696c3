"""Port vs JAX: the FastsenseApp on the CPU.

Both apps replay the same scans (32 x 256 beams, 128 mm voxels, a
12 x 12 x 6 m window, as tests/test_pipeline_fastsense.py runs the JAX
app; scans made from a numpy seed) with ``sync()`` after each scan, so
every mapping job is published before the next registration.  The
orientation IMU sample before each scan feeds both apps' pretransform.

Bounds, each measured on this replay:
* the bootstrap fusion (K1's general sweep's plain version against the
  jitted JAX sweep, which contracts multiply-adds and bins the beam table
  with XLA's arctan2): at most 1e-3 of the fused voxels differ (measured:
  0 of 85,267);
* poses: the parity GN is chaotic (ROADMAP C16).  It creeps up to 200
  iterations over a nearest-cell objective, so float32 sums in another
  order move a point across a cell edge, which changes the step and the
  stopping iteration, and the maps the worker then fuses.  The first
  three scans agree within 0.1 mm and 1e-5 rad (measured: 0.005 mm and
  2.1e-8 rad; the fourth, still against the bootstrap map, is 1.0 mm
  off); every scan
  within 60 mm and 1e-2 rad (measured: 53 mm and 7.3e-3 rad, at scan 9);
  both trajectories' ATE within 0.01 m of each other (measured: 0.1371
  vs 0.1334 m).
"""
import dataclasses

import numpy as np
import pytest
import torch

from warpsense_tpu.core.config import Params as JParams
from warpsense_tpu.io.synthetic import (BoxWorld, render_scan,
                                        walk_trajectory)
from warpsense_tpu.io.trajectory import _quat_from_mat
from warpsense_tpu.pipeline.fastsense import FastsenseApp as JApp
from warpsense_tpu.utils.imu import ImuSample as JImuSample
from warpsense_tpu_torch.interop import params_from_dict
from warpsense_tpu_torch.pipeline import fastsense as tfs
from warpsense_tpu_torch.pipeline.fastsense import FastsenseApp
from warpsense_tpu_torch.utils.imu import ImuSample

N_SCANS = 10
SCAN_DT = 0.05
CFG = {
    "lidar": {"channels": 32, "hresolution": 256},
    "map": {"max_distance": 0.96, "update_distance": 0.3,
            "resolution": 128, "size": {"x": 12.0, "y": 12.0, "z": 6.0},
            "shift": 3.0, "max_weight": 10},
    "registration": {"max_iterations": 200, "epsilon": 0.03,
                     "it_weight_gradient": 0.1},
}
KW = dict(capacity=8192, update_frequency=5, update_distance_m=0.25)


def _walk():
    """(ground truth, scans, map-frame IMU orientations): a walk of 0.1 m
    steps through the box room."""
    gt = walk_trajectory(N_SCANS, step_m=0.1)
    rng = np.random.default_rng(0)
    scans = [render_scan(BoxWorld.default(), p, channels=32, columns=256,
                         max_range=22.0, noise_std=0.01, rng=rng)
             for p in gt]
    quats = [_quat_from_mat(gt[0][:3, :3].T @ p[:3, :3]) for p in gt]
    return gt, scans, quats


def _replay(app, scans, quats, imu_cls, on_scan=None):
    poses, boot = [], None
    for i, (scan, q) in enumerate(zip(scans, quats)):
        stamp = i * SCAN_DT
        app.imu_callback(imu_cls(stamp - 1e-3, np.zeros(3), q))
        poses.append(app.cloud_callback(scan, stamp).copy())
        if boot is None:
            boot = tuple(np.array(x.cpu() if isinstance(x, torch.Tensor)
                                  else x) for x in app.state[:2])
        if on_scan is not None:
            on_scan(i)
        app.sync(timeout=60.0)
    return np.stack(poses), boot


def _ate(gt, est_mm):
    est_m = est_mm.astype(np.float64).copy()
    est_m[:, :3, 3] /= 1000.0
    world = np.einsum("ij,njk->nik", gt[0], est_m)
    return float(np.sqrt(np.mean(np.sum((world[:, :3, 3] - gt[:, :3, 3])
                                        ** 2, axis=1))))


def _rot_err(a, b):
    m = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    v = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v) / 2.0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fastsense")
    jparams = JParams.from_dict(CFG)
    tparams = params_from_dict(dataclasses.asdict(jparams))
    gt, scans, quats = _walk()

    japp = JApp(jparams, map_path=tmp / "jax.h5", **KW)
    jp, jboot = _replay(japp, scans, quats, JImuSample)
    japp.terminate()

    tapp = FastsenseApp(tparams, map_path=tmp / "torch.h5", device="cpu",
                        **KW)
    snaps = []

    def snapshot(i):
        """Before scan i's job runs: the published pair, and a copy of it."""
        with tapp._snap_lock:
            pair = (tapp.state, tapp._fields)
        snaps.append((i, pair, [t.clone() for t in (*pair[0], *pair[1])]))

    fusions = []
    update = tfs.tsdf_update_projective

    def counted(*a, **kw):
        fusions.append(kw["level"])
        return update(*a, **kw)
    tfs.tsdf_update_projective = counted
    try:
        tp, tboot = _replay(tapp, scans, quats, ImuSample, on_scan=snapshot)
    finally:
        tfs.tsdf_update_projective = update
    published = tapp.updates_published
    submitted = tapp._jobs_submitted
    tapp.terminate()
    return dict(gt=gt, jp=jp, tp=tp, jboot=jboot, tboot=tboot, snaps=snaps,
                fusions=fusions, published=published, submitted=submitted,
                path=tmp / "torch.h5", jparams=jparams)


def test_bootstrap_fusion_matches_jax(runs):
    (tv, tw), (jv, jw) = runs["tboot"], runs["jboot"]
    fused = int(((tw != 0) | (jw != 0)).sum())
    n_diff = int(((tv != jv) | (tw != jw)).sum())
    assert fused > 5_000
    assert n_diff <= fused * 1e-3, (n_diff, fused)


def test_poses_match_jax(runs):
    tp, jp, gt = runs["tp"], runs["jp"], runs["gt"]
    assert np.all(np.isfinite(tp))
    for i, (a, b) in enumerate(zip(tp, jp)):
        bound_mm, bound_rad = (0.1, 1e-5) if i < 3 else (60.0, 1e-2)
        assert np.max(np.abs(a[:3, 3] - b[:3, 3])) < bound_mm, i
        assert _rot_err(a, b) < bound_rad, i
    t_ate, j_ate = _ate(gt, tp), _ate(gt, jp)
    assert t_ate < 0.2 and abs(t_ate - j_ate) < 0.01, (t_ate, j_ate)


def test_every_update_is_one_general_fusion(runs):
    """The bootstrap and each worker job fuse once, each binned with the
    sensor attitude (K1's general sweep on the card, its plain version
    here), and each is published."""
    assert runs["submitted"] >= 2
    assert runs["published"] == runs["submitted"] + 1
    assert runs["fusions"] == [False] * runs["published"]


def test_published_snapshot_unchanged_by_later_updates(runs):
    """A registration's (state, fields) snapshot is never written: after
    every later update it still holds the bytes it had when taken, while
    the app's published state moved on."""
    for i, pair, copy in runs["snaps"]:
        now = [*pair[0], *pair[1]]
        for t, c in zip(now, copy):
            assert torch.equal(t, c), i
    first_state = runs["snaps"][0][1][0]
    last_state = runs["snaps"][-1][1][0]
    changed = int((first_state.weight != last_state.weight).sum())
    assert changed > 0


def test_update_without_a_voxel_move_keeps_the_snapshot():
    """``update_frequency=2`` and, after the first, scans from one pose in
    the middle of the first voxel (the gate fires on scans 1, 3 and 5):
    every worker update fires without a shift, so it fuses a clone of the
    published state (``update_ms`` shows a "clone" step and no "shift").
    Each (state, fields) snapshot, taken after ``sync()``, still holds its
    bytes after the later updates, while the published map moved on.
    With ``profile`` each scan's GN iteration count is recorded."""
    params = params_from_dict(dataclasses.asdict(JParams.from_dict(CFG)))
    app = FastsenseApp(params, in_memory_map=True, device="cpu",
                       capacity=8192, update_frequency=2,
                       update_distance_m=0.25, profile=True)
    start = walk_trajectory(1, step_m=0.1)[0]
    held = start.copy()
    held[:3, 3] += start[:3, :3] @ np.full(3, 0.064)   # half a voxel
    rng = np.random.default_rng(1)
    snaps = []
    for i, pose in enumerate([start] + [held] * 6):
        scan = render_scan(BoxWorld.default(), pose, channels=32,
                           columns=256, max_range=22.0, noise_std=0.01,
                           rng=rng)
        app.imu_callback(ImuSample(i * SCAN_DT - 1e-3, np.zeros(3),
                                   np.array([0.0, 0.0, 0.0, 1.0])))
        app.cloud_callback(scan, i * SCAN_DT)
        app.sync(timeout=60.0)
        with app._snap_lock:
            pair = (*app.state, *app._fields)
        snaps.append((pair, [t.clone() for t in pair]))
    app.terminate()
    assert app.updates_published == 4                  # the bootstrap too
    assert [sorted(u) for u in app.update_ms[1:]] == [
        ["clone", "fields", "fusion"]] * 3, app.update_ms
    for i, (pair, copy) in enumerate(snaps):
        assert torch.equal(pair[2], snaps[0][0][2]), i     # no shift
        for t, c in zip(pair, copy):
            assert torch.equal(t, c), i
    assert not torch.equal(snaps[0][0][1], snaps[-1][0][1])
    assert len(app.gn_iterations) == len(snaps)
    assert all(1 <= n <= CFG["registration"]["max_iterations"]
               for n in app.gn_iterations), app.gn_iterations


def test_terminate_persists_for_jax(runs):
    """The port's HDF5 map and poses open in the JAX package's GlobalMap."""
    import h5py

    from warpsense_tpu.map.global_map import GlobalMap
    gm = GlobalMap(runs["path"], 0, truncate=False)
    poses = gm.read_poses()
    gm.close()
    assert len(poses) == N_SCANS
    np.testing.assert_allclose(poses[:, :3], runs["tp"][:, :3, 3] / 1000.0,
                               atol=2e-3)
    with h5py.File(runs["path"], "r") as f:
        assert len(f["/map"].keys()) > 0


def test_runs_on_the_card_unless_told_otherwise():
    """The default device is CUDA: without a GPU it raises, explicit or
    not; with one the app's state lives on the card."""
    params = params_from_dict(dataclasses.asdict(JParams.from_dict(CFG)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            FastsenseApp(params, in_memory_map=True, device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            FastsenseApp(params, in_memory_map=True)
    else:
        app = FastsenseApp(params, in_memory_map=True)
        assert app.state.value.device.type == "cuda"
        app.terminate()
