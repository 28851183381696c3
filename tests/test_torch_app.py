"""Port vs JAX: the fast-mode WarpsenseApp end to end on the CPU.

Both apps run the same synthetic scans (16 x 128 beams, 128 mm voxels)
with fusion pinned to the level grid ("projective-level" — JAX's "auto"
would pick the attitude grid off a TPU) and synchronous shifts (the async
worker's timing decides which scans queue their fusion).  Registration
differs in the last bits (see tests/test_torch_registration.py) and that
feeds back through fusion, so per-scan poses are held within the
registration test's 0.5 mm and 1e-4 rad (measured: under 0.01 mm and
3e-6 rad over six scans) and the maps to 99% identical voxels (measured:
99.9%)."""
import dataclasses
import shutil

import numpy as np
import pytest

from warpsense_tpu.core.config import Params as JParams
from warpsense_tpu.io.synthetic import BoxWorld, render_scan, walk_trajectory
from warpsense_tpu.pipeline.warpsense import WarpsenseApp as JApp
from warpsense_tpu_torch.interop import params_from_dict
from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp

CFG = {
    "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
            "size": {"x": 20, "y": 16, "z": 7}, "shift": 0.18,
            "update_distance": 0.05},
    "registration": {"max_iterations": 20, "epsilon": 0.03,
                     "it_weight_gradient": 0.1, "mode": "fast"},
    "lidar": {"channels": 16, "hresolution": 128},
}
KW = dict(capacity=2048, fusion="projective-level", sync_shift=True)


def _scans(n, seed=0, start=0):
    world = BoxWorld.default()
    rng = np.random.default_rng(seed)
    gt = walk_trajectory(start + n, step_m=0.1)[start:]
    return [render_scan(world, p, channels=16, columns=128, noise_std=0.002,
                        rng=rng) for p in gt]


def _rot_err(a, b):
    m = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    v = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v) / 2.0)))


def _run(app, scans, t0=0.0):
    poses = [app.cloud_callback(s, t0 + 0.1 * i) for i, s in enumerate(scans)]
    return np.stack(poses)


def _assert_close(tp, jp):
    for i, (a, b) in enumerate(zip(tp, jp)):
        assert np.max(np.abs(a[:3, 3] - b[:3, 3])) < 0.5, (i, a, b)
        assert _rot_err(a, b) < 1e-4, i


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("app")
    jparams = JParams.from_dict(CFG)
    tparams = params_from_dict(dataclasses.asdict(jparams))
    scans = _scans(6)
    japp = JApp(jparams, map_path=tmp / "jax.h5", **KW)
    tapp = WarpsenseApp(tparams, map_path=tmp / "torch.h5", device="cpu",
                        **KW)
    jp, tp = _run(japp, scans), _run(tapp, scans)
    out = dict(jp=jp, tp=tp, tmp=tmp, jparams=jparams, tparams=tparams,
               jpos=np.asarray(japp.state.pos), tpos=tapp.state.pos.numpy(),
               jv=np.asarray(japp.state.value),
               tv=tapp.state.value.numpy(),
               jw=np.asarray(japp.state.weight),
               tw=tapp.state.weight.numpy())
    japp.terminate()
    tapp.terminate()
    return out


def test_app_poses_match_jax(runs):
    assert np.all(np.isfinite(runs["tp"]))
    _assert_close(runs["tp"], runs["jp"])
    # the walk crossed the shift gate: the window moved in both
    assert np.any(runs["tpos"] != 0)
    np.testing.assert_array_equal(runs["tpos"], runs["jpos"])


def test_app_maps_close_to_jax(runs):
    """Same window after the shifts; fused content agrees except where a
    sub-mm pose difference could move a voxel across a bin edge."""
    both = (runs["tw"] != 0) | (runs["jw"] != 0)
    same = (runs["tv"] == runs["jv"]) & (runs["tw"] == runs["jw"])
    assert both.sum() > 10_000
    assert np.mean(same[both]) > 0.99


def test_resume_from_jax_map(runs):
    """A map file the JAX app persisted resumes in the port: the window
    reloads around the last pose and tracking continues like a JAX resume
    of the same file."""
    tmp = runs["tmp"]
    shutil.copy(tmp / "jax.h5", tmp / "for_jax.h5")
    shutil.copy(tmp / "jax.h5", tmp / "for_torch.h5")
    more = _scans(3, seed=1, start=6)
    japp = JApp(runs["jparams"], map_path=tmp / "for_jax.h5", resume=True,
                **KW)
    tapp = WarpsenseApp(runs["tparams"], map_path=tmp / "for_torch.h5",
                        resume=True, device="cpu", **KW)
    np.testing.assert_array_equal(tapp.pose, japp.pose)
    np.testing.assert_array_equal(tapp.state.value.numpy(),
                                  np.asarray(japp.state.value))
    np.testing.assert_array_equal(tapp.state.weight.numpy(),
                                  np.asarray(japp.state.weight))
    jp, tp = _run(japp, more, 0.6), _run(tapp, more, 0.6)
    japp.terminate()
    tapp.terminate()
    _assert_close(tp, jp)


def test_parity_mode_and_missing_gpu_raise():
    params = params_from_dict(dataclasses.asdict(JParams.from_dict(CFG)))
    params.registration.mode = "parity"
    with pytest.raises(NotImplementedError, match="8"):
        WarpsenseApp(params, in_memory_map=True)
    params.registration.mode = "fast"
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            WarpsenseApp(params, in_memory_map=True, device="cuda")


def _ate(poses, gt):
    """Translation RMSE (m) against ground truth in the first sensor frame."""
    inv0 = np.linalg.inv(gt[0])
    err = [p[:3, 3] / 1000.0 - (inv0 @ g)[:3, 3] for p, g in zip(poses, gt)]
    return float(np.sqrt(np.mean(np.sum(np.square(err), axis=1))))


def test_async_shift_tracks_like_sync():
    """The default async shift: a worker shifts a clone of the window while
    registration keeps the current one; scans that want fusion meanwhile
    are queued and fused after the swap.  Which scans queue depends on
    thread timing, so the run is held to ground truth like the synchronous
    one (measured ATE ~0.06 m for both at this coarse 128 mm, 16 x 128
    setup) rather than to its poses."""
    params = params_from_dict(dataclasses.asdict(JParams.from_dict(CFG)))
    scans = _scans(6)
    gt = walk_trajectory(6, step_m=0.1)
    ate = {}
    for sync in (False, True):
        app = WarpsenseApp(params, in_memory_map=True, device="cpu",
                           **dict(KW, sync_shift=sync))
        ate[sync] = _ate(_run(app, scans), gt)
        app.terminate()
        assert np.any(app.state.pos.numpy() != 0)
    assert ate[True] < 0.1
    assert ate[False] < ate[True] + 0.03, ate
