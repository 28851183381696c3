"""Port vs JAX: the featsense pipeline end to end on the CPU.

Both apps run the same six synthetic OS1 scans (32 x 512 beams, 128 mm
voxels) along a trajectory with translation and yaw, with the default
"raymarch" fusion (bit-exact between the two, tests/test_torch_raymarch.py).

Tolerances: the F-LOAM odometry solve is sensitive to float32 summation
order (tests/test_torch_featsense.py), and each scan's pose seeds the next
one's, so per-scan F-LOAM poses are held within 50 mm and 1e-2 per rotation
entry (measured 25.7 mm and 2.7e-3, while both apps' F-LOAM poses are 40 to
60 mm off the truth); the VGICP-refined mapping poses, which are what the
back end fuses and persists, within 2 mm (measured 0.65 mm); both apps
track the truth within the JAX test's 0.12 m."""
import dataclasses

import numpy as np
import pytest

from warpsense_tpu.core.config import Params as JParams
from warpsense_tpu.io.synthetic import BoxWorld, render_scan
from warpsense_tpu.pipeline.featsense import FeatsenseApp as JApp
from warpsense_tpu_torch.interop import params_from_dict
from warpsense_tpu_torch.pipeline.featsense import (FeatsenseApp,
                                                    ThreadedFeatsenseRunner)

CFG = {
    "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
            "size": {"x": 24, "y": 20, "z": 8}, "shift": 8.0,
            "update_distance": 0.08},
    "floam": {"min_distance": 0.5, "max_distance": 40.0,
              "edge_threshold": 0.5, "surf_threshold": 0.05,
              "edge_resolution": 0.15, "optimization_steps": 3,
              "enrich": 4, "vgicp_fitness_score": 6.0},
    "lidar": {"channels": 32, "hresolution": 512},
}
KW = dict(edge_capacity=512, surf_capacity=1024, cloud_capacity=4096,
          odom_kwargs=dict(edge_map_capacity=2048, surf_map_capacity=4096))


def _trajectory(n, step=0.12):
    poses = np.zeros((n, 4, 4))
    for i in range(n):
        c, s = np.cos(0.02 * i), np.sin(0.02 * i)
        poses[i] = np.eye(4)
        poses[i][:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        poses[i][:3, 3] = [step * i, 0.04 * i, 0.0]
    return poses


@pytest.fixture(scope="module")
def data():
    truth = _trajectory(6)
    rng = np.random.default_rng(0)
    scans = [render_scan(BoxWorld.default(), p, channels=32, columns=512,
                         noise_std=0.003, rng=rng) for p in truth]
    jparams = JParams.from_dict(CFG)
    return scans, truth, jparams, params_from_dict(dataclasses.asdict(jparams))


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    scans, _, jparams, tparams = data
    japp = JApp(jparams, map_path=tmp_path_factory.mktemp("fs") / "jax.h5",
                **KW)
    tapp = FeatsenseApp(tparams, in_memory_map=True, profile=True,
                        device="cpu", **KW)
    jp = np.stack([japp.process_scan(s) for s in scans])
    tp = np.stack([tapp.process_scan(s) for s in scans])
    out = dict(jp=jp, tp=tp, jgicp=np.stack(japp.mapping.gicp_path),
               tgicp=np.stack(tapp.mapping.gicp_path),
               jw=np.asarray(japp.mapping.state.weight),
               tw=tapp.mapping.state.weight.numpy(),
               jv=np.asarray(japp.mapping.state.value),
               tv=tapp.mapping.state.value.numpy(),
               spans={r["task"]: r["count"] for r in tapp.eval.to_rows()})
    japp.terminate()
    tapp.terminate()
    return out


def test_featsense_app_poses_match_jax(runs, data):
    tp, jp = runs["tp"], runs["jp"]
    assert np.all(np.isfinite(tp))
    for i, (a, b) in enumerate(zip(tp, jp)):
        assert np.max(np.abs(a[:3, 3] - b[:3, 3])) < 0.05, i
        assert np.max(np.abs(a[:3, :3] - b[:3, :3])) < 1e-2, i
    assert len(runs["tgicp"]) == len(runs["jgicp"]) == 5
    assert np.max(np.abs(runs["tgicp"][:, :3, 3]
                         - runs["jgicp"][:, :3, 3])) < 2e-3
    truth = data[1]
    for poses in (tp, jp):
        assert np.linalg.norm(poses[-1][:3, 3] - truth[-1][:3, 3]) < 0.12


def test_featsense_maps_close_to_jax(runs):
    both = (runs["tw"] != 0) | (runs["jw"] != 0)
    same = (runs["tv"] == runs["jv"]) & (runs["tw"] == runs["jw"])
    assert both.sum() > 100_000
    assert np.mean(same[both]) > 0.8          # measured 0.857


def test_featsense_spans(runs):
    for name in ("total", "features", "odometry", "mapping"):
        assert runs["spans"][name] >= 6, runs["spans"]


def test_featsense_auto_fusion_tracks(data):
    """fusion="auto" (the level-grid projective update, kernel K1 on a
    card) in the back end."""
    scans, truth, _, tparams = data
    app = FeatsenseApp(tparams, in_memory_map=True, fusion="auto",
                       device="cpu", **KW)
    poses = [app.process_scan(s) for s in scans[:4]]
    app.terminate()
    assert np.linalg.norm(poses[-1][:3, 3] - truth[3][:3, 3]) < 0.12
    assert int((app.mapping.state.weight != 0).sum()) > 100_000


def test_threaded_runner_matches_sequential(data, tmp_path):
    scans, _, _, tparams = data
    seq = FeatsenseApp(tparams, in_memory_map=True, device="cpu", **KW)
    for scan in scans[:4]:
        seq.process_scan(scan)
    thr_app = FeatsenseApp(tparams, in_memory_map=True, device="cpu",
                           **KW)
    runner = ThreadedFeatsenseRunner(thr_app, viz_path=str(tmp_path / "t.tum"))
    runner.start()
    for i, scan in enumerate(scans[:4]):
        runner.submit(scan, float(i))
    runner.drain()
    assert not any(t.is_alive() for t in runner._threads)
    np.testing.assert_array_equal(seq.trajectory(), thr_app.trajectory())
    np.testing.assert_array_equal(seq.mapping.state.value.numpy(),
                                  thr_app.mapping.state.value.numpy())
    assert len(runner.path) == 4
    lines = (tmp_path / "t.tum").read_text().splitlines()
    assert len(lines) == 4 and len(lines[0].split()) == 8
    seq.terminate()
    thr_app.terminate()


def test_default_device_is_the_card(data):
    """FeatsenseApp and FeatsenseMapping run on the card unless told
    otherwise: without a GPU their default device raises."""
    import torch

    from warpsense_tpu_torch.pipeline.featsense import FeatsenseMapping
    tparams = data[3]
    if torch.cuda.is_available():
        app = FeatsenseApp(tparams, in_memory_map=True, **KW)
        assert app.device.type == "cuda"
        assert app.mapping.device.type == "cuda"
        app.terminate()
        return
    with pytest.raises(RuntimeError, match="cuda"):
        FeatsenseApp(tparams, in_memory_map=True, **KW)
    with pytest.raises(RuntimeError, match="cuda"):
        FeatsenseMapping(tparams, in_memory_map=True)


def test_mapping_gates_on_update_distance(data):
    scans, _, _, tparams = data
    app = FeatsenseApp(tparams, in_memory_map=True, device="cpu", **KW)
    app.process_scan(scans[0])
    assert app.mapping.initialized
    flat = np.ascontiguousarray(scans[0].reshape(-1, 3))
    assert app.mapping.process(flat, np.any(flat != 0, axis=1),
                               np.eye(4)) is None
    app.terminate()


def test_featsense_resume_from_jax_map(data, tmp_path):
    """A featsense map the JAX app persisted resumes in the port: the same
    pose offset and the same reloaded window as a JAX resume."""
    import shutil

    from warpsense_tpu.pipeline.featsense import \
        FeatsenseMapping as JMapping
    from warpsense_tpu_torch.pipeline.featsense import FeatsenseMapping
    scans, _, jparams, tparams = data
    japp = JApp(jparams, map_path=tmp_path / "jax.h5",
                fusion="projective-level", **KW)
    for scan in scans[:3]:
        japp.process_scan(scan)
    japp.terminate()
    shutil.copy(tmp_path / "jax.h5", tmp_path / "for_torch.h5")
    jm = JMapping(jparams, tmp_path / "jax.h5", resume=True,
                  fusion="projective-level")
    tm = FeatsenseMapping(tparams, tmp_path / "for_torch.h5", resume=True,
                          fusion="projective-level", device="cpu")
    assert np.any(tm.pose_offset[:3, 3] != 0)
    np.testing.assert_array_equal(tm.pose_offset, jm.pose_offset)
    np.testing.assert_array_equal(tm.state.pos.numpy(),
                                  np.asarray(jm.state.pos))
    np.testing.assert_array_equal(tm.state.value.numpy(),
                                  np.asarray(jm.state.value))
    np.testing.assert_array_equal(tm.state.weight.numpy(),
                                  np.asarray(jm.state.weight))
    assert int((tm.state.weight != 0).sum()) > 10_000
    jm.terminate()
    tm.terminate()


def test_featsense_shift_matches_jax(data, tmp_path):
    """A 0.2 m shift gate moves the back end's window during four scans:
    the port's synchronous slab shift reaches JAX's window, and the maps
    agree as in test_featsense_maps_close_to_jax."""
    scans, _, jparams, _ = data
    jparams = dataclasses.replace(
        jparams, map=dataclasses.replace(jparams.map, shift=0.2))
    tparams = params_from_dict(dataclasses.asdict(jparams))
    japp = JApp(jparams, map_path=tmp_path / "jax.h5",
                fusion="projective-level", **KW)
    tapp = FeatsenseApp(tparams, in_memory_map=True,
                        fusion="projective-level", device="cpu", **KW)
    for scan in scans[:4]:
        japp.process_scan(scan)
        tapp.process_scan(scan)
    jm, tm = japp.mapping, tapp.mapping
    assert np.any(tm.state.pos.numpy() != 0)
    np.testing.assert_array_equal(tm.state.pos.numpy(),
                                  np.asarray(jm.state.pos))
    np.testing.assert_array_equal(tm.state.offset.numpy(),
                                  np.asarray(jm.state.offset))
    tw, jw = tm.state.weight.numpy(), np.asarray(jm.state.weight)
    both = (tw != 0) | (jw != 0)
    same = (tm.state.value.numpy() == np.asarray(jm.state.value)) & (tw == jw)
    assert both.sum() > 100_000
    assert np.mean(same[both]) > 0.8          # measured 0.885
    japp.terminate()
    tapp.terminate()
