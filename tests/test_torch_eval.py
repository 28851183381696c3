"""Port vs JAX: the evaluation entry points (eval/slam_eval, eval/pcd2tsdf,
eval/pcd_registration) and the host twins they use (ops/tsdf_reference,
ops/registration_reference), on the CPU.

* slam_eval: the port's CLI with ``--device cpu`` and the JAX CLI run on
  the same arguments in each test; both runs' estimated trajectories are
  captured at their ``_report``, and the port's ``_report`` of the JAX
  trajectory must print the JAX CLI's ATE fields exactly.
  - warpsense: the JAX CLI resolves fusion "auto" to the level-grid Pallas
    kernel on a TPU and to the attitude grid off one; the port's "auto" is
    the level grid (K1's level sweep on the card), so the JAX CLI runs
    here with "auto" resolved to its level-grid XLA twin,
    "projective-level".  The two then differ in the last float32 bits of
    the fast-mode LM only: each scan within 0.01 mm and 1e-6 per rotation
    entry (measured 2.7e-4 mm and 6.0e-8 on 4 scans of 16 x 256), the ATE
    within 1e-5 m (measured 3.6e-8 m, at 0.0170 m).
  - featsense: the F-LOAM odometry solve moves with float32 summation
    order (tests/test_torch_featsense.py: 5 mm a solve, measured 2.5 mm;
    jitted and op-by-op JAX differ by 0.73 mm), and each pose seeds the
    next, so each scan within 5 mm and 2e-3 per rotation entry (measured
    3.1 mm and 8.9e-4 on 3 scans of 32 x 256) and the ATE within 1 mm
    (measured 0.0033 vs 0.0025 m).
* pcd2tsdf: the ray march is exact, so the port's device volume equals
  the host twin (agreement 1.0) and the JAX volume (byte-equal PLY).
* pcd_registration: the port recovers each perturbation like the JAX
  harness, within 1 mm of its mean re-projection error (measured: within
  1.3e-4 mm in every case).
"""
import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

from warpsense_tpu.eval import pcd2tsdf as jp2t
from warpsense_tpu.eval import pcd_registration as jreg
from warpsense_tpu.eval import slam_eval as jse
from warpsense_tpu_torch.eval import pcd2tsdf as tp2t
from warpsense_tpu_torch.eval import pcd_registration as treg
from warpsense_tpu_torch.eval import slam_eval as tse

TAU, RES, SIZE = 900, 256, (31, 31, 31)


def _small_cloud(res=RES, half=3000, n_per_wall=300, seed=0):
    """Voxel centers on the six walls of a cube (mm), as
    tests/test_eval_harnesses.py builds them."""
    rng = np.random.default_rng(seed)
    pts = []
    for ax in range(3):
        for s in (-1, 1):
            p = rng.uniform(-half, half, (n_per_wall, 3))
            p[:, ax] = s * half
            pts.append(p)
    mm = np.concatenate(pts).astype(np.int64)
    vox = mm // res
    _, keep = np.unique(vox, axis=0, return_index=True)
    return vox[np.sort(keep)] * res + res // 2


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _cli_runs(monkeypatch, capsys, tmp_path, args):
    """Both CLIs on ``args`` (the port's with ``--device cpu``); returns
    ``{"torch"|"jax": (printed report, estimate, truth, times)}``."""
    runs = {}
    for name, mod, extra in (
            ("torch", tse, ["--device", "cpu", "--in-memory-map"]),
            ("jax", jse, ["--map-out", str(tmp_path / "jax.h5")])):
        seen = {}
        report = mod._report

        def capture(est, truth, times, *a, **kw):
            seen.update(est=np.array(est), truth=np.stack(truth),
                        times=list(times))
            return report(est, truth, times, *a, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(mod, "_report", capture)
            out = mod.main(args + extra)
        printed = _last_json(capsys)
        if out is not None:
            assert out == printed
        runs[name] = (printed, seen["est"], seen["truth"], seen["times"])
    return runs


def _hold_cli_to_jax(runs, *, mm, rot, ate_m):
    """Per-scan poses within ``mm`` / ``rot``, ATE within ``ate_m``, and the
    port's report of the JAX trajectory equal to the JAX CLI's."""
    from warpsense_tpu_torch.io.trajectory import ate_rmse
    t, t_est, t_truth, _ = runs["torch"]
    j, j_est, j_truth, j_times = runs["jax"]
    np.testing.assert_array_equal(t_truth, j_truth)
    assert np.all(np.isfinite(t_est)) and t["scans_per_s"] > 0
    d_mm = np.abs(t_est[:, :3, 3] - j_est[:, :3, 3]).max(axis=1) * 1000.0
    assert d_mm.max() < mm, d_mm
    assert np.abs(t_est[:, :3, :3] - j_est[:, :3, :3]).max() < rot
    t_ate, j_ate = (ate_rmse(e, t_truth, align=True) for e in (t_est, j_est))
    assert abs(t_ate - j_ate) < ate_m, (t_ate, j_ate)
    keys = ("frames", "ate_rmse_m", "ate_rmse_raw_m", "ate_frames")
    for printed, est in ((t, t_est), (j, j_est)):
        again = tse._report(est, list(j_truth), j_times, None)
        assert {k: printed[k] for k in keys} == {k: again[k] for k in keys}
    assert t["pipeline"] == j["pipeline"]


def _same_defaults(port_fn, jax_fn):
    """The run function's keyword defaults that both CLIs have (the apps'
    capacities) are equal."""
    tp, jp = (inspect.signature(f).parameters for f in (port_fn, jax_fn))
    shared = [k for k, p in jp.items()
              if k in tp and p.default is not inspect.Parameter.empty]
    assert shared
    assert {k: tp[k].default for k in shared} == {
        k: jp[k].default for k in shared}


def test_slam_eval_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """warpsense, 4 scans of 16 x 256: the port's CLI against the JAX CLI
    with fusion "auto" on the level grid (see the module docstring)."""
    from warpsense_tpu.pipeline import fusion_backend as jfb
    level = jfb.resolve_fusion
    monkeypatch.setattr(
        jfb, "resolve_fusion", lambda fusion, **kw: level(
            "projective-level" if fusion == "auto" else fusion, **kw))
    runs = _cli_runs(monkeypatch, capsys, tmp_path, [
        "--pipeline", "warpsense", "--frames", "4", "--channels", "16",
        "--columns", "256"])
    assert runs["torch"][0]["ate_frames"] == 4
    _hold_cli_to_jax(runs, mm=0.01, rot=1e-6, ate_m=1e-5)
    _same_defaults(tse.run_warpsense, jse.run_warpsense)


def test_slam_eval_featsense_cli(tmp_path, capsys, monkeypatch):
    """featsense, 3 scans of 32 x 256: the port's CLI against the JAX CLI
    on the same arguments, within the odometry solve's bounds (module
    docstring); both CLIs build the same parameters and capacities."""
    assert (dataclasses.asdict(tse.default_params(32, 256))
            == dataclasses.asdict(jse.default_params(32, 256)))
    runs = _cli_runs(monkeypatch, capsys, tmp_path, [
        "--pipeline", "featsense", "--frames", "3", "--channels", "32",
        "--columns", "256"])
    assert runs["torch"][0]["ate_frames"] == 3
    _hold_cli_to_jax(runs, mm=5.0, rot=2e-3, ate_m=1e-3)
    _same_defaults(tse.run_featsense, jse.run_featsense)


def test_slam_eval_cli_defaults_to_the_card(tmp_path):
    """``--device`` defaults to cuda: without a GPU the run raises, the
    sharded pipeline's too; an unknown pipeline is refused."""
    if not torch.cuda.is_available():
        for pipeline in ("warpsense", "warpsense-sharded"):
            with pytest.raises(RuntimeError, match="cuda"):
                tse.main(["--pipeline", pipeline, "--frames", "3",
                          "--channels", "8", "--columns", "64",
                          "--in-memory-map"])
        for mod in (tp2t, treg):
            with pytest.raises(RuntimeError, match="cuda"):
                mod.run(_small_cloud(), tau=TAU, resolution=RES, size=SIZE)
    with pytest.raises(SystemExit):
        tse.main(["--pipeline", "warpsense-mesh", "--device", "cpu"])


def test_interop_helpers_default_to_the_card():
    """The carry-across helpers (``interop.*_from_numpy``) put the state on
    the card unless the caller asks for the CPU: without a GPU they
    raise; with ``device="cpu"`` they build it on the CPU."""
    from warpsense_tpu_torch import interop
    plane = np.zeros((3, 3, 3), np.int32)
    pts, mask = np.zeros((4, 3), np.float32), np.ones(4, bool)
    helpers = {
        "state": lambda **kw: interop.state_from_numpy(
            plane, plane, [0, 0, 0], [1, 1, 1], **kw).value,
        "packed": lambda **kw: interop.packed_fields_from_numpy(
            plane, **kw).plane,
        "exact": lambda **kw: interop.packed_fields_from_numpy(
            plane, plane, **kw).plane_b,
        "parity": lambda **kw: interop.registration_fields_from_numpy(
            plane, plane, plane, **kw).gz,
        "feature_map": lambda **kw: interop.feature_map_from_numpy(
            pts, mask, **kw).points,
        "odometry": lambda **kw: interop.odom_estimation_from_numpy(
            (pts, mask), (pts, mask), np.eye(4), np.eye(4), 0, False,
            edge_map_capacity=4, surf_map_capacity=4, **kw).edge_map.points,
    }
    for name, make in helpers.items():
        if torch.cuda.is_available():
            assert make().device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                make()
        assert make(device="cpu").device.type == "cpu", name


def test_slam_eval_sharded_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """``--pipeline warpsense-sharded``, 4 scans of 16 x 256, as a world of
    one against the JAX CLI on its 8-device CPU mesh (a 392-voxel x extent
    there, 391 here), within the registration tolerance; and at a world
    of one the port's sharded run is its warpsense run, bit for bit."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    args = ["--frames", "4", "--channels", "16", "--columns", "256"]
    runs = _cli_runs(monkeypatch, capsys, tmp_path,
                     ["--pipeline", "warpsense-sharded"] + args)
    t = runs["torch"][0]
    assert (t["rank"], t["world"], t["ate_frames"]) == (0, 1, 4)
    _hold_cli_to_jax(runs, mm=0.5, rot=1e-4, ate_m=1e-3)
    plain = _cli_runs(monkeypatch, capsys, tmp_path,
                      ["--pipeline", "warpsense"] + args)
    np.testing.assert_array_equal(runs["torch"][1], plain["torch"][1])


def test_slam_eval_from_a_bag_with_tum_ground_truth(tmp_path, capsys):
    """The bag path: frames from a rosbag, ground truth associated by
    nearest timestamp from a TUM file, the same stats as the synthetic
    run of the same scans; ``--tum-out`` writes the estimate."""
    from warpsense_tpu_torch.io.dataset import SyntheticDataset
    from warpsense_tpu_torch.io.rosbag import BagWriter
    from warpsense_tpu_torch.io.trajectory import (ate_rmse, read_tum,
                                                   write_tum)

    synth = list(SyntheticDataset(3, channels=16, columns=256))
    with BagWriter(tmp_path / "seq.bag") as w:
        for fr in synth:
            w.write_pointcloud2("/os_cloud_node/points", fr.stamp + 1e-3,
                                fr.cloud)
    write_tum(tmp_path / "gt.tum", np.stack([f.ground_truth for f in synth]),
              np.array([f.stamp for f in synth]))
    common = ["--channels", "16", "--columns", "256", "--device", "cpu",
              "--in-memory-map"]
    bag = tse.main(["--bag", str(tmp_path / "seq.bag"), "--tum-gt",
                    str(tmp_path / "gt.tum"), "--tum-out",
                    str(tmp_path / "est.tum")] + common)
    synth_stats = tse.main(["--frames", "3"] + common)
    capsys.readouterr()
    assert bag["ate_frames"] == 3
    assert abs(bag["ate_rmse_m"] - synth_stats["ate_rmse_m"]) < 2e-3
    stamps, est = read_tum(tmp_path / "est.tum")
    np.testing.assert_allclose(stamps, [f.stamp + 1e-3 for f in synth],
                               atol=1e-6)
    assert abs(ate_rmse(est, np.stack([f.ground_truth for f in synth]))
               - bag["ate_rmse_m"]) < 1e-3


def test_pcd2tsdf_device_matches_host_twin_and_jax(tmp_path):
    cloud = _small_cloud()
    kw = dict(tau=TAU, resolution=RES, size=SIZE, host_compare_points=128)
    t = tp2t.run(cloud, out_dir=str(tmp_path / "t"), device="cpu", **kw)
    j = jp2t.run(cloud, out_dir=str(tmp_path / "j"), **kw)
    assert t["touched_voxels_device"] > 100
    assert t["exact_agreement"] == 1.0, t
    for k in ("points", "touched_voxels_device", "compare_points",
              "touched_voxels_host", "exact_agreement", "value_mad_mm"):
        assert t[k] == j[k], k
    assert ((tmp_path / "t" / "tsdf_device.ply").read_bytes()
            == (tmp_path / "j" / "tsdf_device.ply").read_bytes())


def test_pcd_tools_cli_on_a_pcd_file(tmp_path, capsys):
    """Both CLIs read a PCD file, demean and voxel-subsample it like the
    JAX ones, and print one JSON line."""
    from warpsense_tpu_torch.io.pcd import write_pcd
    cloud_m = _small_cloud(res=64, n_per_wall=60).astype(np.float32) / 1e3
    write_pcd(tmp_path / "c.pcd", cloud_m + np.float32(5.0))
    common = ["--pcd", str(tmp_path / "c.pcd"), "--tau", str(TAU),
              "--resolution", str(RES)]
    t = tp2t.main(common + ["--device", "cpu"])
    assert _last_json(capsys) == t
    jt = jp2t.main(common)
    assert t["points"] == _last_json(capsys)["points"] and t["points"] > 100
    assert t["exact_agreement"] == 1.0
    r = treg.main(common + ["--device", "cpu"])
    assert _last_json(capsys) == r
    assert r["idle"]["avg"] < 20.0
    del jt


def test_pcd_registration_recovers_like_jax():
    cloud = _small_cloud()
    kw = dict(tau=TAU, resolution=RES, size=SIZE, max_iterations=60,
              epsilon=0.0, mode="fast")
    t = treg.run(cloud, device="cpu", **kw)
    j = jreg.run(cloud, **kw)
    assert set(t) == set(j) == {"idle", "translation", "rotation",
                                "rotation_inv", "translation+rotation"}
    assert t["idle"]["avg"] < 20.0, t["idle"]
    for name in t:
        assert t[name]["avg"] < 120.0, (name, t[name])
        assert abs(t[name]["avg"] - j[name]["avg"]) < 1.0, (name, t[name],
                                                            j[name])


def _host_maps(size, tau):
    """A host LocalMap from each package, with in-memory global maps."""
    from warpsense_tpu.map.global_map import GlobalMap as JGlobalMap
    from warpsense_tpu.map.local_map import LocalMap as JLocalMap
    from warpsense_tpu_torch.map.global_map import GlobalMap
    from warpsense_tpu_torch.map.local_map import LocalMap
    import tempfile
    from pathlib import Path
    jgm = JGlobalMap(Path(tempfile.mkdtemp()) / "j.h5", tau, 0)
    return LocalMap(size, GlobalMap(None, tau, 0)), JLocalMap(size, jgm)


def test_host_twins_equal_jax():
    """ops/tsdf_reference fuses the same integers as the JAX twin, and
    ops/registration_reference gives the same integer statistics and a
    GN pose within 1e-3 mm / 1e-6 of JAX's."""
    from warpsense_tpu.ops import registration_reference as jrr
    from warpsense_tpu.ops import tsdf_reference as jtr
    from warpsense_tpu_torch.ops import registration_reference as trr
    from warpsense_tpu_torch.ops import tsdf_reference as ttr

    cloud = _small_cloud()[::6]
    up = np.array([0, 0, 1024], np.int64)
    tl, jl = _host_maps(SIZE, TAU)
    for lib, lm in ((ttr, tl), (jtr, jl)):
        lib.update_tsdf_reference(cloud, np.zeros(3, np.int64), up, lm,
                                  tau=TAU, max_weight=32 * 64,
                                  resolution=RES)
    np.testing.assert_array_equal(tl.state.value, jl.state.value)
    np.testing.assert_array_equal(tl.state.weight, jl.state.weight)
    assert int((tl.state.weight != 0).sum()) > 100
    assert tl.value_at([0, 0, 0]) == jl.value_at([0, 0, 0])
    with pytest.raises(IndexError):
        tl.value_at([100, 0, 0])

    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = [120.0, -80.0, 40.0]
    for total in (np.eye(4, dtype=np.float32), pert):
        ts = trr.jacobian_stats(cloud, tl, total, RES)
        js = jrr.jacobian_stats(cloud, jl, total, RES)
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a, b)
    kw = dict(resolution=RES, max_iterations=30, it_weight_gradient=0.1,
              epsilon=0.03)
    tpose = trr.register_cloud_reference(cloud, tl, pert, **kw)
    jpose = jrr.register_cloud_reference(cloud, jl, pert, **kw)
    np.testing.assert_allclose(tpose[:3, 3], jpose[:3, 3], atol=1e-3)
    np.testing.assert_allclose(tpose[:3, :3], jpose[:3, :3], atol=1e-6)
