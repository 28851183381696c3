"""The walk on the CPU: a tiny handheld cell through the whole run against
the frozen reference, the grid counters, the fault of a level grid forced
on every fusion, and the walk's lap and gyro (``mixes/walk.py``)."""
from __future__ import annotations

import copy
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import discover  # noqa: E402
from harness.cell import run_cell  # noqa: E402

from warpsense_tpu_torch.pipeline import fusion_backend  # noqa: E402

walk = discover.generator("walk")
CELL = "tiny.walk"


def walk_root(tmp: Path, *, scans: int = 12) -> tuple[Path, dict]:
    """A directory of tiny data files for the walk, and the BENCHMARK dict
    naming its cell ``tiny.walk``: the handheld configuration with a
    32 x 256 sensor at 90 deg, 64 mm voxels in a 12 x 12 x 4 m window."""
    for sub in ("configs", "mixes", "checks"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((BENCH / "configs" / "handheld_os0.json").read_text())
    cfg["params"]["lidar"].update(channels=32, hresolution=256)
    cfg["params"]["map"].update(size=dict(x=12, y=12, z=4))
    cfg["capacity"] = 1024
    cfg["traffic_args"] = {"lap_scans": 24}
    # no warm-up: the traced window starts at the first scan, whose fusion
    # bins on the level grid (the map frame is its frame)
    cfg["warmup_scans"] = 0
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp / "mixes" / "walk.json").write_text(
        (BENCH / "mixes" / "walk.json").read_text())
    (tmp / "checks" / f"{CELL}.json").write_text(json.dumps(
        {"scans": scans, "free_scans": 3,
         "limits": {"pose_gap_median_mm": 0.0, "pose_gap_p90_mm": 0.0,
                    "map_differ_share": 0.0}}))
    bench = copy.deepcopy(json.loads((BENCH.parent / "BENCHMARK.json")
                                     .read_text()))
    bench["workloads"] = [{"name": CELL, "config": "tiny", "traffic": "walk",
                           "chips": 1, "why": "CPU rehearsal"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return tmp, bench


@pytest.fixture(scope="module")
def traced_walk(tmp_path_factory):
    root, bench = walk_root(tmp_path_factory.mktemp("walk"))
    yield run_cell(bench, CELL, seed=2 ** 31 + 18, seconds=15.0, trace=True,
                   device="cpu", root=root)
    # the CPU run's chrome trace runs to hundreds of MB
    (BENCH / "out" / f"trace_{CELL}.json").unlink(missing_ok=True)


def test_a_tiny_walk_is_correct(traced_walk):
    r = traced_walk
    assert r["attempted"] >= 12 and r["failed"] == 0
    assert r["correct"] is True
    assert r["check"]["map_differ_share"] == [0.0, 0.0]
    for name in ("fusion_table_ms", "fusion_sweep_ms", "fusion_ms"):
        assert r["metrics"][name]["value"] > 0.0


def test_both_grids_count_and_the_attitude_grid_outnumbers_the_level(
        traced_walk):
    from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator
    c = RuntimeEvaluator.get_instance().counters()
    level, attitude = c["fusion_grid_level"], c["fusion_grid_attitude"]
    assert 0 < level < attitude
    share = traced_walk["metrics"]["attitude_fusion_pct"]["value"]
    assert share == pytest.approx(100.0 * attitude / (level + attitude))
    # each fused scan timed its table and its sweep, inside "tsdf"
    spans = RuntimeEvaluator.get_instance()._forms
    fusions = spans["tsdf"].count
    assert spans["tsdf.table"].count == spans["tsdf.sweep"].count == fusions
    assert level + attitude == fusions
    assert spans["tsdf.table"].sum + spans["tsdf.sweep"].sum \
        <= spans["tsdf"].sum


def test_a_level_grid_forced_on_every_fusion_is_not_correct(tmp_path,
                                                            monkeypatch):
    # 24 scans: the tiny sensor's tracker keeps the first dozen scans'
    # fusions on the level grid, where forcing it changes nothing
    root, bench = walk_root(tmp_path, scans=24)

    def level_grid(app):
        monkeypatch.setattr(fusion_backend, "grid_rotation_for",
                            lambda pose, vfov, budget=None:
                            (torch.eye(3, dtype=torch.float32), True))
    r = run_cell(bench, CELL, seed=2 ** 31 + 19, seconds=15.0, trace=False,
                 device="cpu", root=root, sabotage=level_grid)
    assert r["attempted"] >= 12
    assert r["correct"] is False
    share, limit = r["check"]["map_differ_share"]
    assert share > limit


def _mix():
    return discover.mix("walk")


def test_the_walk_closes_its_lap():
    """The gait's phases come round whole at the lap's end, and the step
    from the last scan to the first is a step of the walk like the
    others."""
    mix = _mix()
    poses = walk.walk_poses(mix)
    n, scan_ms = len(poses), int(mix["scan_ms"])
    for a, b in zip(walk.gait(mix["gait"], n, n, scan_ms),
                    walk.gait(mix["gait"], 0, n, scan_ms)):
        assert a == pytest.approx(b, abs=1e-12)
    ring = np.concatenate([poses, poses[:1]])
    moves = np.linalg.norm(np.diff(ring[:, :3, 3], axis=0), axis=1)
    turns = [math.acos(np.clip((np.trace(ring[k + 1, :3, :3]
                                         @ ring[k, :3, :3].T) - 1) / 2,
                               -1, 1)) for k in range(n)]
    assert moves[-1] == pytest.approx(mix["lap"]["step_m"], rel=0.05)
    assert moves.min() <= moves[-1] <= moves.max()
    assert turns[-1] <= max(turns[:-1])
    # the first scan: phase 0, pitch 4 deg and roll 0 deg on the lap's yaw
    pitch, roll, dz = walk.gait(mix["gait"], 0, n, scan_ms)
    assert (math.degrees(pitch), roll, dz) == (4.0, 0.0, 0.0)


def test_the_gyro_turns_each_attitude_into_the_next_about_three_axes():
    """Integrated over a scan's interval, the gyro turns each scan's
    attitude into the next about the sensor's own axes, as a built-in
    IMU reports it: ``R_k = R_{k-1} exp(w dt)``."""
    mix = _mix()
    poses = walk.walk_poses(mix)
    dt = int(mix["scan_ms"]) / 1000.0
    gyro = walk.body_gyro(poses, int(mix["scan_ms"]))
    rel = np.linalg.inv(poses[0])[None] @ poses
    for k in range(len(rel)):
        w = gyro[k] * dt
        angle = float(np.linalg.norm(w))
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                      [-w[1], w[0], 0]]) / max(angle, 1e-300)
        turn = np.eye(3) + math.sin(angle) * K \
            + (1 - math.cos(angle)) * K @ K
        np.testing.assert_allclose(rel[k - 1, :3, :3] @ turn, rel[k, :3, :3],
                                   atol=1e-9)
    # every axis turns by more than a degree a second somewhere
    assert np.all(np.degrees(np.abs(gyro).max(axis=0)) > 1.0)
    # and the walk tilts past the level grid's 2 degrees on most scans
    tilt = np.degrees(np.arccos(np.clip(rel[:, 2, 2], -1, 1)))
    assert 0.6 < np.mean(tilt > 2.0) < 1.0
