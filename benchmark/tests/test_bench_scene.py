"""The benchmark's scene and traffic (CPU)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import scene  # noqa: E402


def _slabs(world) -> np.ndarray:
    """A BoxWorld's room as six solid slabs outside its walls, plus its
    pillars: rays from inside enter a slab where they leave the room."""
    lo, hi = world.room.lo, world.room.hi
    out = []
    for ax in range(3):
        a_lo, a_hi = lo.copy() - 1.0, hi.copy() + 1.0
        a_hi[ax] = lo[ax]
        out.append(np.concatenate([a_lo, a_hi]))
        b_lo, b_hi = lo.copy() - 1.0, hi.copy() + 1.0
        b_lo[ax] = hi[ax]
        out.append(np.concatenate([b_lo, b_hi]))
    out += [np.concatenate([p.lo, p.hi]) for p in world.pillars]
    return np.stack(out)


def test_torch_ray_cast_agrees_with_render_scan_on_a_box_world_pose():
    from warpsense_tpu_torch.io.synthetic import BoxWorld, render_scan
    world = BoxWorld.default()
    pose = np.eye(4)
    c, s = np.cos(0.4), np.sin(0.4)
    pose[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    pose[:3, 3] = [1.3, -0.7, 0.3]
    want = render_scan(world, pose, channels=32, columns=256)
    dirs = torch.as_tensor(scene.ray_directions(32, 256, 45.0))
    got = scene.render_scans(torch.as_tensor(_slabs(world)),
                             torch.as_tensor(pose[None]), dirs,
                             max_range=50.0, noise_std=0.0,
                             generator=None)[0].numpy()
    assert got.shape == want.shape
    assert np.array_equal(got == 0, want == 0)
    assert np.abs(got - want).max() < 1e-5


def test_torch_ray_cast_agrees_with_its_numpy_original_in_the_car_park():
    mix = json.loads((BENCH / "mixes" / "drive.json").read_text())
    boxes = scene.car_park(mix["scene"])
    poses = scene.lap_poses(mix["lap"])
    for k in (0, 300, 700):
        want = scene.render_scan_np(boxes, poses[k], channels=16,
                                    columns=128, vfov_deg=45.0)
        got = scene.render_scans(
            torch.as_tensor(boxes), torch.as_tensor(poses[k][None]),
            torch.as_tensor(scene.ray_directions(16, 128, 45.0)),
            max_range=50.0, noise_std=0.0, generator=None)[0].numpy()
        assert np.array_equal(got, want)
        assert (np.abs(want).sum(-1) > 0).mean() > 0.3


def _traffic(seed, mix="drive", lap_scans=6):
    from harness import discover
    gen = discover.generator("lap")
    m = json.loads((BENCH / "mixes" / f"{mix}.json").read_text())
    lidar = {"channels": 16, "hresolution": 128, "vfov": 45.0}
    return gen.make(m, seed, lidar, torch.device("cpu"), lap_scans=lap_scans)


def test_scans_are_identical_for_a_seed_and_differ_between_seeds():
    a, b, c = _traffic(2 ** 33 + 1), _traffic(2 ** 33 + 1), _traffic(5)
    assert [a.lap_index(g) for g in (0, 1, len(a))] == [0, 1, 0]
    assert np.array_equal(a.scans, b.scans)
    assert not np.array_equal(a.scans, c.scans)
    for g in range(4):
        for (ta, wa), (tb, wb) in zip(a.imu(g), b.imu(g)):
            assert ta == tb and np.array_equal(wa, wb)


def test_stamps_and_gyro_follow_the_lap():
    t = _traffic(3, mix="hold", lap_scans=None)
    n = len(t)
    assert n == 79
    assert t.stamp(10) == 1.0
    imu = t.imu(10)
    assert len(imu) == 10 and imu[-1][0] == t.stamp(10)
    # the circle turns by 2 pi over the lap, about z
    w = np.stack([t.gyro[k] for k in range(n)])
    assert np.allclose(w[:, :2], 0.0, atol=1e-9)
    assert abs(w[:, 2].sum() * 0.1 - 2 * np.pi) < 1e-6
    # a replayed lap starts over
    assert t.lap_index(n + 4) == t.lap_index(4)


def test_drive_lap_is_closed_and_at_least_120_m():
    mix = json.loads((BENCH / "mixes" / "drive.json").read_text())
    poses = scene.lap_poses(mix["lap"])
    steps = np.linalg.norm(np.diff(np.concatenate(
        [poses[:, :3, 3], poses[:1, :3, 3]]), axis=0), axis=1)
    assert steps.sum() >= 120.0
    assert np.allclose(steps, 0.12, atol=1e-3)
