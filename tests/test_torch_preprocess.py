"""Port vs JAX: scan preprocessing (snap, dedup, compaction, fixed-point
transform) is bit-exact in both ``snap`` modes.  The capacity exceeds the
unique-voxel count, so duplicates, the dropped tail and the first-point
choice per voxel (snap=False) are all exercised."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.core.geometry import rodrigues
from warpsense_tpu.io.synthetic import BoxWorld, render_scan, walk_trajectory
from warpsense_tpu.ops.preprocess import preprocess as jax_preprocess
from warpsense_tpu_torch.ops.preprocess import preprocess


def _scan(seed):
    world = BoxWorld.default()
    gt = walk_trajectory(seed + 1, step_m=0.3)[-1]
    scan = render_scan(world, gt, channels=16, columns=128, noise_std=0.01,
                       rng=np.random.default_rng(seed))
    flat = scan.reshape(-1, 3).astype(np.float32)
    flat[::97] = np.nan                                  # non-finite rows
    flat[5:40] = [0.1, 0.2, 0.05]                        # near-origin quirk
    valid = np.any(flat != 0.0, axis=1)
    valid[3::11] = False
    return flat, valid


def _pose(seed):
    rng = np.random.default_rng(100 + seed)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(rodrigues(jnp.asarray(
        rng.normal(0, 0.3, 3), jnp.float32)))
    pose[:3, 3] = rng.uniform(-5000, 5000, 3)
    return pose


@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preprocess_bit_exact(snap, seed):
    flat, valid = _scan(seed)
    pose = _pose(seed)
    for res, capacity in ((128, 4096), (64, 700)):
        jp, jm = jax_preprocess(jnp.asarray(flat), jnp.asarray(valid),
                                jnp.asarray(pose), resolution=res,
                                capacity=capacity, snap=snap)
        tp, tm = preprocess(torch.as_tensor(flat), torch.as_tensor(valid),
                            torch.as_tensor(pose), resolution=res,
                            capacity=capacity, snap=snap)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        n = int(tm.sum())
        assert 0 < n <= capacity
        if capacity == 4096:
            assert n < capacity                         # tail is masked
