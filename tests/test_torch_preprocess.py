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


def test_preprocess_sends_cpu_clouds_to_the_plain_version(monkeypatch):
    """A CPU cloud takes ``preprocess_plain`` (the kernel's wrapper is
    never called), with the host pose as a numpy array or a CPU tensor,
    as the apps pass it on either route; the kernel's wrapper refuses a
    CPU cloud rather than fall back."""
    from warpsense_tpu_torch.kernels import preprocess as kpre
    from warpsense_tpu_torch.ops.preprocess import preprocess_plain

    def refuse(*a, **kw):
        raise AssertionError("a CPU cloud reached the kernel's wrapper")

    flat, valid = _scan(0)
    pose = _pose(0)
    cloud, ok = torch.as_tensor(flat), torch.as_tensor(valid)
    want = preprocess_plain(cloud, ok, torch.as_tensor(pose), resolution=64,
                            capacity=700, snap=False)
    with pytest.raises(ValueError, match="CUDA"):
        kpre.preprocess(cloud, ok, pose, resolution=64, capacity=700)
    monkeypatch.setattr(kpre, "preprocess", refuse)
    for host_pose in (pose, torch.as_tensor(pose)):
        got = preprocess(cloud, ok, host_pose, resolution=64, capacity=700,
                         snap=False)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_int_mat_is_to_int_mat_on_the_host(dtype):
    """The kernel's pose, ``kernels/preprocess.int_mat``: to_int_mat's top
    three rows wherever the int32 conversion is exact; beyond the int32
    range it saturates and NaN goes to 0, as CUDA's float-to-int
    conversion does; a card pose or another shape is refused."""
    from warpsense_tpu_torch.core.geometry import to_int_mat
    from warpsense_tpu_torch.kernels.preprocess import int_mat
    for seed in range(3):
        pose = _pose(seed).astype(dtype)
        want = to_int_mat(torch.as_tensor(pose))[:3].numpy()
        np.testing.assert_array_equal(int_mat(pose), want)
        np.testing.assert_array_equal(int_mat(torch.as_tensor(pose)), want)
    pose = np.eye(4, dtype=dtype)
    pose[:3, 3] = (7.0e4, -9.0e4, np.nan)
    m = int_mat(pose)
    assert m.dtype == np.int32 and m.shape == (3, 4)
    assert list(m[:, 3]) == [2 ** 31 - 1, -2 ** 31, 0]
    with pytest.raises(ValueError, match="4x4"):
        int_mat(np.eye(3))
    with pytest.raises(ValueError, match="host"):
        int_mat(torch.eye(4, device="meta"))
