"""Port vs JAX: geometry, ring indexing, local/global map shells, imports.

Integer results are bit-exact (int32 wraparound included); the float
geometry (Rodrigues, xi_to_transform, mat_to_quat) agrees within 1e-6 — the
two frameworks evaluate sin/cos/sqrt and the 3x3 products with their own
libraries and summation order."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.core import geometry as jg
from warpsense_tpu.map import local_map as jlm
from warpsense_tpu.map.global_map import GlobalMap as JGlobalMap
from warpsense_tpu_torch.core import geometry as tg
from warpsense_tpu_torch.map import local_map as tlm
from warpsense_tpu_torch.map.global_map import GlobalMap as TGlobalMap

ROOT = Path(__file__).resolve().parent.parent


def _rot(rng):
    a = rng.normal(size=3)
    a = a / np.linalg.norm(a) * rng.uniform(0, np.pi)
    return np.asarray(jg.rodrigues(jnp.asarray(a, jnp.float32)))


def test_import_leaves_jax_out():
    """The port never imports jax, directly or through warpsense_tpu."""
    mods = ["warpsense_tpu_torch", "warpsense_tpu_torch.pipeline.warpsense",
            "warpsense_tpu_torch.kernels.fusion",
            "warpsense_tpu_torch.kernels.fields",
            "warpsense_tpu_torch.kernels.registration",
            "warpsense_tpu_torch.interop",
            "warpsense_tpu_torch.io.synthetic",
            "warpsense_tpu_torch.native",
            "warpsense_tpu_torch.utils.native_queue",
            "warpsense_tpu_torch.utils.device_query",
            "warpsense_tpu_torch.parallel.sharded",
            "warpsense_tpu_torch.parallel.distributed",
            "warpsense_tpu_torch.pipeline.warpsense_sharded",
            "warpsense_tpu_torch.pipeline.featsense",
            "warpsense_tpu_torch.eval.merge_maps",
            "warpsense_tpu_torch.eval.slam_eval",
            "warpsense_tpu_torch.eval.feature_compare",
            "warpsense_tpu_torch.eval.pcd2tsdf",
            "warpsense_tpu_torch.eval.pcd_registration",
            "warpsense_tpu_torch.obs.live",
            "warpsense_tpu_torch.frontends.featsense.floam_original",
            "warpsense_tpu_torch.frontends.featsense.features_reference"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'warpsense_tpu.')) or "
              "m == 'warpsense_tpu')\n"
              "assert not bad, bad\n"
              "import torch\n"
              "assert not torch.backends.cuda.matmul.allow_tf32\n"
              "assert not torch.backends.cudnn.allow_tf32\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_to_int_mat_bit_exact(seed):
    rng = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _rot(rng)
    pose[:3, 3] = rng.uniform(-3e4, 3e4, 3)
    want = np.asarray(jg.to_int_mat(jnp.asarray(pose)))
    got = tg.to_int_mat(torch.as_tensor(pose)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale_mm", [2e4, 6e4, 2e6])
def test_transform_point_fixed_bit_exact(scale_mm):
    """Includes sums past 2^31 (points beyond ~65 m, translations of km):
    both wrap in int32 identically."""
    rng = np.random.default_rng(int(scale_mm))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _rot(rng)
    pose[:3, 3] = rng.uniform(-scale_mm, scale_mm, 3)
    pts = rng.uniform(-scale_mm, scale_mm, (4096, 3)).astype(np.int32)
    pts[:4] = [[2 ** 31 - 1, -2 ** 31, 0], [-2 ** 31, -2 ** 31, -2 ** 31],
               [65535, -65536, 32767], [0, 0, 0]]
    im = np.asarray(jg.to_int_mat(jnp.asarray(pose)))
    want = np.asarray(jg.transform_point_fixed(jnp.asarray(pts),
                                               jnp.asarray(im)))
    got = tg.transform_point_fixed(torch.as_tensor(pts),
                                   torch.as_tensor(im)).numpy()
    np.testing.assert_array_equal(got, want)


def test_div_trunc_bit_exact_with_int_min():
    a = np.array([7, -7, 0, 1, -1, 2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1,
                  123456789, -987654321], np.int32)
    for b in (2, 3, -3, 32768, -1):
        want = np.asarray(jg.div_trunc(jnp.asarray(a), b))
        got = tg.div_trunc(torch.as_tensor(a), b).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rodrigues_and_xi_to_transform_close(seed):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.2, 3),
                         rng.normal(0, 50, 3)]).astype(np.float32)
    if seed == 3:
        xi[:3] = 0.0                                   # theta -> 0 branch
    center = rng.integers(-20000, 20000, 3).astype(np.int32)
    want_r = np.asarray(jg.rodrigues(jnp.asarray(xi[:3])))
    got_r = tg.rodrigues(torch.as_tensor(xi[:3])).numpy()
    np.testing.assert_allclose(got_r, want_r, atol=1e-6)
    want = np.asarray(jg.xi_to_transform(jnp.asarray(xi),
                                         jnp.asarray(center)))
    got = tg.xi_to_transform(torch.as_tensor(xi),
                             torch.as_tensor(center)).numpy()
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], atol=1e-6)
    # translation in mm: 1e-6 relative to the +-20 m rotation center
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], rtol=1e-6,
                               atol=2e4 * 1e-6)


@pytest.mark.parametrize("seed", range(5))
def test_mat_to_quat_close(seed):
    rng = np.random.default_rng(seed)
    R = _rot(rng) if seed else np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    want = np.asarray(jg.mat_to_quat(jnp.asarray(R, jnp.float32)))
    got = tg.mat_to_quat(torch.as_tensor(R, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("size", [(7, 9, 5), (8, 6, 4)])
def test_ring_indexing_bit_exact(size):
    rng = np.random.default_rng(sum(size))
    pts = rng.integers(-40, 40, (500, 3)).astype(np.int32)
    pos = np.array([3, -5, 2], np.int32)
    off = np.array([1, 4, 3], np.int32)
    np.testing.assert_array_equal(
        tlm.ring_coords(torch.as_tensor(pts), torch.as_tensor(pos),
                        torch.as_tensor(off), size).numpy(),
        np.asarray(jlm.ring_coords(jnp.asarray(pts), jnp.asarray(pos),
                                   jnp.asarray(off), size)))
    np.testing.assert_array_equal(
        tlm.ring_index(torch.as_tensor(pts), torch.as_tensor(pos),
                       torch.as_tensor(off), size).numpy(),
        np.asarray(jlm.ring_index(jnp.asarray(pts), jnp.asarray(pos),
                                  jnp.asarray(off), size)))
    for buf in (-4, 0, 1, 2):
        np.testing.assert_array_equal(
            tlm.in_bounds(torch.as_tensor(pts), torch.as_tensor(pos), size,
                          buf).numpy(),
            np.asarray(jlm.in_bounds(jnp.asarray(pts), jnp.asarray(pos),
                                     jnp.asarray(size), buf)))


@pytest.mark.parametrize("force_odd", [True, False])
def test_create_state_matches(force_odd):
    j = jlm.create_state((6, 5, 4), 600, 0, force_odd=force_odd)
    t = tlm.create_state((6, 5, 4), 600, 0, force_odd=force_odd)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert b.numpy().dtype == np.asarray(a).dtype


def _random_window(rng, size):
    v = rng.integers(-600, 601, size).astype(np.int16)
    w = rng.integers(0, 64, size).astype(np.int16)
    return v, w


def test_device_backed_shift_matches_jax_host_shift(tmp_path):
    """The port's in-place device-backed shift (attach/_dev_gather/
    _dev_scatter) leaves the same window and global map as the JAX
    package's host shift, across a beyond-window hop."""
    size = (9, 7, 5)
    rng = np.random.default_rng(5)
    v, w = _random_window(rng, size)
    jm = jlm.LocalMap(size, JGlobalMap(tmp_path / "j.h5", 600))
    tm = tlm.LocalMap(size, TGlobalMap(tmp_path / "t.h5", 600))
    jm.state.value[...] = v
    jm.state.weight[...] = w
    state = tlm.create_state(size, 600)
    state.value.copy_(torch.as_tensor(v))
    state.weight.copy_(torch.as_tensor(w))
    for target in ([2, -1, 1], [13, 3, -2], [0, 0, 0]):
        jm.shift(np.asarray(target))
        tm.attach_device(state)
        tm.shift(np.asarray(target))
        state = tm.detach_device()
        np.testing.assert_array_equal(state.pos.numpy(), jm.state.pos)
        np.testing.assert_array_equal(state.offset.numpy(), jm.state.offset)
        np.testing.assert_array_equal(state.value.numpy(), jm.state.value)
        np.testing.assert_array_equal(state.weight.numpy(), jm.state.weight)
    lo, hi = np.array([-20, -20, -20]), np.array([20, 20, 20])
    np.testing.assert_array_equal(tm.global_map.read_area(lo, hi),
                                  jm.global_map.read_area(lo, hi))


def test_memory_global_map_matches_hdf5(tmp_path):
    """The in-memory chunk store keeps GlobalMap's interface and content."""
    rng = np.random.default_rng(2)
    block = rng.integers(0, 2 ** 32, (70, 9, 66), dtype=np.uint64).astype(
        np.uint32)
    start = np.array([-40, 3, -64])
    maps = [TGlobalMap(tmp_path / "m.h5", 600), TGlobalMap(None, 600)]
    for m in maps:
        m.write_area(start, block)
        m.write_pose(np.array([1000.0, 2.0, -3.0]),
                     np.array([0, 0, 0, 1.0]), scale=1000.0)
    lo, hi = start - 5, start + np.array(block.shape) + 5
    np.testing.assert_array_equal(maps[0].read_area(lo, hi),
                                  maps[1].read_area(lo, hi))
    np.testing.assert_array_equal(maps[0].read_poses(), maps[1].read_poses())
    for m in maps:
        m.close()


def test_cuda_device_without_gpu_raises():
    from warpsense_tpu_torch.utils.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


def test_odom_estimation_runs_on_the_card_unless_asked_for_the_cpu():
    """``OdomEstimation`` defaults to the card, as the apps do: without a
    GPU the default raises; ``device="cpu"`` puts its maps on the CPU."""
    from warpsense_tpu_torch.frontends.featsense.odometry import \
        OdomEstimation
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        OdomEstimation()
    est = OdomEstimation(device="cpu", edge_map_capacity=16,
                         surf_map_capacity=16)
    assert est.device == torch.device("cpu")
    assert est.edge_map.points.device.type == "cpu"
