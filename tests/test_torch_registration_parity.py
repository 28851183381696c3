"""Port vs JAX: parity-mode registration (three-plane fields + GN).

The map is fused by the JAX ray march and handed to the port through numpy.
``precompute_fields`` is integer arithmetic and bit-exact.  The statistics
are float32 sums in another order (PyTorch vs XLA reductions): rtol 1e-5
(measured ~2e-8).  The GN loop runs on the host with LAPACK's 6x6 solve
instead of XLA's: poses within 0.5 mm and 1e-4 rad (measured: under
0.001 mm and 2e-7 rad), in both modes of ``register_cloud_fields``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.core.consts import MATRIX_RESOLUTION as MR
from warpsense_tpu.core.consts import WEIGHT_RESOLUTION
from warpsense_tpu.core.geometry import rodrigues
from warpsense_tpu.map.local_map import LocalMapState as JState
from warpsense_tpu.ops import registration as jreg
from warpsense_tpu.ops import tsdf as jt
from warpsense_tpu_torch.interop import (registration_fields_from_numpy,
                                         state_from_numpy)
from warpsense_tpu_torch.ops import registration as treg

TAU, RES = 600, 64
SIZE = (81, 81, 65)
HALF, ZHALF = 2200.0, 1700.0


def _walls(n, rng):
    """Points on a box room's walls plus a pillar (rotation observability),
    int32 mm."""
    pts = []
    for ax in range(3):
        for s in (-1.0, 1.0):
            p = np.stack([rng.uniform(-HALF, HALF, n),
                          rng.uniform(-HALF, HALF, n),
                          rng.uniform(-ZHALF, ZHALF, n)], axis=1)
            p[:, ax] = s * (ZHALF if ax == 2 else HALF)
            pts.append(p)
    m = n // 2
    for x in (600.0, 1000.0):
        pts.append(np.stack([np.full(m, x), rng.uniform(700, 1100, m),
                             rng.uniform(-ZHALF, ZHALF, m)], axis=1))
    return np.round(np.concatenate(pts)).astype(np.int32)


@pytest.fixture(scope="module")
def scene():
    """(JAX state, port state, JAX fields, snapped registration cloud)."""
    rng = np.random.default_rng(3)
    st = JState(value=jnp.full(SIZE, TAU, jnp.int16),
                weight=jnp.zeros(SIZE, jnp.int16),
                pos=jnp.zeros(3, jnp.int32),
                offset=jnp.asarray([s // 2 for s in SIZE], jnp.int32))
    steps = jt.plan_raymarch(TAU, RES, 5000)
    for origin in ((0, 0, 0), (4, -3, 1)):
        mp = _walls(3000, rng)
        st = jt.tsdf_update(
            st, jnp.asarray(mp), jnp.ones(len(mp), bool),
            jnp.asarray(origin, jnp.int32), jnp.asarray([0, 0, MR], jnp.int32),
            size=SIZE, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
            resolution=RES, max_steps=steps[0], max_isteps=steps[1])
    tst = state_from_numpy(np.asarray(st.value), np.asarray(st.weight),
                           np.asarray(st.pos), np.asarray(st.offset),
                           device="cpu")
    # voxel-center snap + dedup, like the parity-mode preprocess
    cloud = np.unique(_walls(400, rng) // RES * RES + RES // 2,
                      axis=0).astype(np.int32)
    return st, tst, jreg.precompute_fields(st), cloud


def _perturbation(seed):
    rng = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)
    axis = rng.normal(size=3)
    axis *= np.radians(1.0) / np.linalg.norm(axis)
    pose[:3, :3] = np.asarray(rodrigues(jnp.asarray(axis, jnp.float32)))
    pose[:3, 3] = rng.uniform(-60, 60, 3)
    return pose


def _rot_err(a, b):
    m = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    v = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v) / 2.0)))


def _mask(n):
    mask = np.ones(n, bool)
    mask[::11] = False
    return mask


def test_precompute_fields_bit_exact(scene):
    st, tst, jf, _ = scene
    tf = treg.precompute_fields(tst)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the scene exercises both rejection rules and real gradients
    assert (np.asarray(jf.gxy) != 0).mean() > 0.01


def test_precompute_fields_random_ring_window():
    """Random values and sparse weights on a ring-offset window: every
    neighbour combination, the sign-change rule and the wrap."""
    rng = np.random.default_rng(5)
    size = (13, 11, 9)
    v = rng.integers(-TAU, TAU + 1, size).astype(np.int16)
    w = ((rng.random(size) < 0.6) * rng.integers(1, 64, size)).astype(
        np.int16)
    js = JState(value=jnp.asarray(v), weight=jnp.asarray(w),
                pos=jnp.asarray([3, -2, 1], jnp.int32),
                offset=jnp.asarray([4, 0, 8], jnp.int32))
    ts = state_from_numpy(v, w, [3, -2, 1], [4, 0, 8], device="cpu")
    for a, b in zip(jreg.precompute_fields(js), treg.precompute_fields(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_jacobian_stats_fields_matches_jax(scene, normalize, seed):
    st, tst, jf, cloud = scene
    tf = registration_fields_from_numpy(*(np.asarray(p) for p in jf),
                                        device="cpu")
    pose = _perturbation(seed)
    mask = _mask(len(cloud))
    kw = dict(size=SIZE, resolution=RES, normalize_gradient=normalize)
    want = jreg.jacobian_stats_fields(jf, st.pos, st.offset,
                                      jnp.asarray(cloud), jnp.asarray(mask),
                                      jnp.asarray(pose), **kw)
    got = treg.jacobian_stats_fields(tf, tst.pos, tst.offset,
                                     torch.as_tensor(cloud),
                                     torch.as_tensor(mask),
                                     torch.as_tensor(pose), **kw)
    H, g, e, c = (np.asarray(x, np.float64) for x in want)
    assert float(got[3]) == c and c > 1000
    np.testing.assert_allclose(got[0].numpy(), H, rtol=1e-5,
                               atol=1e-5 * np.abs(H).max())
    np.testing.assert_allclose(got[1].numpy(), g, rtol=1e-5,
                               atol=1e-5 * np.abs(g).max())
    np.testing.assert_allclose(float(got[2]), e, rtol=1e-5)


@pytest.mark.parametrize("mode,iters", [("parity", 200), ("fast", 30)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_register_cloud_fields_matches_jax(scene, mode, iters, seed):
    st, tst, jf, cloud = scene
    tf = treg.precompute_fields(tst)
    pose = _perturbation(seed)
    mask = _mask(len(cloud))
    kw = dict(size=SIZE, resolution=RES, max_iterations=iters,
              it_weight_gradient=0.1, epsilon=0.03, mode=mode)
    want = np.asarray(jreg.register_cloud_fields(
        jf, st.pos, st.offset, jnp.asarray(cloud), jnp.asarray(mask),
        jnp.asarray(pose), **kw))
    got = treg.register_cloud_fields(
        tf, tst.pos, tst.offset, torch.as_tensor(cloud),
        torch.as_tensor(mask), torch.as_tensor(pose), **kw).numpy()
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got[:3, 3] - want[:3, 3])) < 0.5
    assert _rot_err(got, want) < 1e-4
    # the loop moved the pose (it is not the pretransform)
    assert np.max(np.abs(got[:3, 3] - pose[:3, 3])) > 5.0


def test_register_cloud_from_state_and_empty_cloud(scene):
    """``register_cloud`` (fields computed inside) equals the cached-fields
    path; an all-masked cloud is an empty system: the loop stops at once
    and returns the pretransform, as in JAX."""
    st, tst, _, cloud = scene
    pose = _perturbation(4)
    kw = dict(size=SIZE, resolution=RES, max_iterations=200,
              it_weight_gradient=0.1, epsilon=0.03)
    a = treg.register_cloud(tst, torch.as_tensor(cloud),
                            torch.as_tensor(_mask(len(cloud))),
                            torch.as_tensor(pose), **kw)
    b = treg.register_cloud_fields(
        treg.precompute_fields(tst), tst.pos, tst.offset,
        torch.as_tensor(cloud), torch.as_tensor(_mask(len(cloud))),
        torch.as_tensor(pose), **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    none = np.zeros(len(cloud), bool)
    got = treg.register_cloud(tst, torch.as_tensor(cloud),
                              torch.as_tensor(none), torch.as_tensor(pose),
                              **kw)
    want = jreg.register_cloud(st, jnp.asarray(cloud), jnp.asarray(none),
                               jnp.asarray(pose), **kw)
    np.testing.assert_array_equal(got.numpy(), pose)
    np.testing.assert_array_equal(np.asarray(want), pose)


def test_register_cloud_fields_reports_its_iterations(scene, monkeypatch):
    """With ``return_iterations`` the GN loop also returns how many times it
    evaluated the statistics (FastsenseApp's ``gn_iterations``): the same
    pose, and the count of ``jacobian_stats_fields`` calls; an empty
    system stops after one."""
    _, tst, _, cloud = scene
    tf = treg.precompute_fields(tst)
    pose = torch.as_tensor(_perturbation(1))
    kw = dict(size=SIZE, resolution=RES, max_iterations=200,
              it_weight_gradient=0.1, epsilon=0.03)
    plain = treg.register_cloud_fields(
        tf, tst.pos, tst.offset, torch.as_tensor(cloud),
        torch.as_tensor(_mask(len(cloud))), pose, **kw)
    calls = []
    stats = treg.jacobian_stats_fields
    monkeypatch.setattr(treg, "jacobian_stats_fields",
                        lambda *a, **k: calls.append(1) or stats(*a, **k))
    for mask, moved in ((_mask(len(cloud)), True),
                        (np.zeros(len(cloud), bool), False)):
        calls.clear()
        got, n = treg.register_cloud_fields(
            tf, tst.pos, tst.offset, torch.as_tensor(cloud),
            torch.as_tensor(mask), pose, return_iterations=True, **kw)
        assert n == len(calls)
        if moved:
            np.testing.assert_array_equal(got.numpy(), plain.numpy())
            assert 1 < n < kw["max_iterations"]
        else:
            assert n == 1
