"""Port vs JAX: the featsense front end (geometry, features, odometry,
VGICP) on the CPU, with the same numpy inputs on both sides.

Tolerances, each with its cause:
* geometry, residuals, Jacobians, one GN step: float32 rounding of the
  same expressions, atol 1e-5 (measured <= 4e-6);
* curvature rtol 1e-5 (measured: bit-equal to op-by-op JAX) and the
  selected feature sets equal but for at most 2 points per set (measured:
  1 of 79 edge points in one of three scans, a curvature near-tie that the
  jitted JAX stage, which contracts the squares' sum into FMAs, breaks the
  other way);
* knn indices equal (the distance product is exact on integer inputs and
  selection is ordered by (distance, index) like ``jax.lax.top_k``);
* the odometry solve: 5 mm and 1e-3 in the quaternion (measured 2.5 mm and
  3.3e-4).  The plane fits' 3x3 normal equations are ill-conditioned for
  planes near the origin: float32 sums in another order (XLA contracts
  small dots as one FMA chain) flip the 0.2 m inlier gate of a few points,
  and the Huber IRLS follows.  Jitted and op-by-op JAX differ by 0.73 mm in
  the same solve;
* VGICP transform atol 1e-5 (measured 3.6e-7)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.core import geometry as jg
from warpsense_tpu.frontends.featsense import features as jfeat
from warpsense_tpu.frontends.featsense import features_reference as jref
from warpsense_tpu.frontends.featsense import odometry as jodo
from warpsense_tpu.frontends.featsense import vgicp as jvg
from warpsense_tpu.io.synthetic import BoxWorld, render_scan
from warpsense_tpu_torch.core import geometry as tg
from warpsense_tpu_torch.frontends.featsense import features as tfeat
from warpsense_tpu_torch.frontends.featsense import odometry as todo
from warpsense_tpu_torch.frontends.featsense import vgicp as tvg
from warpsense_tpu_torch.frontends.featsense.features_reference import (
    FeatureParams, block_bounds)
from warpsense_tpu_torch.interop import (feature_map_from_numpy,
                                         odom_estimation_from_numpy)

PARAMS = dict(min_distance=0.5, max_distance=40.0, edge_threshold=0.5,
              surf_threshold=0.05)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


# ------------------------------------------------------------------ geometry

def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        xi = rng.normal(0, 0.3, 6).astype(np.float32)
        jq, jt = jg.se3_exp(jnp.asarray(xi))
        tq, tt = tg.se3_exp(_t(xi))
        _close(tq, jq, 1e-6)
        _close(tt, jt, 1e-6)
        q2 = np.asarray(jg.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6),
                                               jnp.float32))[0])
        _close(tg.quat_mul(tq, _t(q2)), jg.quat_mul(jq, jnp.asarray(q2)),
               1e-6)
        v = rng.normal(0, 5, (7, 3)).astype(np.float32)
        _close(tg.quat_rotate(tq, _t(v)), jg.quat_rotate(jq, jnp.asarray(v)),
               4e-6)
        R = tg.quat_to_mat(tq)
        _close(R, jg.quat_to_mat(jq), 1e-6)
        _close(tg.pose_matrix(R, tt), jg.pose_matrix(jg.quat_to_mat(jq), jt),
               1e-6)
    # the Taylor branch below 1e-10
    small = np.array([1e-12, 0, 0, 0.1, 0.2, 0.3], np.float32)
    _close(tg.se3_exp(_t(small))[1], jg.se3_exp(jnp.asarray(small))[1], 1e-7)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [-65.0, 64.0, 1000.5]
    np.testing.assert_array_equal(
        tg.to_map(_t(pose), 64).numpy(),
        np.asarray(jg.to_map(jnp.asarray(pose), 64)))


# ------------------------------------------------------------------ features

def _scan(seed, H=16, W=256):
    rng = np.random.default_rng(seed)
    pose = np.eye(4)
    pose[:3, 3] = [0.5, -0.3, 0.2]
    return render_scan(BoxWorld.default(), pose, channels=H, columns=W,
                       noise_std=0.002, rng=rng)


def test_block_bounds_match_jax():
    for W in (64, 128, 256, 512, 1024, 2048):
        assert block_bounds(W) == jref.block_bounds(W)


def test_curvature_and_occlusion_match_jax():
    cloud = _scan(3)
    jc, jr = jfeat.curvature_and_ranges(jnp.asarray(cloud))
    tc, tr = tfeat.curvature_and_ranges(_t(cloud))
    band = np.isfinite(np.asarray(jc))
    np.testing.assert_array_equal(np.isfinite(tc.numpy()), band)
    np.testing.assert_allclose(tc.numpy()[band], np.asarray(jc)[band],
                               rtol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
    p = jref.FeatureParams(**PARAMS)
    np.testing.assert_array_equal(
        tfeat.mark_occluded(tr, FeatureParams(**PARAMS)).numpy(),
        np.asarray(jfeat.mark_occluded(jr, p)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feature_selection_matches_jax(seed):
    cloud = _scan(seed)
    want = jfeat.extract_features(jnp.asarray(cloud),
                                  params=jref.FeatureParams(**PARAMS),
                                  edge_capacity=1024, surf_capacity=2048)
    got = tfeat.extract_features(_t(cloud), params=FeatureParams(**PARAMS),
                                 edge_capacity=1024, surf_capacity=2048)
    flat = cloud.reshape(-1, 3)
    for (jp, jm, ji), (tp, tm, ti) in zip(want, got):
        jm, tm = np.asarray(jm), tm.numpy()
        assert int(jm.sum()) > 10
        assert tm.sum() == jm.sum()
        jset = set(np.asarray(ji)[jm].tolist())
        tset = set(ti.numpy()[tm].tolist())
        assert len(jset ^ tset) <= 2 * 2, sorted(jset ^ tset)
        # the returned points are the cloud entries at those indices
        np.testing.assert_array_equal(tp.numpy()[tm], flat[ti.numpy()[tm]])


def test_feature_capacity_truncation():
    (e_pts, e_mask, _), (s_pts, s_mask, _) = tfeat.extract_features(
        _t(_scan(1)), params=FeatureParams(**PARAMS), edge_capacity=4,
        surf_capacity=8)
    assert e_pts.shape == (4, 3) and s_pts.shape == (8, 3)
    assert int(e_mask.sum()) == 4 and int(s_mask.sum()) == 8


# ------------------------------------------------------------------ odometry

@pytest.mark.parametrize("integer", [False, True])
def test_knn_indices_match_jax(integer):
    """Random points, and integer points whose distances tie exactly: the
    port orders ties by index like ``jax.lax.top_k``."""
    rng = np.random.default_rng(int(integer))
    if integer:
        q = rng.integers(-3, 4, (200, 3)).astype(np.float32)
        m = rng.integers(-3, 4, (400, 3)).astype(np.float32)
    else:
        q = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
        m = rng.uniform(-5, 5, (700, 3)).astype(np.float32)
    mask = rng.random(len(m)) < 0.8
    ji, jd = jodo.knn(jnp.asarray(q), jnp.asarray(m), jnp.asarray(mask), 5,
                      exact=True)
    ti, td = todo.knn(_t(q), _t(m), _t(mask, torch.bool), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-5)


def test_fits_match_jax():
    rng = np.random.default_rng(1)
    nb = rng.normal(0, 1, (500, 5, 3)).astype(np.float32)
    lines = (rng.normal(0, 2, (200, 1, 3))
             + rng.uniform(-1, 1, (200, 5, 1)) * [0.6, 0.64, 0.48]
             + rng.normal(0, 0.01, (200, 5, 3))).astype(np.float32)
    ok = np.ones(len(nb), bool)
    for sets in (nb, lines):
        ok = np.ones(len(sets), bool)
        ja, jb, jv = jodo.fit_lines(jnp.asarray(sets), jnp.asarray(ok))
        ta, tb, tv = todo.fit_lines(_t(sets), _t(ok, torch.bool))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        _close(ta, ja, 1e-5)
        _close(tb, jb, 1e-5)
    assert np.asarray(jv).all()              # the line sets pass the gate
    planes = rng.uniform(-2, 2, (300, 5, 3)).astype(np.float32)
    planes[:, :, 2] = 3.0 + 0.01 * rng.normal(size=(300, 5))
    ok = np.ones(len(planes), bool)
    jn, jd, jv = jodo.fit_planes(jnp.asarray(planes), jnp.asarray(ok))
    tn, td, tv = todo.fit_planes(_t(planes), _t(ok, torch.bool))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(tn, jn, 1e-4)
    _close(td, jd, 1e-4)


def test_residuals_and_gn_step_match_jax():
    rng = np.random.default_rng(2)
    q = np.asarray(jg.se3_exp(jnp.asarray(rng.normal(0, 0.05, 6),
                                          jnp.float32))[0])
    t = rng.normal(0, 0.2, 3).astype(np.float32)
    pts = rng.normal(0, 3, (50, 3)).astype(np.float32)
    a = rng.normal(0, 3, (50, 3)).astype(np.float32)
    b = (a + rng.normal(0, 1, (50, 3))).astype(np.float32)
    n = rng.normal(0, 1, (50, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    d = rng.normal(0, 1, 50).astype(np.float32)
    valid = rng.random(50) < 0.9
    J = [jnp.asarray(x) for x in (q, t, pts)]
    T = [_t(x) for x in (q, t, pts)]
    jr, jJ = jodo.edge_residuals(*J, jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(valid))
    tr, tJ = todo.edge_residuals(*T, _t(a), _t(b), _t(valid, torch.bool))
    _close(tr, jr, 1e-5)
    _close(tJ, jJ, 1e-5)
    jr2, jJ2 = jodo.surf_residuals(*J, jnp.asarray(n), jnp.asarray(d),
                                   jnp.asarray(valid))
    tr2, tJ2 = todo.surf_residuals(*T, _t(n), _t(d), _t(valid, torch.bool))
    _close(tr2, jr2, 1e-5)
    _close(tJ2, jJ2, 1e-5)
    r = np.concatenate([np.asarray(jr), np.asarray(jr2)])
    Jm = np.concatenate([np.asarray(jJ), np.asarray(jJ2)])
    jq, jt = jodo.gn_step(J[0], J[1], jnp.asarray(r), jnp.asarray(Jm))
    tq, tt = todo.gn_step(T[0], T[1], _t(r), _t(Jm))
    _close(tq, jq, 1e-6)
    _close(tt, jt, 1e-6)
    w = np.array([0.05, -0.1, 0.3, -2.0, 0.0], np.float32)
    _close(todo._huber_weights(_t(w), 0.1),
           jodo._huber_weights(jnp.asarray(w), 0.1), 0)


def _sorted_rows(p):
    p = np.asarray(p)
    return p[np.lexsort(p.T[::-1])]


def test_voxel_downsample_and_merge_match_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-3, 3, (3000, 3)).astype(np.float32)
    mask = rng.random(3000) < 0.9
    jp, jm = jodo.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.4,
                                   2000)
    tp, tm = todo.voxel_downsample(_t(pts), _t(mask, torch.bool), 0.4, 2000)
    jm = np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(_sorted_rows(tp.numpy()[jm]),
                               _sorted_rows(np.asarray(jp)[jm]), atol=1e-6)
    jmap = jodo.FeatureMapState(jp, jnp.asarray(jm))
    tmap = feature_map_from_numpy(np.asarray(jp), jm, device="cpu")
    new = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
    center = np.array([1.0, -0.5, 0.0], np.float32)
    jout = jodo.merge_map(jmap, jnp.asarray(new), jnp.ones(500, bool),
                          jnp.asarray(center), crop=4.0, leaf=0.4)
    tout = todo.merge_map(tmap, _t(new), torch.ones(500, dtype=torch.bool),
                          _t(center), crop=4.0, leaf=0.4)
    km = np.asarray(jout.mask)
    np.testing.assert_array_equal(tout.mask.numpy(), km)
    np.testing.assert_allclose(_sorted_rows(tout.points.numpy()[km]),
                               _sorted_rows(np.asarray(jout.points)[km]),
                               atol=1e-6)


def _synthetic_maps(rng, n_edge=64, n_surf=512):
    """Edge points on 4 vertical lines, surf points on 3 walls (meters)."""
    lines = np.array([[2.0, 1.0], [-3.0, -2.0], [4.0, -3.0], [-5.0, 2.5]])
    edge = np.concatenate([
        np.stack([np.full(n_edge // 4, lx), np.full(n_edge // 4, ly),
                  rng.uniform(-1.5, 2.5, n_edge // 4)], 1)
        for lx, ly in lines])
    m = n_surf // 3
    surf = np.concatenate([
        np.stack([np.full(m, 8.0), rng.uniform(-6, 6, m),
                  rng.uniform(-2, 3, m)], 1),
        np.stack([rng.uniform(-8, 8, m), np.full(m, 6.0),
                  rng.uniform(-2, 3, m)], 1),
        np.stack([rng.uniform(-8, 8, m), rng.uniform(-6, 6, m),
                  np.full(m, -2.0)], 1)])
    return edge, surf


@pytest.mark.parametrize("count", [1, 5])
def test_odom_update_matches_jax(count):
    rng = np.random.default_rng(7)
    edge_w, surf_w = _synthetic_maps(rng)
    xi = np.array([0.0, 0.0, 0.08, 0.3, -0.2, 0.1], np.float32)
    q_true, t_true = jg.se3_exp(jnp.asarray(xi))
    R = np.asarray(jg.quat_to_mat(q_true), np.float64)
    t = np.asarray(t_true, np.float64)
    e_s = ((edge_w - t) @ R + rng.normal(0, 0.005, edge_w.shape)).astype(
        np.float32)
    s_s = ((surf_w - t) @ R + rng.normal(0, 0.005, surf_w.shape)).astype(
        np.float32)
    one = [np.ones(len(x), bool) for x in (edge_w, surf_w, e_s, s_s)]
    q0, t0 = np.array([0, 0, 0, 1.0], np.float32), np.zeros(3, np.float32)
    jq, jt = jodo.odom_update(
        jodo.FeatureMapState(jnp.asarray(edge_w, jnp.float32),
                             jnp.asarray(one[0])),
        jodo.FeatureMapState(jnp.asarray(surf_w, jnp.float32),
                             jnp.asarray(one[1])),
        jnp.asarray(e_s), jnp.asarray(one[2]), jnp.asarray(s_s),
        jnp.asarray(one[3]), jnp.asarray(q0), jnp.asarray(t0),
        jnp.int32(count))
    tq, tt = todo.odom_update(
        feature_map_from_numpy(edge_w, one[0], device="cpu"),
        feature_map_from_numpy(surf_w, one[1], device="cpu"), _t(e_s),
        _t(one[2], torch.bool), _t(s_s), _t(one[3], torch.bool), _t(q0),
        _t(t0), count)
    assert np.max(np.abs(tt.numpy() - np.asarray(jt))) < 5e-3
    assert np.max(np.abs(tq.numpy() - np.asarray(jq))) < 1e-3
    if count == 5:        # converged: both recover the pose
        assert np.linalg.norm(tt.numpy() - t) < 0.03


def test_odom_estimation_steps_match_jax_from_the_same_state():
    """Each scan starts the port from the JAX estimator's state (maps,
    poses, bootstrap count) through ``interop`` and compares one update:
    15 mm and 5e-3 per rotation entry (measured 6.9 mm and 1.5e-3; the
    solve's sensitivity is the one described in the module docstring)."""
    rng = np.random.default_rng(11)
    edge_w, surf_w = _synthetic_maps(rng, n_edge=64, n_surf=384)
    kw = dict(edge_map_capacity=1024, surf_map_capacity=2048,
              edge_leaf=0.1, optimization_steps=3)
    jest = jodo.OdomEstimation(**kw)
    for i in range(4):
        yaw = 0.03 * i
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        t = np.array([0.12 * i, -0.06 * i, 0.0])
        e_s, s_s = (edge_w - t) @ R, (surf_w - t) @ R
        test = odom_estimation_from_numpy(
            (np.asarray(jest.edge_map.points), np.asarray(jest.edge_map.mask)),
            (np.asarray(jest.surf_map.points), np.asarray(jest.surf_map.mask)),
            jest.odom, jest.last_odom, jest.optimization_count,
            jest.initialized, **kw, device="cpu")
        args = (e_s, np.ones(len(e_s), bool), s_s, np.ones(len(s_s), bool))
        want, got = jest.update(*args), test.update(*args)
        assert np.max(np.abs(got[:3, 3] - want[:3, 3])) < 15e-3, i
        assert np.max(np.abs(got[:3, :3] - want[:3, :3])) < 5e-3, i
        assert test.optimization_count == jest.optimization_count
        assert int(test.edge_map.mask.sum()) > 10
    assert np.linalg.norm(got[:3, 3] - t) < 0.05


# --------------------------------------------------------------------- VGICP

def _room_cloud(n, rng, half=6.0, zhalf=2.0):
    pts = []
    per = n // 6
    for ax in range(3):
        for s in (-1, 1):
            p = np.stack([rng.uniform(-half, half, per),
                          rng.uniform(-half, half, per),
                          rng.uniform(-zhalf, zhalf, per)], axis=1)
            p[:, ax] = s * (zhalf if ax == 2 else half)
            pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def test_voxel_table_matches_jax():
    rng = np.random.default_rng(0)
    pts = _room_cloud(3000, rng)
    mask = rng.random(len(pts)) < 0.95
    origin = np.array([0.3, -0.2, 0.1], np.float32)
    jt = jvg.build_voxel_table(jnp.asarray(pts), jnp.asarray(mask),
                               jnp.asarray(origin), 1.0)
    tt = tvg.build_voxel_table(_t(pts), _t(mask, torch.bool), _t(origin), 1.0)
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
    _close(tt.mean, jt.mean, 1e-6)
    q = (pts[:200] + 0.01).astype(np.float32)
    ji, jf = jvg.lookup(jt, jnp.asarray(q), jnp.ones(200, bool),
                        jnp.asarray(origin), 1.0)
    ti, tf = tvg.lookup(tt, _t(q), torch.ones(200, dtype=torch.bool),
                        _t(origin), 1.0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("iters", [5, 30])
def test_vgicp_matches_jax(iters):
    rng = np.random.default_rng(1)
    target = _room_cloud(3000, rng)
    source_w = _room_cloud(3000, np.random.default_rng(2))
    xi = np.array([0.0, 0.0, 0.05, 0.2, -0.15, 0.08], np.float32)
    q, t = jg.se3_exp(jnp.asarray(xi))
    R = np.asarray(jg.quat_to_mat(q), np.float64)
    tt_ = np.asarray(t, np.float64)
    source = ((source_w - tt_) @ R).astype(np.float32)
    ones = np.ones(len(source), bool)
    JT, jfit = jvg.vgicp_align(jnp.asarray(source), jnp.asarray(ones),
                               jnp.asarray(target), jnp.asarray(ones),
                               resolution=1.0, max_iterations=iters)
    TT, tfit = tvg.vgicp_align(_t(source), _t(ones, torch.bool), _t(target),
                               _t(ones, torch.bool), resolution=1.0,
                               max_iterations=iters)
    _close(TT, JT, 1e-5)
    assert abs(float(tfit) - float(jfit)) < 1e-5
    if iters == 30:
        np.testing.assert_allclose(TT.numpy()[:3, 3], tt_, atol=0.05)


def test_vgicp_fitness_gate_returns_identity():
    rng = np.random.default_rng(3)
    a = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    b = (rng.uniform(-5, 5, (500, 3)) + 300.0).astype(np.float32)
    ones = torch.ones(500, dtype=torch.bool)
    T, fitness = tvg.vgicp_align(_t(a), ones, _t(b), ones, resolution=1.0,
                                 max_iterations=5)
    assert not np.isfinite(float(fitness)) or float(fitness) > 6.0
    np.testing.assert_array_equal(T.numpy(), np.eye(4, dtype=np.float32))
