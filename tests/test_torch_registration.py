"""Port vs JAX: fast-mode packed registration (adaptive LM).

Same map, fields and cloud in both (handed over through numpy); the port
runs the LM loop on the host with the statistics from the device, the JAX
function inside ``lax.while_loop``.  Tolerances: poses within 0.5 mm and
1e-4 rad, iteration counts within 2.  Reason: the float32 sums of H, g, e
run in another order (PyTorch vs XLA reductions) and the 6x6 solve is
LAPACK's instead of XLA's LU, so each LM step differs in the last bits and
an accept/reject decision at the margin can shift by an iteration."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.core.consts import WEIGHT_RESOLUTION
from warpsense_tpu.core.geometry import rodrigues
from warpsense_tpu.map.local_map import LocalMapState as JState
from warpsense_tpu.ops import registration as jreg
from warpsense_tpu.ops.tsdf_projective import tsdf_update_projective
from warpsense_tpu_torch.interop import packed_fields_from_numpy
from warpsense_tpu_torch.ops import registration as treg

TAU, RES = 600, 64
SIZE = (81, 81, 65)
HALF, ZHALF = 2200.0, 1700.0


def _walls(n_per_face, rng):
    """Random points on a box room's walls plus a pillar (rotation
    observability)."""
    pts = []
    for ax in range(3):
        for s in (-1.0, 1.0):
            p = np.stack([rng.uniform(-HALF, HALF, n_per_face),
                          rng.uniform(-HALF, HALF, n_per_face),
                          rng.uniform(-ZHALF, ZHALF, n_per_face)], axis=1)
            p[:, ax] = s * (ZHALF if ax == 2 else HALF)
            pts.append(p)
    m = n_per_face // 2
    for x in (600.0, 1000.0):
        pts.append(np.stack([np.full(m, x), rng.uniform(700, 1100, m),
                             rng.uniform(-ZHALF, ZHALF, m)], axis=1))
    return np.round(np.concatenate(pts)).astype(np.int32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    st = JState(value=jnp.full(SIZE, TAU, jnp.int16),
                weight=jnp.zeros(SIZE, jnp.int16),
                pos=jnp.zeros(3, jnp.int32),
                offset=jnp.asarray([s // 2 for s in SIZE], jnp.int32))
    kw = dict(size=SIZE, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
              resolution=RES, channels=64, columns=512, vfov_deg=90.0)
    for origin in ((0, 0, 0), (4, -3, 1), (-5, 2, -1)):
        mp = _walls(4000, rng)
        st = tsdf_update_projective(
            st, jnp.asarray(mp), jnp.ones(len(mp), bool),
            jnp.asarray(origin, jnp.int32), jnp.eye(3, dtype=jnp.float32),
            **kw)
    cloud = _walls(500, rng)
    return st, cloud


def _perturbation(seed):
    rng = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)
    axis = rng.normal(size=3)
    axis *= np.radians(1.0) / np.linalg.norm(axis)
    pose[:3, :3] = np.asarray(rodrigues(jnp.asarray(axis, jnp.float32)))
    pose[:3, 3] = rng.uniform(-60, 60, 3)
    return pose


def _rot_err(a, b):
    """Angle (rad) of a^T b from its skew part, in float64 (arccos of the
    trace loses ~sqrt(eps) near the identity)."""
    m = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    v = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v) / 2.0)))


@pytest.mark.parametrize("gather_freeze,coarse,exact", [
    (False, 0, False), (True, 0, False), (True, 5, False), (False, 5, False),
    (True, 0, True)])
def test_register_cloud_packed_matches_jax(scene, gather_freeze, coarse,
                                           exact):
    st, cloud = scene
    pert = _perturbation(7 + coarse + int(gather_freeze))
    if exact:
        jf = jreg.precompute_fields_packed2(st)
        tf = packed_fields_from_numpy(np.asarray(jf.plane_a),
                                      np.asarray(jf.plane_b), device="cpu")
    else:
        jf = jreg.precompute_fields_packed(st, tau=TAU)
        tf = packed_fields_from_numpy(np.asarray(jf.plane), device="cpu")
    mask = np.ones(len(cloud), bool)
    mask[::13] = False
    kw = dict(size=SIZE, resolution=RES, tau=TAU, max_iterations=50,
              it_weight_gradient=0.1, epsilon=0.03,
              coarse_iterations=coarse, gather_freeze=gather_freeze)
    jpose, jit, jerr = jreg.register_cloud_packed(
        jf, st.pos, st.offset, jnp.asarray(cloud), jnp.asarray(mask),
        jnp.asarray(pert), **kw)
    tpose, tit, terr = treg.register_cloud_packed(
        tf, torch.as_tensor(np.asarray(st.pos)),
        torch.as_tensor(np.asarray(st.offset)), torch.as_tensor(cloud),
        torch.as_tensor(mask), torch.as_tensor(pert), **kw)
    jpose, tpose = np.asarray(jpose), tpose.numpy()
    assert np.all(np.isfinite(tpose))
    assert np.max(np.abs(tpose[:3, 3] - jpose[:3, 3])) < 0.5
    assert _rot_err(tpose, jpose) < 1e-4
    assert abs(int(jit) - tit) <= 2, (int(jit), tit)
    assert abs(float(jerr) - terr) < 0.05 * max(1.0, float(jerr))
    # the registration did real work: it undid most of the perturbation
    assert np.max(np.abs(tpose[:3, 3])) < 0.5 * np.max(np.abs(pert[:3, 3]))


def test_empty_cloud_returns_pretransform(scene):
    """No valid point: the error is infinite, no step is taken and the
    loop stops at once with the pretransform, like the JAX loop."""
    st, cloud = scene
    jf = jreg.precompute_fields_packed(st, tau=TAU)
    tf = packed_fields_from_numpy(np.asarray(jf.plane), device="cpu")
    pert = _perturbation(1)
    pose, iters, err = treg.register_cloud_packed(
        tf, torch.as_tensor(np.asarray(st.pos)),
        torch.as_tensor(np.asarray(st.offset)), torch.as_tensor(cloud),
        torch.zeros(len(cloud), dtype=torch.bool), torch.as_tensor(pert),
        size=SIZE, resolution=RES, tau=TAU, max_iterations=50,
        it_weight_gradient=0.1, epsilon=0.03)
    jpose, jit, _ = jreg.register_cloud_packed(
        jf, st.pos, st.offset, jnp.asarray(cloud),
        jnp.zeros(len(cloud), bool), jnp.asarray(pert), size=SIZE,
        resolution=RES, tau=TAU, max_iterations=50, it_weight_gradient=0.1,
        epsilon=0.03)
    np.testing.assert_array_equal(pose.numpy(), pert)
    np.testing.assert_array_equal(np.asarray(jpose), pert)
    assert iters == int(jit)
