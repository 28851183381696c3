"""Port vs JAX: ray-march TSDF fusion (ops/tsdf.py) on the CPU.

Integer parts (order keys, plan, floor sqrt) are bit-exact.  The fusion is
bit-exact against op-by-op JAX: ``jax.disable_jit()`` with the ``fori_loop``
run as a Python loop over int32 steps (a disabled-jit ``fori_loop`` hands
the body Python ints, which the JAX body cannot take).  Jitted JAX on the
CPU may contract multiply-adds into FMAs (ROADMAP C11); its difference to
the port is bounded at 1e-4 of the touched voxels (measured: 0 at these
scenes)."""
import dataclasses
import math
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.core.config import Params as JParams
from warpsense_tpu.core.consts import MATRIX_RESOLUTION as MR
from warpsense_tpu.map.local_map import LocalMapState as JState
from warpsense_tpu.ops import tsdf as jt
from warpsense_tpu.pipeline.fusion_backend import fuse_cloud as jfuse
from warpsense_tpu_torch.interop import params_from_dict, state_from_numpy
from warpsense_tpu_torch.map.local_map import create_state
from warpsense_tpu_torch.ops import tsdf as tt
from warpsense_tpu_torch.pipeline.fusion_backend import fuse_cloud

TAU, RES = 600, 64
SIZE = (41, 37, 21)
POS, OFFSET = (0, 1, 0), (3, 5, 7)


def _room(n, seed, half=1100, zhalf=500):
    """Points on the walls of a box room (mm, int32)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.1, 1.1, (n, 3)) * [half, half, zhalf]
    face = rng.integers(0, 3, n)
    lim = np.array([half, half, zhalf])
    rows = np.arange(n)
    pts[rows, face] = np.where(pts[rows, face] < 0, -1, 1) * lim[face]
    return np.round(pts).astype(np.int32)


def _up(tilt_deg):
    a = math.radians(tilt_deg)
    return np.array([int(MR * math.sin(a)), 0, int(MR * math.cos(a))],
                    np.int32)


def _jstate():
    return JState(value=jnp.full(SIZE, TAU, jnp.int16),
                  weight=jnp.zeros(SIZE, jnp.int16),
                  pos=jnp.asarray(POS, jnp.int32),
                  offset=jnp.asarray(OFFSET, jnp.int32))


def _fori_op_by_op(lo, hi, body, init):
    for k in range(lo, hi):
        init = body(jnp.int32(k), init)
    return init


def test_key_codec_matches_jax():
    v = np.array([0, 5, -5, 3000, -3000, 1, -1, 32767], np.int32)
    w = np.array([64, -64, 1, -1, 23, 64, 0, -7], np.int32)
    key = tt.encode_key(torch.as_tensor(v), torch.as_tensor(w))
    np.testing.assert_array_equal(
        key.numpy(), np.asarray(jt.encode_key(jnp.asarray(v), jnp.asarray(w))))
    keys = np.concatenate([key.numpy(), [2 ** 30, 2 ** 30 + 5]]).astype(
        np.int32)
    for a, b in zip(tt.decode_key(torch.as_tensor(keys)),
                    jt.decode_key(jnp.asarray(keys))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # round trip where the weight's sign survives (w = 0 encodes as -0)
    dv, dw = tt.decode_key(key)
    np.testing.assert_array_equal(dv.numpy(), v)
    np.testing.assert_array_equal(dw.numpy()[w != 0], w[w != 0])


@pytest.mark.parametrize("args", [
    (600, 64, 50000, 128, 45.0), (1000, 64, 50000, 128, 45.0),
    (600, 64, 2500, 16, 45.0), (3000, 1000, 20000, 128, 45.0),
    (600, 128, 12000, 32, 30.0)])
def test_plan_raymarch_matches_jax(args):
    assert tt.plan_raymarch(*args) == jt.plan_raymarch(*args)


def test_floor_sqrt_matches_jax_and_isqrt():
    rng = np.random.default_rng(0)
    exact = np.arange(0, 1 << 18, dtype=np.int64)
    squares = np.arange(1, 4096, dtype=np.int64) ** 2
    ints = np.concatenate([exact, squares, squares - 1, squares + 1])
    got = tt._floor_sqrt(torch.as_tensor(ints.astype(np.float32))).numpy()
    # below 2^24 the float32 input is the integer itself
    np.testing.assert_array_equal(got, [math.isqrt(int(i)) for i in ints])
    wide = np.concatenate([ints.astype(np.float32),
                           rng.uniform(0, 1e10, 100_000).astype(np.float32)])
    with jax.disable_jit():
        want = np.asarray(jt._floor_sqrt(jnp.asarray(wide)))
    np.testing.assert_array_equal(
        tt._floor_sqrt(torch.as_tensor(wide)).numpy(), want)
    v = rng.integers(-60000, 60000, (50_000, 3)).astype(np.int32)
    with jax.disable_jit():
        want = np.asarray(jt._floor_norm(jnp.asarray(v)))
    np.testing.assert_array_equal(tt._floor_norm(torch.as_tensor(v)).numpy(),
                                  want)


@pytest.fixture(scope="module")
def fused():
    """One fusion of a room scan by the port and by JAX, op by op and
    jitted: 16 channels, so rays carry interpolation copies, and a 5 degree
    tilted up vector."""
    pts = _room(3000, 1)
    mask = np.ones(len(pts), bool)
    mask[::7] = False
    spos = np.array([1, 0, 0], np.int32)
    up = _up(5.0)
    max_steps, max_isteps = jt.plan_raymarch(TAU, RES, 2500, 16)
    assert max_isteps == 3
    kw = dict(size=SIZE, tau=TAU, max_weight=640, resolution=RES,
              max_steps=max_steps, max_isteps=max_isteps, channels=16)
    jargs = (jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(spos),
             jnp.asarray(up))
    with jax.disable_jit(), unittest.mock.patch.object(
            jax.lax, "fori_loop", _fori_op_by_op):
        eager = jt.tsdf_update(_jstate(), *jargs, **kw)
    jitted = jt.tsdf_update(_jstate(), *jargs, **kw)
    st = state_from_numpy(np.full(SIZE, TAU), np.zeros(SIZE), POS, OFFSET,
                          device="cpu")
    out = tt.tsdf_update(st, torch.as_tensor(pts), torch.as_tensor(mask),
                         torch.as_tensor(spos), torch.as_tensor(up), **kw)
    assert out is st                     # in place
    return st, eager, jitted


def test_tsdf_update_bit_exact_against_op_by_op_jax(fused):
    st, eager, _ = fused
    np.testing.assert_array_equal(st.value.numpy(), np.asarray(eager.value))
    np.testing.assert_array_equal(st.weight.numpy(), np.asarray(eager.weight))
    touched = np.asarray(eager.weight) != 0
    assert touched.sum() > 10_000
    assert (np.asarray(eager.weight) < 0).any()     # interpolation copies


def test_tsdf_update_close_to_jitted_jax(fused):
    st, _, jitted = fused
    diff = ((st.value.numpy() != np.asarray(jitted.value))
            | (st.weight.numpy() != np.asarray(jitted.weight)))
    touched = (np.asarray(jitted.weight) != 0).sum()
    assert diff.sum() <= 1e-4 * touched, (diff.sum(), touched)


def test_tsdf_update_accumulates_like_jax():
    """A second fusion merges into the first (weighted average) exactly as
    the jitted JAX function does on this near-origin scene."""
    pts = _room(1500, 2, half=900, zhalf=400)
    mask = np.ones(len(pts), bool)
    max_steps, max_isteps = jt.plan_raymarch(TAU, RES, 1800)
    kw = dict(size=SIZE, tau=TAU, max_weight=640, resolution=RES,
              max_steps=max_steps, max_isteps=max_isteps)
    js = _jstate()
    st = state_from_numpy(np.full(SIZE, TAU), np.zeros(SIZE), POS, OFFSET,
                          device="cpu")
    for spos in ((0, 0, 0), (1, 2, 0)):
        a = (jnp.asarray(pts), jnp.asarray(mask),
             jnp.asarray(spos, jnp.int32), jnp.asarray(_up(0.0)))
        js = jt.tsdf_update(js, *a, **kw)
        tt.tsdf_update(st, torch.as_tensor(pts), torch.as_tensor(mask),
                       torch.tensor(spos, dtype=torch.int32),
                       torch.as_tensor(_up(0.0)), **kw)
    np.testing.assert_array_equal(st.value.numpy(), np.asarray(js.value))
    np.testing.assert_array_equal(st.weight.numpy(), np.asarray(js.weight))
    assert (np.asarray(js.weight) > 64).any()        # averaged voxels


def test_fuse_cloud_raymarch_matches_jax():
    """The backend's "raymarch" branch: the MR-scaled up vector from a
    tilted, translated pose, then the march; against jitted JAX."""
    cfg = {"map": {"max_distance": 0.6, "resolution": RES, "max_weight": 10,
                   "size": {"x": 3, "y": 3, "z": 2}},
           "lidar": {"channels": 32, "hresolution": 256}}
    jparams = JParams.from_dict(cfg)
    tparams = params_from_dict(dataclasses.asdict(jparams))
    size = (47, 47, 31)
    pose = np.eye(4, dtype=np.float32)
    a = math.radians(7.0)
    pose[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                    [-math.sin(a), 0, math.cos(a)]]
    pose[:3, 3] = [130.0, -70.0, 20.0]
    pts = _room(2500, 3, half=1300, zhalf=550)
    mask = np.ones(len(pts), bool)
    steps = jt.plan_raymarch(jparams.map.tau, RES, 2500, 32)
    js = JState(value=jnp.full(size, jparams.map.tau, jnp.int16),
                weight=jnp.zeros(size, jnp.int16),
                pos=jnp.zeros(3, jnp.int32),
                offset=jnp.asarray([s // 2 for s in size], jnp.int32))
    js = jfuse(js, jnp.asarray(pts), jnp.asarray(mask), pose,
               params=jparams, size=size, fusion="raymarch",
               max_steps=steps[0], max_isteps=steps[1])
    st = create_state(size, jparams.map.tau, 0)
    fuse_cloud(st, torch.as_tensor(pts), torch.as_tensor(mask), pose,
               params=tparams, size=size, fusion="raymarch",
               max_steps=steps[0], max_isteps=steps[1])
    diff = ((st.value.numpy() != np.asarray(js.value))
            | (st.weight.numpy() != np.asarray(js.weight)))
    touched = (np.asarray(js.weight) != 0).sum()
    assert touched > 5_000
    assert diff.sum() <= 1e-4 * touched, (diff.sum(), touched)
    with pytest.raises(ValueError, match="max_steps"):
        fuse_cloud(st, torch.as_tensor(pts), torch.as_tensor(mask), pose,
                   params=tparams, size=size, fusion="raymarch")


def test_tsdf_update_without_emitting_rays_is_a_no_op():
    st = create_state(SIZE, TAU, 0)
    pts = torch.as_tensor(_room(100, 4))
    tt.tsdf_update(st, pts, torch.zeros(100, dtype=torch.bool),
                   torch.zeros(3, dtype=torch.int32),
                   torch.as_tensor(_up(0.0)), size=st.value.shape, tau=TAU,
                   max_weight=640, resolution=RES, max_steps=50,
                   max_isteps=1)
    assert int(st.weight.abs().sum()) == 0
