"""Port vs JAX: the public names of the JAX package that the port took on
last, each held against the JAX package on the CPU.

* ``fusion="pallas"``: JAX's name of its TPU level kernel, whose bits are
  "projective-level"'s (tests/test_tsdf_pallas.py); in the port it is that
  path (K1's level sweep, its general sweep past the tilt envelope).
  ``fuse_cloud`` is held bit for bit against JAX's ``fuse_cloud(fusion=
  "pallas")`` (the Pallas kernels in interpret mode) at
  tests/test_torch_fusion.py's window, level and past the envelope; the
  apps with "pallas" repeat their "projective-level" runs bit for bit, and
  WarpsenseApp's poses are JAX's "projective-level" app's within
  tests/test_torch_app.py's 0.5 mm and 1e-4 rad.
* ``tsdf_update(pos_mode="corner")``: the ray march from the scanner
  voxel's corner, bit for bit against op-by-op JAX (``jax.disable_jit()``,
  ``fori_loop`` over int32 steps, as tests/test_torch_raymarch.py runs it)
  at tests/test_tsdf_device.py's 21^3 window of 1 m voxels; another value
  raises.
* ``jacobian_stats``: against JAX's within the statistics tests' rtol 1e-5
  (tests/test_torch_registration_parity.py), c exactly.
* ``knn(exact=)``: the port's selection is always exact, so both values
  give the same bits, and JAX's off a TPU.
* ``ScanQueue.backend``: a read-only "native" or "python", JAX's on the
  same build.
"""
import contextlib
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
from warpsense_tpu.core.consts import WEIGHT_RESOLUTION
from warpsense_tpu.frontends.featsense import odometry as jodo
from warpsense_tpu.io.synthetic import BoxWorld, render_scan, walk_trajectory
from warpsense_tpu.map.local_map import LocalMapState as JState
from warpsense_tpu.ops import registration as jreg
from warpsense_tpu.ops import tsdf as jt
from warpsense_tpu.pipeline import fusion_backend as jfb
from warpsense_tpu.pipeline.warpsense import WarpsenseApp as JApp
from warpsense_tpu.utils import native_queue as jnq
from warpsense_tpu_torch.frontends.featsense import odometry as todo
from warpsense_tpu_torch.interop import params_from_dict, state_from_numpy
from warpsense_tpu_torch.ops import registration as treg
from warpsense_tpu_torch.ops import tsdf as tt
from warpsense_tpu_torch.pipeline import fusion_backend as tfb
from warpsense_tpu_torch.pipeline.featsense import FeatsenseApp
from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp
from warpsense_tpu_torch.utils import native_queue as tnq

# ------------------------------------------------------- fusion="pallas"


@contextlib.contextmanager
def one_thread():
    """The app runs on one PyTorch thread: bits do not depend on it (each
    comparison is of two runs under the same setting), and beside the
    suite's other workers many threads each slow the small ops by far."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

SIZE = (48, 48, 32)
TAU, RES = 600, 64


def _room(n=1500, half=1200, zhalf=800, seed=0):
    rng = np.random.default_rng(seed)
    pts = []
    for ax in range(3):
        for s in (-1, 1):
            p = np.stack([rng.uniform(-half, half, n // 6),
                          rng.uniform(-half, half, n // 6),
                          rng.uniform(-zhalf, zhalf, n // 6)], axis=1)
            p[:, ax] = s * (zhalf if ax == 2 else half)
            pts.append(p)
    return np.round(np.concatenate(pts)).astype(np.int32)


def _pose(tilt_deg):
    a = math.radians(tilt_deg)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                    [-math.sin(a), 0, math.cos(a)]]
    pose[:3, 3] = [70.0, -40.0, 20.0]
    return pose


@pytest.mark.parametrize("tilt_deg", [0.0, 5.0])
def test_fuse_cloud_pallas_is_projective_level_and_jax_pallas(tilt_deg):
    """Level and past the 2 degree envelope: the port's "pallas" fusion is
    its "projective-level" fusion and JAX's "projective-level" fusion, bit
    for bit; on the level grid also JAX's "pallas" (its level kernel).
    Past the envelope JAX's "pallas" runs its general TPU kernel, which
    drops the W=0 beam window (warpsense_tpu/kernels/tsdf_pallas.py:110),
    a difference the port does not copy (K1 computes the XLA twin's
    sweep)."""
    jparams = JParams.from_dict({
        "map": {"max_distance": TAU / 1000.0, "resolution": RES,
                "max_weight": 32},
        "lidar": {"channels": 32, "hresolution": 256}})
    tparams = params_from_dict(dataclasses.asdict(jparams))
    pts = _room()
    mask = np.ones(len(pts), bool)
    mask[::9] = False
    pose = _pose(tilt_deg)
    offset = [s // 2 for s in SIZE]

    def jfuse(name):
        return jfb.fuse_cloud(
            JState(value=jnp.full(SIZE, TAU, jnp.int16),
                   weight=jnp.zeros(SIZE, jnp.int16),
                   pos=jnp.zeros(3, jnp.int32),
                   offset=jnp.asarray(offset, jnp.int32)),
            jnp.asarray(pts), jnp.asarray(mask), pose, params=jparams,
            size=SIZE, fusion=name)

    js = jfuse("projective-level")
    if tilt_deg == 0.0:
        jp = jfuse("pallas")
        np.testing.assert_array_equal(np.asarray(jp.value),
                                      np.asarray(js.value))
        np.testing.assert_array_equal(np.asarray(jp.weight),
                                      np.asarray(js.weight))
    got = {}
    for name in ("pallas", "projective-level"):
        st = state_from_numpy(np.full(SIZE, TAU), np.zeros(SIZE), [0, 0, 0],
                              offset, device="cpu")
        got[name] = tfb.fuse_cloud(st, torch.as_tensor(pts),
                                   torch.as_tensor(mask), pose,
                                   params=tparams, size=SIZE, fusion=name)
    for st in got.values():
        np.testing.assert_array_equal(st.value.numpy(), np.asarray(js.value))
        np.testing.assert_array_equal(st.weight.numpy(),
                                      np.asarray(js.weight))
    assert int((np.asarray(js.weight) != 0).sum()) > 2_000
    assert tfb.resolve_fusion("pallas", size=SIZE, channels=32) == "pallas"
    assert tfb.resolve_fusion("auto", size=SIZE,
                              channels=32) == "projective-level"


APP_CFG = {
    "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
            "size": {"x": 20, "y": 16, "z": 7}, "shift": 0.18,
            "update_distance": 0.05},
    "registration": {"max_iterations": 20, "epsilon": 0.03,
                     "it_weight_gradient": 0.1, "mode": "fast"},
    "lidar": {"channels": 16, "hresolution": 128},
}


def _rot_err(a, b):
    m = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    v = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v) / 2.0)))


def test_warpsense_app_pallas_is_projective_level(tmp_path):
    """WarpsenseApp(fusion="pallas") on tests/test_torch_app.py's walk (a
    map shift on the way): the port's "projective-level" run to the bit
    (poses and window), and JAX's "projective-level" app's poses within
    0.5 mm and 1e-4 rad."""
    jparams = JParams.from_dict(APP_CFG)
    tparams = params_from_dict(dataclasses.asdict(jparams))
    rng = np.random.default_rng(0)
    scans = [render_scan(BoxWorld.default(), p, channels=16, columns=128,
                         noise_std=0.002, rng=rng)
             for p in walk_trajectory(5, step_m=0.1)]
    kw = dict(capacity=2048, sync_shift=True)
    runs = {}
    for name in ("pallas", "projective-level"):
        app = WarpsenseApp(tparams, in_memory_map=True, device="cpu",
                           fusion=name, **kw)
        with one_thread():
            poses = np.stack([app.cloud_callback(s, 0.1 * i)
                              for i, s in enumerate(scans)])
        runs[name] = (poses, app.state.value.numpy().copy(),
                      app.state.weight.numpy().copy(),
                      app.state.pos.numpy().copy())
        app.terminate()
    for a, b in zip(runs["pallas"], runs["projective-level"]):
        np.testing.assert_array_equal(a, b)
    assert np.any(runs["pallas"][3] != 0)          # the window moved
    japp = JApp(jparams, map_path=tmp_path / "jax.h5",
                fusion="projective-level", **kw)
    jp = np.stack([japp.cloud_callback(s, 0.1 * i)
                   for i, s in enumerate(scans)])
    japp.terminate()
    for i, (a, b) in enumerate(zip(runs["pallas"][0], jp)):
        assert np.max(np.abs(a[:3, 3] - b[:3, 3])) < 0.5, (i, a, b)
        assert _rot_err(a, b) < 1e-4, i


def test_featsense_app_pallas_is_projective_level():
    """FeatsenseApp (and so FeatsenseMapping) takes fusion="pallas": three
    scans, the "projective-level" run's poses and map to the bit."""
    cfg = {
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 24, "y": 20, "z": 8}, "shift": 8.0,
                "update_distance": 0.08},
        "floam": {"min_distance": 0.5, "max_distance": 40.0,
                  "edge_threshold": 0.5, "surf_threshold": 0.05,
                  "edge_resolution": 0.15, "optimization_steps": 3,
                  "enrich": 4, "vgicp_fitness_score": 6.0},
        "lidar": {"channels": 32, "hresolution": 512},
    }
    params = params_from_dict(dataclasses.asdict(JParams.from_dict(cfg)))
    rng = np.random.default_rng(0)
    truth = walk_trajectory(3, step_m=0.12)
    scans = [render_scan(BoxWorld.default(), p, channels=32, columns=512,
                         noise_std=0.003, rng=rng) for p in truth]
    runs = {}
    for name in ("pallas", "projective-level"):
        app = FeatsenseApp(params, in_memory_map=True, device="cpu",
                           fusion=name, edge_capacity=512,
                           surf_capacity=1024, cloud_capacity=4096,
                           odom_kwargs=dict(edge_map_capacity=2048,
                                            surf_map_capacity=4096))
        with one_thread():
            poses = np.stack([app.process_scan(s) for s in scans])
        runs[name] = (poses, app.mapping.state.value.numpy().copy(),
                      app.mapping.state.weight.numpy().copy())
        app.terminate()
    for a, b in zip(runs["pallas"], runs["projective-level"]):
        np.testing.assert_array_equal(a, b)
    assert int((runs["pallas"][2] != 0).sum()) > 1_000


# ------------------------------------------------- tsdf_update(pos_mode)

RM_TAU, RM_RES = 3000, 1000
RM_SIZE = (21, 21, 21)


def _fori_op_by_op(lo, hi, body, init):
    for k in range(lo, hi):
        init = body(jnp.int32(k), init)
    return init


def _corner_points():
    """tests/test_tsdf_device.py's golden line and 40 seeded points."""
    rng = np.random.default_rng(42)
    pts = np.stack([rng.integers(2000, 9000, size=40),
                    rng.integers(-6000, 6000, size=40),
                    rng.integers(-3000, 3000, size=40)], axis=1)
    return np.concatenate([[[5500, 500, 500]], pts]).astype(np.int32)


def test_ray_march_corner_mode_matches_jax():
    """The ray march from the scanner voxel's corner equals op-by-op JAX's
    ``tsdf_update(pos_mode="corner")`` bit for bit, and differs from the
    centre mode; x_rows (a rank's slab) takes it too."""
    pts = _corner_points()
    mask = np.ones(len(pts), bool)
    up = np.array([0, 0, MR], np.int32)
    max_steps, max_isteps = jt.plan_raymarch(RM_TAU, RM_RES, 16000)
    kw = dict(size=RM_SIZE, tau=RM_TAU, max_weight=10 * WEIGHT_RESOLUTION,
              resolution=RM_RES, max_steps=max_steps, max_isteps=max_isteps)
    offset = [s // 2 for s in RM_SIZE]
    with jax.disable_jit(), unittest.mock.patch.object(
            jax.lax, "fori_loop", _fori_op_by_op):
        want = jt.tsdf_update(
            JState(value=jnp.full(RM_SIZE, RM_TAU, jnp.int16),
                   weight=jnp.zeros(RM_SIZE, jnp.int16),
                   pos=jnp.zeros(3, jnp.int32),
                   offset=jnp.asarray(offset, jnp.int32)),
            jnp.asarray(pts), jnp.asarray(mask), jnp.zeros(3, jnp.int32),
            jnp.asarray(up), pos_mode="corner", **kw)

    def port(mode, x_rows=None):
        lo, hi = x_rows or (0, RM_SIZE[0])
        st = state_from_numpy(np.full(RM_SIZE, RM_TAU)[lo:hi],
                              np.zeros(RM_SIZE)[lo:hi], [0, 0, 0], offset,
                              device="cpu")
        return tt.tsdf_update(st, torch.as_tensor(pts), torch.as_tensor(mask),
                              torch.zeros(3, dtype=torch.int32),
                              torch.as_tensor(up), pos_mode=mode,
                              x_rows=x_rows, **kw)

    got = port("corner")
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(want.value))
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    assert int((np.asarray(want.weight) != 0).sum()) > 100
    center = port("center")
    assert not np.array_equal(center.weight.numpy(), got.weight.numpy())
    half = port("corner", (7, 14))
    np.testing.assert_array_equal(half.value.numpy(),
                                  np.asarray(want.value)[7:14])
    np.testing.assert_array_equal(half.weight.numpy(),
                                  np.asarray(want.weight)[7:14])
    with pytest.raises(ValueError, match="pos_mode"):
        port("edge")


# --------------------------------------------------------- jacobian_stats

def test_jacobian_stats_matches_jax():
    """``jacobian_stats`` from a ray-marched map state: JAX's statistics
    within rtol 1e-5 (H and g also against their largest entry), c
    exactly, in both gradient modes; the port's own fields path to the
    bit."""
    size, tau, res = (41, 41, 33), 600, 64
    rng = np.random.default_rng(3)
    pts = _room(3000, 1100, 900, seed=3)
    steps = jt.plan_raymarch(tau, res, 3000)
    js = jt.tsdf_update(
        JState(value=jnp.full(size, tau, jnp.int16),
               weight=jnp.zeros(size, jnp.int16), pos=jnp.zeros(3, jnp.int32),
               offset=jnp.asarray([s // 2 for s in size], jnp.int32)),
        jnp.asarray(pts), jnp.ones(len(pts), bool), jnp.zeros(3, jnp.int32),
        jnp.asarray([0, 0, MR], jnp.int32), size=size, tau=tau,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=res,
        max_steps=steps[0], max_isteps=steps[1])
    ts = state_from_numpy(np.asarray(js.value), np.asarray(js.weight),
                          np.asarray(js.pos), np.asarray(js.offset),
                          device="cpu")
    cloud = np.unique(_room(600, 1100, 900, seed=4) // res * res + res // 2,
                      axis=0).astype(np.int32)
    mask = np.ones(len(cloud), bool)
    mask[::11] = False
    pose = np.eye(4, dtype=np.float32)
    a = math.radians(0.7)
    pose[:2, :2] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
    pose[:3, 3] = rng.uniform(-60, 60, 3)
    for normalize in (False, True):
        kw = dict(size=size, resolution=res, normalize_gradient=normalize)
        want = jreg.jacobian_stats(js, jnp.asarray(cloud), jnp.asarray(mask),
                                   jnp.asarray(pose), **kw)
        args = (torch.as_tensor(cloud), torch.as_tensor(mask),
                torch.as_tensor(pose))
        got = treg.jacobian_stats(ts, *args, **kw)
        fields = treg.jacobian_stats_fields(treg.precompute_fields(ts),
                                            ts.pos, ts.offset, *args, **kw)
        for x, y in zip(got, fields):
            assert torch.equal(x, y)
        H, g, e, c = (np.asarray(x, np.float64) for x in want)
        assert float(got[3]) == c and c > 100
        np.testing.assert_allclose(got[0].numpy(), H, rtol=1e-5,
                                   atol=1e-5 * np.abs(H).max())
        np.testing.assert_allclose(got[1].numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())
        np.testing.assert_allclose(float(got[2]), e, rtol=1e-5)


# -------------------------------------------------------------- knn(exact)

def test_knn_exact_keyword_selects_the_same_neighbours():
    """``exact=False`` and ``exact=True`` give the same bits, and JAX's
    indices off a TPU (where it too takes the exact top_k)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(300, 3)).astype(np.float32) * 5
    m = rng.normal(size=(900, 3)).astype(np.float32) * 5
    mask = rng.uniform(size=900) > 0.2
    args = (torch.as_tensor(q), torch.as_tensor(m), torch.as_tensor(mask), 5)
    i0, d0 = todo.knn(*args)
    i1, d1 = todo.knn(*args, exact=True)
    i2, d2 = todo.knn(*args, exact=False)
    for a, b in ((i0, i1), (i0, i2), (d0, d1), (d0, d2)):
        assert torch.equal(a, b)
    for exact in (False, True):
        ji, _ = jodo.knn(jnp.asarray(q), jnp.asarray(m), jnp.asarray(mask), 5,
                         exact=exact)
        np.testing.assert_array_equal(i0.numpy(), np.asarray(ji))


# --------------------------------------------------------- ScanQueue.backend

def test_scan_queue_backend_is_jaxs():
    """The default queue's backend is JAX's on the same build ("native"
    where the C++ library builds); "python" when asked; read-only."""
    want = jnq.ScanQueue(4).backend
    assert want in ("native", "python")
    assert isinstance(tnq.ScanQueue.backend, property)
    assert tnq.ScanQueue(4).backend == want == "native"
    q = tnq.ScanQueue(4, backend="python")
    assert q.backend == "python"
    with pytest.raises(AttributeError):
        q.backend = "native"
