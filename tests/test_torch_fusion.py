"""Port vs JAX: projective TSDF fusion (the plain version of kernel K1).

Sizes follow tests/test_tsdf_pallas.py: window (48, 48, 32), 32 channels x
256 columns.  The port's sweep is held bit-exact against the JAX XLA twin
(``tsdf_update_projective``) and the Pallas level kernel in interpret mode
(``tsdf_update_projective_pallas(identity_rot=True)``).

Two float effects were found and are pinned by tests below:
* PyTorch's CPU float32 ``sqrt`` is not correctly rounded; the port takes
  its sqrt in float64 (ops/tsdf_projective._sqrt).
* XLA:CPU contracts multiply-adds into FMAs inside its fusions.  At this
  window every product is exact (coordinates below 2^12 mm), so the
  contraction cannot show; at larger coordinates it changes a few voxels
  of the jitted JAX sweep and ~3% of the beam table's ranges.  The port
  and kernel K1 (-fmad=false) keep the unfused semantics, which op-by-op
  JAX shares bit for bit.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.core.consts import WEIGHT_RESOLUTION
from warpsense_tpu.kernels.tsdf_pallas import tsdf_update_projective_pallas
from warpsense_tpu.map.local_map import LocalMapState as JState
from warpsense_tpu.ops import tsdf_projective as jtp
from warpsense_tpu_torch.core.config import Params
from warpsense_tpu_torch.interop import state_from_numpy
from warpsense_tpu_torch.kernels.fusion import fusion_sweep_merge
from warpsense_tpu_torch.ops import tsdf_projective as ttp
from warpsense_tpu_torch.pipeline import fusion_backend as tfb

SIZE = (48, 48, 32)
TAU, RES = 600, 64
CH, COLS, VFOV = 32, 256, 45.0
KW = dict(size=SIZE, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
          resolution=RES, channels=CH, columns=COLS, vfov_deg=VFOV)


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


def _tilt(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]], np.float32)


def _roll(rad):
    c, s = np.cos(rad), np.sin(rad)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _jfresh():
    return JState(value=jnp.full(SIZE, TAU, jnp.int16),
                  weight=jnp.zeros(SIZE, jnp.int16),
                  pos=jnp.zeros(3, jnp.int32),
                  offset=jnp.asarray([s // 2 for s in SIZE], jnp.int32))


def _tfresh():
    return state_from_numpy(np.full(SIZE, TAU), np.zeros(SIZE), [0, 0, 0],
                            [s // 2 for s in SIZE], device="cpu")


def _tfuse(st, pts, mask, origin, R, level, vfov=VFOV):
    return ttp.tsdf_update_projective(
        st, torch.as_tensor(pts), torch.as_tensor(mask),
        torch.as_tensor(np.asarray(origin, np.int32)), torch.as_tensor(R),
        level=level, **{**KW, "vfov_deg": vfov})


def _assert_same(t, j):
    np.testing.assert_array_equal(t.value.numpy(), np.asarray(j.value))
    np.testing.assert_array_equal(t.weight.numpy(), np.asarray(j.weight))


@pytest.mark.parametrize("seed", [0, 5])
def test_fusion_bit_exact_level_two_fusions(seed):
    """R = I, twice (the second from a shifted scanner exercises the
    averaging merge): equal to the XLA twin and the Pallas level kernel."""
    pts = _room(seed=seed)
    mask = np.ones(len(pts), bool)
    R = np.eye(3, dtype=np.float32)
    t = _tfresh()
    a, b = _jfresh(), _jfresh()
    for origin in ((0, 0, 0), (2, -1, 1)):
        o = jnp.asarray(origin, jnp.int32)
        a = jtp.tsdf_update_projective(a, jnp.asarray(pts), jnp.asarray(mask),
                                       o, jnp.asarray(R), **KW)
        b = tsdf_update_projective_pallas(
            b, jnp.asarray(pts), jnp.asarray(mask), o, jnp.asarray(R),
            identity_rot=True, **KW)
        t = _tfuse(t, pts, mask, origin, R, level=True)
        _assert_same(t, a)
        _assert_same(t, b)
    assert int((t.weight != 0).sum()) > 500


# a handheld OS0-128's case: 90 deg, the widest vertical field of view
# check_fusion_config admits (beams twice as far apart), tilted and rolled
_ROLLED = pytest.param(6.0, 90.0, 0.05, id="6.0-vfov90-rolled")


@pytest.mark.parametrize("deg,vfov,roll", [
    pytest.param(4.0, VFOV, 0.0, id="4.0"),
    pytest.param(11.0, VFOV, 0.0, id="11.0"), _ROLLED])
def test_fusion_bit_exact_tilted(deg, vfov, roll):
    """Under tilt the port computes the twin's attitude-binned sweep (no
    W=0 beam window): bit-exact against the XLA twin."""
    pts = _room(seed=3)
    mask = np.ones(len(pts), bool)
    R = _tilt(deg) @ _roll(roll)
    a = jtp.tsdf_update_projective(_jfresh(), jnp.asarray(pts),
                                   jnp.asarray(mask),
                                   jnp.zeros(3, jnp.int32), jnp.asarray(R),
                                   **{**KW, "vfov_deg": vfov})
    t = _tfuse(_tfresh(), pts, mask, (0, 0, 0), R, level=False, vfov=vfov)
    _assert_same(t, a)
    assert int((t.weight != 0).sum()) > 500


def test_fusion_empty_scan_is_identity():
    pts = _room()
    t = _tfuse(_tfresh(), pts, np.zeros(len(pts), bool), (0, 0, 0),
               np.eye(3, dtype=np.float32), level=True)
    assert int((t.weight != 0).sum()) == 0
    assert bool((t.value == TAU).all())


def test_fusion_ring_offset_window():
    """A shifted ring (pos/offset != defaults): global coordinates fold in
    exactly like the JAX sweep."""
    pts = _room(seed=7)
    mask = np.ones(len(pts), bool)
    pos, off = np.array([3, -2, 1], np.int32), np.array([5, 40, 9], np.int32)
    j = JState(value=jnp.full(SIZE, TAU, jnp.int16),
               weight=jnp.zeros(SIZE, jnp.int16), pos=jnp.asarray(pos),
               offset=jnp.asarray(off))
    a = jtp.tsdf_update_projective(j, jnp.asarray(pts), jnp.asarray(mask),
                                   jnp.asarray([3, -2, 1], jnp.int32),
                                   jnp.eye(3, dtype=jnp.float32), **KW)
    t = state_from_numpy(np.full(SIZE, TAU), np.zeros(SIZE), pos, off,
                         device="cpu")
    t = _tfuse(t, pts, mask, (3, -2, 1), np.eye(3, dtype=np.float32),
               level=True)
    _assert_same(t, a)


def _range(d, contract):
    """|d| in float32 from (N, 3) float32 rows: the unfused sum of squares,
    or XLA:CPU's contracted one (each a*a + acc as one fused multiply-add,
    emulated exactly: a*a is exact in float64 and so is the sum)."""
    d64 = d.astype(np.float64)
    if not contract:
        sq = (d * d).astype(np.float32)
        return np.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2])
    s = (d64[:, 0] * d64[:, 0]).astype(np.float32)
    for k in (1, 2):
        s = (s.astype(np.float64) + d64[:, k] * d64[:, k]).astype(np.float32)
    return np.sqrt(s)


def _table(pts, d, ring, col, smm, contract):
    """numpy beam table from per-point directions and bins (the scatter-min
    of (range/8mm << 17 | index) of build_beam_table, then endpoint and
    range), with unfused or contracted float32 ranges."""
    rng = _range(d, contract)
    ok = (rng > 1.0) & (ring >= 0) & (ring < BIG_CH)
    key = (np.minimum(rng / np.float32(8.0), np.float32(2 ** 14 - 1))
           .astype(np.int32) << 17) | np.arange(len(pts), dtype=np.int32)
    table = np.full(BIG_CH * BIG_COLS, 2 ** 30, np.int64)
    np.minimum.at(table, (col * BIG_CH + ring)[ok], key[ok])
    hit = table < 2 ** 30
    endpoint = np.where(hit[:, None], pts[np.where(
        hit, table & ((1 << 17) - 1), 0)].astype(np.float32), np.float32(0))
    rel = endpoint - smm.astype(np.float32)
    return np.where(hit, _range(rel, contract), np.float32(np.inf)), endpoint


BIG_CH, BIG_COLS = 128, 1024


def _bins(d, rng, atan2, asin, vfov):
    """(ring, col) of each direction, as build_beam_table bins them."""
    sin_el = np.clip(d[:, 2] / np.maximum(rng, np.float32(1.0)), -1, 1)
    az = atan2(np.ascontiguousarray(d[:, 1]), np.ascontiguousarray(d[:, 0]))
    el = asin(sin_el.astype(np.float32))
    spacing = np.float32(math.radians(vfov) / (BIG_CH - 1))
    ring = np.round((np.float32(math.radians(vfov) / 2) - el) / spacing)
    col = np.round((az + np.float32(math.pi)) / np.float32(2 * math.pi)
                   * np.float32(BIG_COLS)).astype(np.int32) % BIG_COLS
    return ring.astype(np.int32), col


@pytest.mark.parametrize("deg,vfov,roll", [
    pytest.param(0.0, VFOV, 0.0, id="0.0"),
    pytest.param(4.0, VFOV, 0.0, id="4.0"), _ROLLED])
def test_beam_table_against_jax(deg, vfov, roll):
    """The beam table on its own, with the full 32K-point room cloud at a
    128 x 1024 scanner.  Two sources of difference, each pinned here:

    * ring/column bins come from library arctan2/arcsin, whose last bit
      differs between XLA:CPU and PyTorch; a point within an ulp of a bin
      edge lands one bin over.  Such flips are counted (1 point of 32,766
      in each case here) and must be single bins.
    * XLA:CPU contracts multiply-adds into FMAs inside its fusions (the
      direction matmul and the fused ``jnp.linalg.norm``), so its ranges
      round differently once squares pass 2^24 mm^2; the port (and kernel
      K1, built with -fmad=false) rounds every product.  A numpy table
      with contracted arithmetic reproduces the JAX table exactly and one
      with unfused arithmetic the port's, so every differing beam (~750
      of ~24,000 hit beams here) is accounted for."""
    from warpsense_tpu.io.synthetic import box_room_cloud
    pts = box_room_cloud(32766, 625 * 64 * 45 // 100, 235 * 64 * 40 // 100)
    mask = np.ones(len(pts), bool)
    R = _tilt(deg) @ _roll(roll)
    smm = np.array([32, 32, 32], np.int32)
    kw = dict(channels=BIG_CH, columns=BIG_COLS, vfov_deg=vfov)
    jr, je = jtp.build_beam_table(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.asarray(smm), jnp.asarray(R), **kw)
    tr, te = ttp.build_beam_table(torch.as_tensor(pts), torch.as_tensor(mask),
                                  torch.as_tensor(smm), torch.as_tensor(R),
                                  **kw)
    jax_tab = (np.asarray(jr), np.asarray(je))
    port_tab = (tr.numpy(), te.numpy())

    p = (pts - smm).astype(np.float32)
    d_jax = (p @ R).astype(np.float32)                  # contracted dot
    d_port = np.stack([(p[:, 0] * R[0, j] + p[:, 1] * R[1, j])
                       + p[:, 2] * R[2, j] for j in range(3)], axis=1)
    jring, jcol = _bins(d_jax, _range(d_jax, True),
                        lambda y, x: np.asarray(jnp.arctan2(y, x)),
                        lambda v: np.asarray(jnp.arcsin(v)), vfov)
    tring, tcol = _bins(d_port, _range(d_port, False),
                        lambda y, x: torch.atan2(torch.as_tensor(y),
                                                 torch.as_tensor(x)).numpy(),
                        lambda v: torch.asin(torch.as_tensor(v)).numpy(),
                        vfov)
    flips = (jring != tring) | (jcol != tcol)
    assert np.all(np.abs(jring - tring) <= 1)
    assert np.all(np.minimum(np.abs(jcol - tcol),
                             BIG_COLS - np.abs(jcol - tcol)) <= 1)
    assert int(flips.sum()) <= len(pts) // 1000

    for tab, d, ring, col, contract in ((jax_tab, d_jax, jring, jcol, True),
                                        (port_tab, d_port, tring, tcol,
                                         False)):
        nr, ne = _table(pts, d, ring, col, smm, contract)
        np.testing.assert_array_equal(ne, tab[1])
        np.testing.assert_array_equal(nr, tab[0])
    differ = int(np.sum((jax_tab[0] != port_tab[0])
                        | np.any(jax_tab[1] != port_tab[1], axis=1)))
    print(f"tilt {deg}, vfov {vfov}: {int(flips.sum())} bin flips; {differ} of "
          f"{int(np.isfinite(port_tab[0]).sum())} beams differ through "
          "contraction")


def test_xla_contraction_bound_in_the_sweep():
    """At large scanner-relative coordinates (squares past 2^24, here up to
    ~6.4 m), op-by-op JAX and the port agree bit for bit; the JITTED JAX
    sweep contracts multiply-adds into FMAs (see the norm above) and so
    differs in a handful of voxels: bounded here at 1e-5 of the fused
    voxels (2 of 324,569 measured).  Kernel K1 follows the unfused
    semantics (-fmad=false)."""
    from warpsense_tpu.io.synthetic import box_room_cloud
    size = (200, 200, 48)
    kw = dict(tau=TAU, resolution=RES, channels=64, columns=512,
              vfov_deg=VFOV)
    pts = box_room_cloud(8000, 5500, 1200, seed=1)
    mask = np.ones(len(pts), bool)
    smm = np.array([32, 32, 32], np.int32)
    R = np.eye(3, dtype=np.float32)
    jr, je = jtp.build_beam_table(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.asarray(smm), jnp.asarray(R),
                                  channels=64, columns=512, vfov_deg=VFOV)
    pos = jnp.zeros(3, jnp.int32)
    off = jnp.asarray([s // 2 for s in size], jnp.int32)
    g = jtp._global_coords(pos, off, size)

    def sweep(*a):
        return jtp.projective_sweep_coords(*a, jnp.asarray(smm),
                                           jnp.asarray(R), **kw)
    eager = [np.asarray(x) for x in sweep(*g, jr, je)]
    jitted = [np.asarray(x) for x in jax.jit(sweep)(*g, jr, je)]
    cx, cy, cz = ttp.relative_coords(torch.as_tensor(np.asarray(pos)),
                                     torch.as_tensor(np.asarray(off)), size,
                                     torch.as_tensor(smm), RES)
    port = [x.numpy() for x in ttp.projective_sweep_coords(
        cx, cy, cz, torch.as_tensor(np.array(jr)),
        torch.as_tensor(np.array(je)), torch.as_tensor(smm),
        torch.as_tensor(R), **kw)]
    fused = int(np.sum(eager[1] != 0))
    assert fused > 100_000
    for e, p in zip(eager, port):
        np.testing.assert_array_equal(p, e)
    n_diff = int(np.sum((jitted[0] != port[0]) | (jitted[1] != port[1])))
    assert n_diff <= fused * 1e-5, n_diff


@pytest.mark.parametrize("deg", [0.0, 4.0])
def test_sweep_on_jax_table_bit_exact(deg):
    """Fed the JAX-built beam table, the port's sweep equals the JAX sweep
    (so any fusion difference could only come from the table)."""
    pts = _room(seed=13)
    mask = np.ones(len(pts), bool)
    R = _tilt(deg)
    smm = np.array([32, 32, 32], np.int32)
    jr, je = jtp.build_beam_table(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.asarray(smm), jnp.asarray(R),
                                  channels=CH, columns=COLS, vfov_deg=VFOV)
    js = _jfresh()
    gx, gy, gz = jtp._global_coords(js.pos, js.offset, SIZE)
    kw = dict(tau=TAU, resolution=RES, channels=CH, columns=COLS,
              vfov_deg=VFOV)
    jv, jw = jtp.projective_sweep_coords(gx, gy, gz, jr, je,
                                         jnp.asarray(smm), jnp.asarray(R),
                                         **kw)
    ts = _tfresh()
    cx, cy, cz = ttp.relative_coords(ts.pos, ts.offset, SIZE,
                                     torch.as_tensor(smm), RES)
    tv, tw = ttp.projective_sweep_coords(
        cx, cy, cz, torch.as_tensor(np.asarray(jr)),
        torch.as_tensor(np.asarray(je)), torch.as_tensor(smm),
        torch.as_tensor(R), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the K1 wrapper runs the plain version and does not
    count a launch; a level call with a non-identity rotation raises, and
    so does a call with a plain table's nine positional inputs (the
    wrapper takes prepared rows only)."""
    pts = _room()
    mask = np.ones(len(pts), bool)
    before = fusion_sweep_merge.launches
    _tfuse(_tfresh(), pts, mask, (0, 0, 0), np.eye(3, dtype=np.float32),
           level=True)
    assert fusion_sweep_merge.launches == before
    with pytest.raises(ValueError, match="identity"):
        _tfuse(_tfresh(), pts, mask, (0, 0, 0), _tilt(1.0), level=True)
    st = _tfresh()
    table = {k: v for k, v in KW.items() if k != "max_weight"}
    rng_tab, endpoint, smm, cx, cy, cz = ttp.fusion_inputs(
        st, torch.as_tensor(pts), torch.as_tensor(mask), (0, 0, 0),
        torch.eye(3), **table)
    with pytest.raises(TypeError):
        fusion_sweep_merge(st.value, st.weight, cx, cy, cz, rng_tab,
                           endpoint, smm, torch.eye(3), level=True,
                           **{k: v for k, v in KW.items() if k != "size"})


def test_fusion_dispatch():
    assert tfb.resolve_fusion("auto", size=(625, 625, 235),
                              channels=128) == "projective-level"
    with pytest.raises(ValueError):
        tfb.resolve_fusion("auto", size=(2048, 2048, 1024), channels=128)
    pose = np.eye(4, dtype=np.float32)
    R, level = tfb.grid_rotation_for(pose, VFOV)
    assert level and torch.equal(R, torch.eye(3))
    pose[:3, :3] = _tilt(3.0)
    R, level = tfb.grid_rotation_for(pose, VFOV)
    assert not level and np.allclose(R.numpy(), _tilt(3.0))
    assert abs(tfb.sensor_tilt_deg(pose) - 3.0) < 1e-3
    # "auto" counts the grid it bins on, level or attitude, each call
    from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator
    params = Params.from_dict({"lidar": {"channels": CH, "vfov": 90.0,
                                         "hresolution": COLS}})
    pts = torch.as_tensor(_room(seed=2))
    mask = torch.ones(len(pts), dtype=torch.bool)
    counters = RuntimeEvaluator.get_instance().counters
    before = [counters().get(f"fusion_grid_{g}", 0)
              for g in ("level", "attitude")]
    for tilt in (0.0, 6.0, 1.0):
        pose[:3, :3] = _tilt(tilt)
        tfb.fuse_cloud(_tfresh(), pts, mask, pose, params=params, size=SIZE,
                       fusion="auto")
    assert [counters()[f"fusion_grid_{g}"] for g in ("level", "attitude")] \
        == [before[0] + 2, before[1] + 1]
    # the ray march needs its plan (tests/test_torch_raymarch.py runs it);
    # an unknown name is refused ("pallas" is JAX's name of the level
    # path: tests/test_torch_api_parity.py)
    with pytest.raises(ValueError, match="max_steps"):
        tfb.fuse_cloud(_tfresh(), None, None, pose, params=Params(),
                       size=SIZE, fusion="raymarch")
    with pytest.raises(ValueError, match="unknown fusion"):
        tfb.fuse_cloud(_tfresh(), None, None, pose, params=Params(),
                       size=SIZE, fusion="mosaic")

