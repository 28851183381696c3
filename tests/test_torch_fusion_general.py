"""The early-outs of kernel K1's general sweep, held against the sweep.

``ops/tsdf_projective.general_rejects`` is the plain model of the stages at
which the general sweep (csrc/fusion.cu ``general_kernel``) leaves a voxel:
the range test against the table's largest finite range + tau, ring_ok,
the vertical and the horizontal acceptance, and the beam's own tests.  Here,
on the same inputs, at small windows (the scanner at the center and near
an edge, and a window whose ring offset is nonzero on all three axes),
tilts of 4 and 12 degrees, and 32 x 128, 16 x 128 or 32 x 96 beams (with
16 channels the vertical band rejects voxels too):

* no voxel that a stage rejects is updated by the sweep (the port's plain
  sweep, which equals JAX's twin bit for bit here);
* the voxels that pass every stage produce exactly the twin's planes;
* fusion_work counts the stages as the model gives them;
* the column index without a modulo: rint(colf) lies in [0, columns] on
  the extreme inputs, so one conditional subtraction is the floor mod.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.ops import tsdf_projective as jtp
from warpsense_tpu_torch.core.config import Params
from warpsense_tpu_torch.interop import state_from_numpy
from warpsense_tpu_torch.io.synthetic import box_room_cloud
from warpsense_tpu_torch.ops import tsdf_projective as ttp
from warpsense_tpu_torch.pipeline import fusion_backend as tfb

TAU, RES, VFOV = 600, 64, 45.0

# name -> (window, pos, ring offset, scanner voxel, channels, columns)
WINDOWS = {
    "center": ((48, 40, 32), (0, 0, 0), None, (0, 0, 0), 32, 128),
    "near_edge": ((40, 44, 30), (0, 0, 0), None, (12, -14, 7), 16, 128),
    "ring_offset": ((44, 38, 28), (3, -2, 1), (5, 30, 9), (3, -2, 1), 32,
                    96),
}


def _rotation(deg):
    """A tilt of ``deg`` from the vertical about an oblique horizontal axis
    (pitch and roll together), with some yaw."""
    a = np.radians(deg)
    axis = np.array([0.6, 0.8, 0.0])
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    tilt = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    c, s = np.cos(0.3), np.sin(0.3)
    yaw = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return (yaw @ tilt).astype(np.float32)


def _inputs(name, deg):
    size, pos, offset, scanner, ch, cols = WINDOWS[name]
    if offset is None:
        offset = [s // 2 for s in size]
    st = state_from_numpy(np.full(size, TAU), np.zeros(size), pos, offset,
                          device="cpu")
    pts = box_room_cloud(6000, 800, 500, seed=3)
    pts = pts + np.asarray(scanner, np.int32) * RES
    R = torch.as_tensor(_rotation(deg))
    kw = dict(tau=TAU, resolution=RES, channels=ch, columns=cols,
              vfov_deg=VFOV)
    rng_tab, endpoint, smm, cx, cy, cz = ttp.fusion_inputs(
        st, torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool),
        torch.tensor(scanner, dtype=torch.int32), R, size=size, **kw)
    return st, (cx, cy, cz, rng_tab, endpoint, smm, R), kw


@pytest.mark.parametrize("deg", [4.0, 12.0])
@pytest.mark.parametrize("name", list(WINDOWS))
def test_rejected_voxels_never_fuse_and_survivors_match_jax(name, deg):
    st, args, kw = _inputs(name, deg)
    cx, cy, cz, rng_tab, endpoint, smm, R = args
    stage = ttp.general_rejects(cx, cy, cz, rng_tab, R, **kw)
    nv, nw = ttp.projective_sweep_coords(*args, **kw)
    counts = torch.bincount(stage.reshape(-1).long(), minlength=6).tolist()
    # every stage rejects voxels here; the vertical band only with 16
    # channels (with 32 its v_res stays within half a voxel at these ranges)
    needed = {1, 2, 4, 5} | ({3} if kw["channels"] == 16 else set())
    assert all(counts[k] > 0 for k in needed), counts
    assert int((nw != 0).sum()) > 500
    # no rejected voxel is updated
    assert not bool(((stage > 0) & (nw != 0)).any())
    # the survivors' planes are exactly JAX's twin's planes
    g = jtp._global_coords(jnp.asarray(st.pos.numpy()),
                           jnp.asarray(st.offset.numpy()), tuple(st.value.shape))
    jv, jw = jtp.projective_sweep_coords(
        *g, jnp.asarray(rng_tab.numpy()), jnp.asarray(endpoint.numpy()),
        jnp.asarray(smm.numpy()), jnp.asarray(R.numpy()), **kw)
    zero = torch.zeros_like(nv)
    np.testing.assert_array_equal(torch.where(stage == 0, nv, zero).numpy(),
                                  np.asarray(jv))
    np.testing.assert_array_equal(torch.where(stage == 0, nw, zero).numpy(),
                                  np.asarray(jw))


@pytest.mark.parametrize("name", ["center", "ring_offset"])
def test_fusion_work_counts_the_stages(name):
    _, args, kw = _inputs(name, 12.0)
    cx, cy, cz, rng_tab, endpoint, smm, R = args
    work = ttp.fusion_work(*args, level=False, **kw)
    stage = ttp.general_rejects(cx, cy, cz, rng_tab, R, **kw)
    counts = torch.bincount(stage.reshape(-1).long(), minlength=6).tolist()
    assert list(work["left_at"].values()) == counts
    assert list(work["left_at"]) == ["none", *ttp.GENERAL_STAGES]
    assert work["ranged_voxels"] == work["voxels"] - counts[1]
    # every fused voxel reaches the value's math
    assert 0 < work["fused_voxels"] <= counts[0]


def _colf(y, x, columns):
    """The sweep's float column of direction (x, y), as _bins computes it."""
    f = lambda v: ttp._f32(v, x)                       # noqa: E731
    return (ttp.atan2_poly(y, x) + f(math.pi)) * f(columns / (2 * math.pi))


@pytest.mark.parametrize("columns", [1, 2, 3, 64, 128, 360, 1000, 1024,
                                     2048, 4096, 65536, (1 << 21) - 1])
def test_column_index_needs_no_modulo(columns):
    """csrc/fusion.cu replaces the sweep's floor mod of rint(colf) by one
    conditional subtraction: rint(colf) lies in [0, columns].  Held on the
    extreme directions: each axis at +-0, tiny, unit and large values, so
    the azimuth reaches -pi_f and pi_f (y = -tiny or +-0 with x < 0)."""
    vals = [0.0, -0.0, 1e-30, -1e-30, 1e-7, -1e-7, 1.0, -1.0, 64.0, -64.0,
            1e5, -1e5, 3e7, -3e7]
    y, x = torch.tensor([[a, b] for a in vals for b in vals],
                        dtype=torch.float32).T
    cr = torch.round(_colf(y, x, columns))
    assert float(cr.min()) >= 0 and float(cr.max()) <= columns
    assert float(cr.max()) == columns          # az = pi_f reaches the end
    ci = cr.to(torch.int64)
    col = torch.where(ci >= columns, ci - columns, ci)
    assert torch.equal(col, torch.remainder(ci, columns))


def test_column_bound_for_every_column_count():
    """The note's bound: fl(2 pi_f * colK) rounds to at most ``columns`` for
    every column count below 2^21, and banded_atan stays in [0, 0.786] on
    [0, 1] (every float32 in [0.5, 1] and a dense grid below), so the
    azimuth stays within [-pi_f, pi_f]."""
    n = torch.arange(1, 1 << 21, dtype=torch.float64)
    colk = (n / (2 * math.pi)).to(torch.float32)
    top = ttp._f32(math.pi, colk) * 2 * colk     # 2 pi_f is exact
    assert bool((torch.round(top) <= n.to(torch.float32)).all())
    half = torch.arange(0x3F000000, 0x3F800001, dtype=torch.int32).view(
        torch.float32)
    t = torch.cat([torch.linspace(0.0, 0.5, 1 << 20), half])
    q = ttp.banded_atan(t)
    assert float(q.min()) >= 0.0 and float(q.max()) <= 0.786


@pytest.mark.parametrize("channels", [400, 2000])
def test_auto_fusion_takes_any_channel_count(channels):
    """"auto" resolves to the level grid at any channel count (on the card
    K1's level sweep opts into a block's full shared memory, and beyond
    it its wrapper runs the general sweep at R = I, the same bits); a
    CPU state fuses through the plain version without raising."""
    size = (24, 24, 16)
    assert tfb.resolve_fusion("auto", size=size,
                              channels=channels) == "projective-level"
    params = Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": RES, "max_weight": 10},
        "lidar": {"channels": channels, "hresolution": 64}})
    st = state_from_numpy(np.full(size, TAU), np.zeros(size), [0, 0, 0],
                          [s // 2 for s in size], device="cpu")
    pts = torch.as_tensor(box_room_cloud(20000, 600, 400, seed=1))
    tfb.fuse_cloud(st, pts, torch.ones(len(pts), dtype=torch.bool),
                   np.eye(4), params=params, size=size, fusion="auto")
    assert int((st.weight != 0).sum()) > 100
