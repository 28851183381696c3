"""The exact z cull of kernel K1's level sweep, held against the sweep.

``ops/tsdf_projective.column_z_limits`` is the plain model of what K1
computes per (x, y) column before any per-voxel math: whether the column's
beam row holds a finite range, and the run of global z outside which no
voxel can pass the sweep's ``ok``.  Here, on the same inputs:

* every voxel that the sweep updates (the port's plain sweep and JAX's
  twin, which agree bit for bit at these windows) lies inside its column's
  run, and no voxel of a skipped column is updated;
* the run is exactly the set of voxels where the cull's condition holds,
  evaluated voxel by voxel: the condition holds on one run of global z and
  the binary search finds its ends;
* the voxel counts that chip_smoke.py's bound for K1 uses come out as
  stated.

Windows: the scanner at the center and near the window's edge, a cloud
that leaves most columns without a hit, and a ring offset on all three
axes (a window after ``shift``, whose z coordinates come rotated)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.ops import tsdf_projective as jtp
from warpsense_tpu_torch.interop import state_from_numpy
from warpsense_tpu_torch.io.synthetic import box_room_cloud
from warpsense_tpu_torch.ops import tsdf_projective as ttp

TAU, RES = 600, 64
CH, COLS, VFOV = 32, 256, 45.0
KW = dict(tau=TAU, resolution=RES, channels=CH, columns=COLS,
          vfov_deg=VFOV)
SIZE = (64, 56, 40)

# name -> (window pos, ring offset, scanner voxel, cloud)
CASES = {
    "center": ((0, 0, 0), None, (0, 0, 0), "room"),
    "near_edge": ((0, 0, 0), None, (29, -26, 17), "room"),
    "sparse": ((0, 0, 0), None, (2, 1, 0), "wedge"),
    "ring_offset": ((3, -2, 1), (5, 40, 9), (3, -2, 1), "room"),
}


def _inputs(name):
    pos, offset, scanner, cloud = CASES[name]
    if offset is None:
        offset = [s // 2 for s in SIZE]
    st = state_from_numpy(np.full(SIZE, TAU), np.zeros(SIZE), pos, offset,
                          device="cpu")
    pts = box_room_cloud(6000, 1000, 700, seed=3)
    mask = np.ones(len(pts), bool)
    if cloud == "wedge":
        # a 60-degree wedge of the room: most azimuth columns see nothing
        mask = (pts[:, 0] > 0) & (np.abs(pts[:, 1]) < 0.58 * pts[:, 0])
    spos = torch.tensor(scanner, dtype=torch.int32)
    eye = torch.eye(3)
    rng_tab, endpoint, smm, cx, cy, cz = ttp.fusion_inputs(
        st, torch.as_tensor(pts), torch.as_tensor(mask), spos, eye,
        size=SIZE, **KW)
    return st, (cx, cy, cz, rng_tab, endpoint, smm, eye)


def _keep_everywhere(cx, cy, cz, rng_tab, rot):
    """The cull's condition voxel by voxel, (X, Y, Z) in global z order."""
    f = lambda v: ttp._f32(v, cx)                      # noqa: E731
    x, y = cx[:, None, None], cy[None, :, None]
    zg = torch.roll(cz, -rot)[None, None, :]
    colf = (ttp.atan2_poly(y, x) + f(math.pi)) * f(COLS / (2 * math.pi))
    col = torch.remainder(torch.round(colf).to(torch.int32), COLS)
    col_res = torch.abs(colf - torch.round(colf))
    rows = rng_tab.reshape(COLS, CH)
    finite = torch.isfinite(rows)
    rmax = torch.where(finite, rows, f(-math.inf)).amax(1)[col.long()]
    r_vox = ttp._sqrt(x * x + y * y + zg * zg)
    return ((r_vox <= rmax + f(float(TAU)))
            & (r_vox * col_res * f(2 * math.pi / COLS) <= f(RES * 0.5)))


@pytest.mark.parametrize("name", list(CASES))
def test_cull_holds_every_update_of_the_sweep(name):
    st, args = _inputs(name)
    cx, cy, cz, rng_tab, endpoint, smm, eye = args
    Z = SIZE[2]
    skip, lo, hi, rot = ttp.column_z_limits(cx, cy, cz, rng_tab, tau=TAU,
                                            resolution=RES, channels=CH,
                                            columns=COLS)
    if CASES[name][1] is not None:
        assert rot != 0                 # the ring offset rotates z
    j = torch.arange(Z)
    run = (j >= lo[..., None]) & (j < hi[..., None])
    assert not bool(run[skip].any())

    # the run is exactly where the condition holds
    keep = _keep_everywhere(cx, cy, cz, rng_tab, rot)
    assert torch.equal(run, keep)

    # every voxel the sweep updates lies in its column's run
    _, nw = ttp.projective_sweep_coords(*args, **KW)
    ok = torch.roll(nw != 0, -rot, dims=2)
    assert int(ok.sum()) > 500
    assert not bool((ok & ~run).any())
    # ... and JAX's twin updates the same voxels
    pos, offset = st.pos.numpy(), st.offset.numpy()
    g = jtp._global_coords(jnp.asarray(pos), jnp.asarray(offset), SIZE)
    _, jw = jtp.projective_sweep_coords(
        *g, jnp.asarray(rng_tab.numpy()), jnp.asarray(endpoint.numpy()),
        jnp.asarray(smm.numpy()), jnp.eye(3, dtype=jnp.float32), **KW)
    np.testing.assert_array_equal(np.asarray(jw) != 0, (nw != 0).numpy())

    # the cull leaves work out; the wedge leaves most columns empty
    assert int(run.sum()) < 0.8 * math.prod(SIZE)
    if CASES[name][3] == "wedge":
        assert float(skip.float().mean()) > 0.5


@pytest.mark.parametrize("name", ["center", "ring_offset"])
@pytest.mark.parametrize("level", [True, False])
def test_fusion_work_counts(name, level):
    """fusion_work's counts are the ones its docstring states, and every
    fused voxel is among the ranged ones."""
    st, args = _inputs(name)
    cx, cy, cz, rng_tab, endpoint, smm, eye = args
    X, Y, Z = SIZE
    work = ttp.fusion_work(*args, level=level, **KW)
    # fused voxels: the update condition holds; on a fresh map, exactly
    # the voxels that end with a nonzero weight
    beams, _ = ttp.beam_rows(rng_tab, endpoint, smm, columns=COLS)
    ttp.sweep_rows_plain(st.value, st.weight, cx, cy, cz, beams, eye,
                         max_weight=2048, **KW)
    fused = int((st.weight != 0).sum())
    assert work["fused_voxels"] == fused > 1000
    assert work["voxels"] == X * Y * Z and work["columns"] == X * Y
    if level:
        keep = _keep_everywhere(cx, cy, cz, rng_tab, ttp.z_rotation(cz))
        assert work["swept_voxels"] == int(keep.sum())
        assert fused <= work["swept_voxels"] < work["voxels"]
    else:
        assert work["swept_voxels"] == work["voxels"]
    # ranged voxels: r_vox (at R = I, the length of d) within tau of the
    # table's largest finite range, a condition every fused voxel meets
    x, y, z = cx[:, None, None], cy[None, :, None], cz[None, None, :]
    rmax = rng_tab[torch.isfinite(rng_tab)].max()
    ranged = ttp._sqrt(x * x + y * y + z * z) <= rmax + TAU
    assert work["ranged_voxels"] == int(ranged.sum()) < work["voxels"]
    assert not bool(((st.weight != 0) & ~ranged).any())
    if level:                     # the column's range is within the table's
        assert work["swept_voxels"] <= work["ranged_voxels"]


def test_z_rotation_follows_the_ring_offset():
    """relative_coords gives cz as ascending global z rotated so that
    global rank 0 lies at array index (offset - Z // 2) mod Z."""
    for off in (0, 7, 20, 39):
        pos = torch.tensor([0, 0, 5], dtype=torch.int32)
        offset = torch.tensor([32, 28, off], dtype=torch.int32)
        _, _, cz = ttp.relative_coords(pos, offset, SIZE,
                                       torch.tensor([32, 32, 32]), RES)
        rot = ttp.z_rotation(cz)
        assert rot == (off - SIZE[2] // 2) % SIZE[2]
        assert bool((torch.diff(torch.roll(cz, -rot)) == RES).all())
