"""The fusion's table step on the CPU: ``kernels/fusion.fusion_table`` runs
its plain version there, which must equal what the JAX twin computes for
it (``warpsense_tpu/ops/tsdf_projective``): the window's gate and
``build_beam_table``, the sweep's scanner-relative coordinates, and the
rows K1's prepare step makes of that table, bit for bit in every scene of
``_fusion_scenes``.  The card tests (tests/test_torch_cuda.py) hold the
kernel to this plain version bit for bit on the same scenes."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.map.local_map import in_bounds as jax_in_bounds
from warpsense_tpu.ops import tsdf_projective as jtp
from warpsense_tpu_torch.kernels.fusion import (fusion_sweep_merge,
                                                fusion_table)
from warpsense_tpu_torch.map.local_map import create_state
from warpsense_tpu_torch.ops import tsdf_projective as ttp

from _fusion_scenes import SCENES, TAU, scene, table_args

MAX_WEIGHT = 2048


def _jax_twin(sc):
    """The JAX twin's pieces of a scene: the gated mask, the beam table
    (range, endpoint), the scanner (mm), the rotation and the global voxel
    coordinates of the scene's x rows and of every y and z."""
    kw = sc["kw"]
    res = kw["resolution"]
    pts = jnp.asarray(sc["points"].numpy())
    pos = jnp.asarray(sc["pos"].numpy())
    smm = jnp.asarray(np.asarray(sc["scanner"], np.int32) * res + res // 2)
    rot = jnp.asarray(sc["rotation"].numpy())
    gate = jnp.asarray(sc["mask"].numpy()) & jax_in_bounds(
        jnp.floor_divide(pts, res), pos, jnp.asarray(sc["size"]),
        -(kw["tau"] // res // 2))
    rng_tab, endpoint = jtp.build_beam_table(
        pts, gate, smm, rot, channels=kw["channels"], columns=kw["columns"],
        vfov_deg=kw["vfov_deg"])
    gx, gy, gz = jtp._global_coords(pos, jnp.asarray(sc["offset"].numpy()),
                                    sc["size"])
    lo, hi = sc["x_rows"] or (0, sc["size"][0])
    return dict(gate=np.asarray(gate), rng_tab=rng_tab, endpoint=endpoint,
                smm=smm, rot=rot, g=(gx[lo:hi], gy, gz))


def _jax_rows(tw, kw):
    """(beams, rowmax, cx, cy, cz) from the twin's table and coordinates:
    the endpoint relative to the scanner beside the range, each column's
    largest finite range, the voxel centers relative to the scanner."""
    res = kw["resolution"]
    smm = np.asarray(tw["smm"])
    rng_tab = np.asarray(tw["rng_tab"])
    rel = np.asarray(tw["endpoint"]) - smm.astype(np.float32)
    rows = rng_tab.reshape(kw["columns"], -1)
    rowmax = np.where(np.isfinite(rows), rows, np.float32(-np.inf)).max(1)
    coords = [np.asarray((g * res + res // 2 - smm[ax]).astype(jnp.float32))
              for ax, g in enumerate(tw["g"])]
    return (np.concatenate([rel, rng_tab[:, None]], axis=1), rowmax,
            *coords)


@pytest.mark.parametrize("name", SCENES)
def test_table_step_cpu_path_is_its_composition(name):
    sc = scene(name, "cpu")
    launches = fusion_table.launches
    args, kw = table_args(sc)
    got = fusion_table(*args, **kw)
    tw = _jax_twin(sc)
    for g, w in zip(got, _jax_rows(tw, sc["kw"])):
        assert g.dtype == torch.float32 and w.dtype == np.float32
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.view(np.int32))
    # the CPU path launches nothing and counts nothing
    assert fusion_table.launches == launches
    beams = got[0]
    hits = torch.isfinite(beams[:, 3])
    # a hole's endpoint is 0: its row holds -scanner and +inf
    smm = torch.tensor(np.asarray(tw["smm"]))
    assert torch.equal(beams[~hits, :3],
                       (-smm.to(torch.float32)).expand(int((~hits).sum()),
                                                       3))
    if name == "empty-mask":
        assert not bool(hits.any())
        assert bool((got[1] == -math.inf).all())
        return
    assert int(hits.sum()) > 1000
    if name == "outside-window":
        assert 1000 < int(tw["gate"].sum()) < int(sc["mask"].sum())
    if name == "equal-keys":
        # two points on one beam at one range / 8 mm: the lower index wins
        rel = (sc["points"][:2] - smm).to(torch.float32)
        won = (beams[:, :3] == rel[0]).all(dim=1) & hits
        lost = (beams[:, :3] == rel[1]).all(dim=1) & hits
        assert int(won.sum()) == 1 and not bool(lost.any())


@pytest.mark.parametrize("level", [True, False])
def test_sweep_on_rows_equals_sweep_on_the_plain_table(level):
    """K1's plain sweep on the table step's rows (``fusion_sweep_merge``'s
    CPU path) gives the planes of the JAX twin's sweep on its own table,
    merged into a fresh window."""
    sc = scene("level" if level else "6.0-vfov90-rolled", "cpu")
    args, kw = table_args(sc)
    beams, rowmax, cx, cy, cz = fusion_table(*args, **kw)
    a = create_state(sc["size"], TAU, 0, force_odd=False)
    fusion_sweep_merge(a.value, a.weight, cx, cy, cz, beams, rowmax,
                       sc["rotation"], level=level, max_weight=MAX_WEIGHT,
                       **sc["kw"])
    tw = _jax_twin(sc)
    new_v, new_w = jtp.projective_sweep_coords(
        *tw["g"], tw["rng_tab"], tw["endpoint"], tw["smm"], tw["rot"],
        **sc["kw"])
    v, w = jtp._merge_planes(jnp.full(new_v.shape, TAU, jnp.int32),
                             jnp.zeros(new_w.shape, jnp.int32), new_v,
                             new_w, MAX_WEIGHT)
    np.testing.assert_array_equal(a.value.numpy(), np.asarray(v))
    np.testing.assert_array_equal(a.weight.numpy(), np.asarray(w))
    assert int((a.weight != 0).sum()) > 1000


def test_update_takes_the_scanner_voxel_as_host_ints():
    """``tsdf_update_projective`` takes the scanner's voxel as a tensor or
    as host ints (what the app hands it), with the same planes."""
    sc = scene("ring-offset", "cpu")
    out = []
    for voxel in (torch.tensor(sc["scanner"], dtype=torch.int32),
                  np.asarray(sc["scanner"], np.int32)):
        st = create_state(sc["size"], TAU, 0, force_odd=False)._replace(
            pos=sc["pos"], offset=sc["offset"])
        ttp.tsdf_update_projective(
            st, sc["points"], sc["mask"], voxel, sc["rotation"],
            size=sc["size"], max_weight=MAX_WEIGHT, level=True, **sc["kw"])
        out.append(st)
    assert torch.equal(out[0].value, out[1].value)
    assert torch.equal(out[0].weight, out[1].weight)
    assert int((out[0].weight != 0).sum()) > 1000
