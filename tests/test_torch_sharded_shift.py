"""Port vs JAX: the window shift of the multi-GPU layer — the staged
shift (``begin_shift`` / ``shift_io`` / ``finish_shift``) and the
``x_rows``-scoped slab IO of ``LocalMap.attach_device``, mirroring
tests/test_sharded_shift.py.

All bit for bit: windows, pos/offset and the persisted maps.  The scoped
shifts run both on a whole-window state (the JAX test's layout) and on
each rank's slab (``parallel.sharded.shard_state``, the port's layout), and
``eval/merge_maps`` folds the halves into the unscoped map exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.map.global_map import GlobalMap as JGlobalMap
from warpsense_tpu.map.local_map import LocalMap as JLocalMap
from warpsense_tpu.ops.tsdf_projective import \
    tsdf_update_projective as jfuse
from warpsense_tpu_torch.core.consts import WEIGHT_RESOLUTION
from warpsense_tpu_torch.eval.merge_maps import merge
from warpsense_tpu_torch.map.global_map import GlobalMap
from warpsense_tpu_torch.map.local_map import LocalMap
from warpsense_tpu_torch.ops.tsdf_projective import tsdf_update_projective
from warpsense_tpu_torch.parallel.sharded import Mesh, shard_state

TAU, RES = 600, 64
SIZE = (80, 41, 41)
NEW_POS = [13, -7, 4]
AREA = (np.asarray([-45, -25, -25]), np.asarray([45, 25, 25]))
KW = dict(tau=TAU, max_weight=32 * WEIGHT_RESOLUTION, resolution=RES,
          channels=32, columns=128, vfov_deg=45.0)


def _cloud():
    rng = np.random.default_rng(11)
    pts = []
    for ax in range(3):
        for s in (-1, 1):
            p = np.stack([rng.uniform(-1100, 1100, 500),
                          rng.uniform(-1100, 1100, 500),
                          rng.uniform(-350, 350, 500)], axis=1)
            p[:, ax] = s * (350 if ax == 2 else 1100)
            pts.append(p)
    return np.round(np.concatenate(pts)).astype(np.int32)


def _fused(path):
    """(LocalMap, GlobalMap, fused whole-window state) of the port."""
    gm = GlobalMap(path, TAU, 0)
    lm = LocalMap(SIZE, gm, force_odd=False)
    pts = torch.as_tensor(_cloud())
    state = tsdf_update_projective(
        lm.device_state("cpu"), pts, torch.ones(len(pts), dtype=torch.bool),
        torch.zeros(3, dtype=torch.int32), torch.eye(3), size=lm.size,
        level=True, **KW)
    return lm, gm, state


def _files_equal(a, b):
    import h5py
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert set(fa["map"]) == set(fb["map"])
        for k in fa["map"]:
            np.testing.assert_array_equal(fa["map"][k][...],
                                          fb["map"][k][...])


def _read(path):
    gm = GlobalMap(path, TAU, 0, truncate=False)
    try:
        return gm.read_area(*AREA)
    finally:
        gm.close()


def test_plain_shift_matches_jax(tmp_path):
    lm, gm, st = _fused(tmp_path / "t.h5")
    lm.attach_device(st)
    lm.shift(NEW_POS)
    out = lm.detach_device()
    jgm = JGlobalMap(tmp_path / "j.h5", TAU, 0)
    jlm = JLocalMap(SIZE, jgm, force_odd=False)
    pts = jnp.asarray(_cloud())
    jst = jfuse(jlm.device_state(), pts, jnp.ones((len(pts),), bool),
                jnp.zeros(3, jnp.int32), jnp.eye(3, dtype=jnp.float32),
                size=jlm.size, **KW)
    jlm.attach_device(jst)
    jlm.shift(NEW_POS)
    jout = jlm.detach_device()
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lm.absorb(out)
    jlm.absorb(jout)
    lm.write_back()
    jlm.write_back()
    gm.close()
    jgm.close()
    _files_equal(tmp_path / "t.h5", tmp_path / "j.h5")


def test_staged_shift_matches_plain_shift(tmp_path):
    lm_a, gm_a, st_a = _fused(tmp_path / "plain.h5")
    lm_a.attach_device(st_a)
    lm_a.shift(NEW_POS)
    st_a = lm_a.detach_device()

    lm_b, gm_b, st_b = _fused(tmp_path / "staged.h5")
    lm_b.attach_device(st_b)
    plan = lm_b.begin_shift(NEW_POS)
    lm_b.shift_io(plan)          # the worker's phase: global-map IO only
    st_b = lm_b.finish_shift(plan)
    for a, b in zip(st_a, st_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    lm_a.absorb(st_a)
    lm_b.absorb(st_b)
    lm_a.write_back()
    lm_b.write_back()
    gm_a.close()
    gm_b.close()
    _files_equal(tmp_path / "plain.h5", tmp_path / "staged.h5")


def test_staged_shift_beyond_the_window(tmp_path):
    """A move past the window's extent evicts all of it and loads the new
    window, like the hop-walked plain shift."""
    far = [200, -90, 60]
    lm_a, gm_a, st_a = _fused(tmp_path / "a.h5")
    lm_a.attach_device(st_a)
    lm_a.shift(far)
    st_a = lm_a.detach_device()
    lm_b, gm_b, st_b = _fused(tmp_path / "b.h5")
    lm_b.attach_device(st_b)
    plan = lm_b.begin_shift(far)
    lm_b.shift_io(plan)
    st_b = lm_b.finish_shift(plan)
    for a, b in zip(st_a, st_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    gm_a.close()
    gm_b.close()


@pytest.mark.parametrize("layout", ["whole", "slab"])
def test_scoped_shift_union_matches_unscoped(tmp_path, layout):
    """Two half-window scopes shifting against separate files persist,
    merged, exactly what the unscoped shift persists (ring wrap
    included).  ``slab``: each scope attaches only its rows."""
    lm, gm, st = _fused(tmp_path / "uns.h5")
    lm.attach_device(st)
    lm.shift(NEW_POS)
    out = lm.detach_device()
    lm.attach_device(out)
    lm.write_back()
    lm.detach_device()
    gm.close()

    files = []
    for rank, rows in enumerate(((0, 40), (40, 80))):
        path = tmp_path / f"h{rank}.h5"
        lm, gm, st = _fused(path)
        if layout == "slab":
            st = shard_state(st, Mesh(None, rank, 2, torch.device("cpu")))
            assert st.value.shape[0] == 40
        lm.attach_device(st, x_rows=rows)
        lm.shift(NEW_POS)
        out = lm.detach_device()
        lm.attach_device(out, x_rows=rows)
        lm.write_back()
        lm.detach_device()
        gm.close()
        files.append(path)

    h0, h1 = _read(files[0]), _read(files[1])
    assert not np.any(((h0 >> 16) != 0) & ((h1 >> 16) != 0))
    merge(files, tmp_path / "merged.h5")
    ref = _read(tmp_path / "uns.h5")
    np.testing.assert_array_equal(_read(tmp_path / "merged.h5"), ref)
    assert int(((ref >> 16) != 0).sum()) > 5000


def test_scoped_attach_checks_its_rows(tmp_path):
    lm, gm, st = _fused(tmp_path / "c.h5")
    thirty = st._replace(value=st.value[:30], weight=st.weight[:30])
    with pytest.raises(ValueError, match="x_rows"):
        lm.attach_device(thirty, x_rows=(0, 20))  # neither 20 nor 80 rows
    half = shard_state(st, Mesh(None, 0, 2, torch.device("cpu")))
    with pytest.raises(ValueError, match="pass x_rows"):
        lm.attach_device(half)
    lm.attach_device(half, x_rows=(0, 40))
    with pytest.raises(RuntimeError, match="x-row scope"):
        lm.begin_shift(NEW_POS)
    gm.close()


def test_box_diff_partitions_like_jax():
    """A \\ B boxes are disjoint, cover the difference exactly, and are
    JAX's boxes."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        a_s = rng.integers(-10, 5, 3)
        a_e = a_s + rng.integers(0, 9, 3)
        b_s = rng.integers(-10, 5, 3)
        b_e = b_s + rng.integers(0, 9, 3)
        boxes = LocalMap._box_diff(a_s, a_e, b_s, b_e)
        jboxes = JLocalMap._box_diff(a_s, a_e, b_s, b_e)
        assert len(boxes) == len(jboxes)
        for (s, e), (js, je) in zip(boxes, jboxes):
            np.testing.assert_array_equal(s, js)
            np.testing.assert_array_equal(e, je)
        grid = np.zeros((30, 30, 30), int)

        def mark(g, s, e, v):
            g[s[0] + 12:e[0] + 13, s[1] + 12:e[1] + 13,
              s[2] + 12:e[2] + 13] += v

        expect = np.zeros_like(grid)
        mark(expect, a_s, a_e, 1)
        inter = np.zeros_like(grid)
        mark(inter, b_s, b_e, 1)
        expect = (expect == 1) & (inter == 0)
        for s, e in boxes:
            mark(grid, s, e, 1)
        assert np.array_equal(grid.astype(bool), expect)
        assert grid.max() <= 1, "boxes overlap"
