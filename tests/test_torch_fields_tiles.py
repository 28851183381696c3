"""The plain model of kernel K2's addressing
(``kernels/fields.plan_neighbors``) against ``torch.roll``: every voxel is
written exactly once, and each of its six neighbour reads is the voxel
``torch.roll`` of an index tensor puts there.  Small shapes cover the degenerate extents (1 and 2, where x-1 ==
x+1), Y*Z a multiple of 8 and Y*Z above one tile; the full 625 x 625 x 235
window and the default 625 x 625 x 391 are checked on a few planes (index
only).  The packed fields gathered through the model's reads equal the JAX
package's on the same numpy inputs."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.map.local_map import LocalMapState as JState
from warpsense_tpu.ops import registration as jreg
from warpsense_tpu_torch.kernels import fields as kf
from warpsense_tpu_torch.ops import registration as treg

SRC = Path(kf.__file__).resolve().parent.parent / "csrc" / "fields.cu"
SMALL = [(1, 5, 7), (2, 3, 1), (5, 7, 3), (9, 16, 32), (3, 40, 391),
         (37, 29, 23), (1, 1, 1), (40, 3, 2)]
FULL, DEFAULT = (625, 625, 235), (625, 625, 391)


def _rolled(shape):
    """(X*Y*Z, 6) flat indices of the x+1, x-1, y+1, y-1, z+1, z-1
    neighbours: torch.roll of an arange index tensor."""
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    return torch.stack([torch.roll(idx, s, ax).reshape(-1)
                        for ax in range(3) for s in (-1, 1)], dim=-1)


def test_model_walks_the_kernels_plan():
    text = SRC.read_text()
    consts = {m[0]: int(m[1]) for m in
              re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert (consts["kTile"], consts["kThreads"], consts["kRun"],
            consts["kSlots"]) == (kf.TILE, kf.THREADS, kf.RUN, kf.SLOTS)
    assert "(kTile + 2 * Z + 14 + 7) / 8 * 8" in text   # smem_bytes's span


@pytest.mark.parametrize("shape", SMALL)
def test_every_voxel_once_with_rolled_neighbors(shape):
    plan = kf.plan_neighbors(shape)
    n = int(np.prod(shape))
    assert sorted(plan.planes) == list(range(shape[0]))
    assert torch.equal(torch.bincount(plan.index, minlength=n),
                       torch.ones(n, dtype=torch.int64))
    assert torch.equal(plan.neighbors, _rolled(shape)[plan.index])


@pytest.mark.parametrize("shape", [FULL, DEFAULT])
def test_full_windows_on_some_planes(shape):
    """Planes at the ends of runs and of the window; y and z rolls on one
    plane's (Y, Z) index, x rolls on the plane index."""
    X, Y, Z = shape
    P = Y * Z
    planes = [0, 1, kf.RUN - 1, kf.RUN, X // 2, X - 2, X - 1]
    plan = kf.plan_neighbors(shape, planes)
    assert sorted(plan.planes) == list(range(X))
    x, q = plan.index // P, plan.index % P
    for p in planes:
        assert torch.equal(torch.sort(q[x == p]).values, torch.arange(P))
    assert len(plan.index) == len(planes) * P
    xs = torch.arange(X)
    pq = torch.arange(P).reshape(Y, Z)
    want = torch.stack([
        torch.roll(xs, -1)[x] * P + q, torch.roll(xs, 1)[x] * P + q,
        x * P + torch.roll(pq, -1, 0).reshape(-1)[q],
        x * P + torch.roll(pq, 1, 0).reshape(-1)[q],
        x * P + torch.roll(pq, -1, 1).reshape(-1)[q],
        x * P + torch.roll(pq, 1, 1).reshape(-1)[q]], dim=-1)
    assert torch.equal(plan.neighbors, want)


def test_default_window_fits_shared_memory():
    assert kf.smem_bytes(DEFAULT[2]) <= kf.MAX_SMEM_BYTES
    assert kf.smem_bytes(100_000) > kf.MAX_SMEM_BYTES


@pytest.mark.parametrize("shape", [(5, 7, 3), (9, 16, 32)])
def test_fields_through_the_model_match_jax(shape):
    """Packed fields computed from the model's neighbour reads equal the
    JAX package's roll formulation on the same numpy window."""
    tau = 600
    rng = np.random.default_rng(sum(shape))
    v = rng.integers(-32768, 32768, shape, dtype=np.int16)
    w = (rng.random(shape) < 0.7).astype(np.int16) * rng.integers(
        1, 64, shape).astype(np.int16)
    plan = kf.plan_neighbors(shape)
    vf = torch.from_numpy(v).reshape(-1).to(torch.int32)
    wf = torch.from_numpy(w).reshape(-1).to(torch.int32)
    nb = plan.neighbors
    neighbors = [(vf[nb[:, 2 * a]], vf[nb[:, 2 * a + 1]],
                  wf[nb[:, 2 * a]], wf[nb[:, 2 * a + 1]]) for a in range(3)]
    got = torch.empty(vf.shape, dtype=torch.int32)
    got[plan.index] = treg.packed_plane_from_neighbors(
        vf[plan.index], wf[plan.index], neighbors, tau=tau)
    j = JState(value=jnp.asarray(v), weight=jnp.asarray(w),
               pos=jnp.zeros(3, jnp.int32), offset=jnp.zeros(3, jnp.int32))
    want = np.asarray(jreg.precompute_fields_packed(j, tau=tau).plane)
    np.testing.assert_array_equal(got.reshape(shape).numpy(), want)
