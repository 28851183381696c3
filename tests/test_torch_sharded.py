"""Port vs JAX: the multi-GPU layer (``parallel/sharded.py``,
``parallel/distributed.py``) at worlds of 2 and 4 gloo CPU ranks.

The ranks run in their own processes (tests/_torch_dist_worker.py, which
imports no JAX); this process runs JAX's sharded functions on conftest's
8-device CPU mesh and the port's single-window functions, at
tests/test_sharded.py's and test_sharded_fast.py's SIZE = (80, 41, 41).

Held to the bit: the gathered windows of the ray-march, level and tilted
projective fusions (against the port's single-window functions and JAX's
sharded ones; every coordinate here is below 2^12 mm, so XLA's contracted
multiply-adds are exact), the packed and exact fields, and the demo's
window.  Registration poses: within 0.5 mm and 1e-4 rad of JAX's sharded
and of the port's single-window poses (the tolerance of the port's other
registration tests; the statistics are summed in another order), and
equal on every rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as w
from warpsense_tpu.core.consts import MATRIX_RESOLUTION
from warpsense_tpu.map.local_map import create_state as jcreate_state
from warpsense_tpu.ops.tsdf import plan_raymarch as jplan
from warpsense_tpu.parallel import sharded as jsh
from warpsense_tpu_torch.map.local_map import create_state
from warpsense_tpu_torch.ops import registration as treg
from warpsense_tpu_torch.ops.tsdf import plan_raymarch, tsdf_update
from warpsense_tpu_torch.ops.tsdf_projective import tsdf_update_projective

def _jfresh(mesh):
    return jsh.shard_state(jcreate_state(w.SIZE, w.TAU, 0, xp=jnp,
                                         force_odd=False), mesh)


def _tfresh():
    return create_state(w.SIZE, w.TAU, 0, force_odd=False)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's sharded results on the 8-device mesh."""
    mesh = jsh.make_mesh(8)
    out = {}
    ms, mi = jplan(w.TAU, w.RES, 4000)
    pts = jnp.asarray(w.raymarch_cloud())
    mask = jnp.ones((pts.shape[0],), bool)
    zero = jnp.zeros(3, jnp.int32)
    ray = jsh.tsdf_update_sharded(
        _jfresh(mesh), pts, mask, zero,
        jnp.asarray([0, 0, MATRIX_RESOLUTION], jnp.int32), mesh=mesh,
        size=w.SIZE, tau=w.TAU, max_weight=w.PROJ_KW["max_weight"],
        resolution=w.RES, max_steps=ms, max_isteps=mi)
    out["ray"] = ray
    out["parity_pose"] = np.asarray(jsh.register_cloud_sharded(
        ray, pts, mask, jnp.asarray(w.PERT), mesh=mesh, **w.PARITY_REG_KW))

    pts = jnp.asarray(w.flat_room_cloud())
    mask = jnp.ones((pts.shape[0],), bool)
    eye = jnp.eye(3, dtype=jnp.float32)
    level = jsh.tsdf_update_projective_sharded(
        _jfresh(mesh), pts, mask, zero, eye, mesh=mesh, level=True,
        kernel="xla", **w.PROJ_KW)
    out["level"] = jax.tree.map(np.asarray, level)
    f = jsh.precompute_fields_packed_sharded(level, mesh=mesh, tau=w.TAU)
    out["packed"] = np.asarray(f.plane)
    f2 = jsh.precompute_fields_packed_sharded(level, mesh=mesh, tau=w.TAU,
                                              exact=True)
    out["exact_a"], out["exact_b"] = (np.asarray(f2.plane_a),
                                      np.asarray(f2.plane_b))
    out["packed_pose"] = np.asarray(jsh.register_cloud_packed_sharded(
        f, level.pos, level.offset, pts, mask, jnp.asarray(w.PERT),
        mesh=mesh, **w.PACKED_REG_KW)[0])
    out["freeze_pose"] = np.asarray(jsh.register_cloud_packed_sharded(
        f, level.pos, level.offset, pts, mask, jnp.asarray(w.PERT_FREEZE),
        mesh=mesh, gather_freeze=True, **w.PACKED_REG_KW)[0])
    level2 = jsh.tsdf_update_projective_sharded(
        level, pts, mask, zero + 2, eye, mesh=mesh, level=True,
        kernel="xla", **w.PROJ_KW)
    out["level2"] = level2
    out["tilt"] = jsh.tsdf_update_projective_sharded(
        _jfresh(mesh), pts, mask, zero, jnp.asarray(w.tilt(4.0)),
        mesh=mesh, **w.PROJ_KW)
    # the demo step of parallel/distributed.py (its JAX twin runs the XLA
    # sweep at R = I, the port K1's level sweep: the same bits)
    demo_pts = jnp.asarray(_demo_cloud())
    demo_mask = jnp.ones((demo_pts.shape[0],), bool)
    demo = jsh.tsdf_update_projective_sharded(
        _jfresh(mesh), demo_pts, demo_mask, zero, eye, mesh=mesh,
        **w.PROJ_KW)
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = [90, -60, 40]
    out["demo_pose"] = np.asarray(jsh.register_cloud_packed_sharded(
        jsh.precompute_fields_packed_sharded(demo, mesh=mesh, tau=w.TAU),
        demo.pos, demo.offset, demo_pts, demo_mask, jnp.asarray(pert),
        mesh=mesh, size=w.SIZE, resolution=w.RES, tau=w.TAU,
        max_iterations=30, epsilon=0.03, gather_freeze=True)[0])
    out["demo"] = demo
    return {k: (jax.tree.map(np.asarray, v) if not isinstance(v, np.ndarray)
                else v) for k, v in out.items()}


def _demo_cloud():
    from warpsense_tpu_torch.parallel.distributed import _demo_cloud as dc
    return dc(3000, half=1100, zhalf=350)


@pytest.fixture(scope="module")
def port_single():
    """The port's single-window functions on the same inputs."""
    out = {}
    ms, mi = plan_raymarch(w.TAU, w.RES, 4000)
    pts = torch.as_tensor(w.raymarch_cloud())
    mask = torch.ones(len(pts), dtype=torch.bool)
    zero = torch.zeros(3, dtype=torch.int32)
    ray = tsdf_update(_tfresh(), pts, mask, zero,
                      torch.tensor([0, 0, MATRIX_RESOLUTION],
                                   dtype=torch.int32),
                      size=w.SIZE, tau=w.TAU,
                      max_weight=w.PROJ_KW["max_weight"], resolution=w.RES,
                      max_steps=ms, max_isteps=mi)
    out["ray"] = ray
    out["parity_pose"] = treg.register_cloud(
        ray, pts, mask, torch.as_tensor(w.PERT), **w.PARITY_REG_KW).numpy()
    pts = torch.as_tensor(w.flat_room_cloud())
    mask = torch.ones(len(pts), dtype=torch.bool)
    eye = torch.eye(3, dtype=torch.float32)
    level = tsdf_update_projective(_tfresh(), pts, mask, zero, eye,
                                   level=True, **w.PROJ_KW)
    f = treg.precompute_fields_packed(level, tau=w.TAU)
    f2 = treg.precompute_fields_packed2(level)
    out["packed"], out["exact_a"], out["exact_b"] = (
        f.plane.numpy(), f2.plane_a.numpy(), f2.plane_b.numpy())
    out["level"] = [t.clone() for t in level]
    out["packed_pose"] = treg.register_cloud_packed(
        f, level.pos, level.offset, pts, mask, torch.as_tensor(w.PERT),
        it_weight_gradient=0.1, **w.PACKED_REG_KW)[0].numpy()
    out["freeze_pose"] = treg.register_cloud_packed(
        f, level.pos, level.offset, pts, mask,
        torch.as_tensor(w.PERT_FREEZE), it_weight_gradient=0.1,
        gather_freeze=True, **w.PACKED_REG_KW)[0].numpy()
    tsdf_update_projective(level, pts, mask, zero + 2, eye, level=True,
                           **w.PROJ_KW)
    out["level2"] = level
    out["tilt"] = tsdf_update_projective(
        _tfresh(), pts, mask, zero, torch.as_tensor(w.tilt(4.0)),
        **w.PROJ_KW)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    w.env_one_thread(mp)
    try:
        outs = w.launch("ops", request.param,
                        tmp_path_factory.mktemp(f"w{request.param}"))
    finally:
        mp.undo()
    return outs


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_every_rank_holds_the_same_results(ranks):
    for k, v in ranks[0].items():
        if k == "demo_slab":
            continue
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[k], v, err_msg=k)
    X = w.SIZE[0]
    n = len(ranks)
    assert [r["demo_slab"].tolist() for r in ranks] == [
        [i * X // n, (i + 1) * X // n] for i in range(n)]


@pytest.mark.parametrize("name", ["ray", "level", "level2", "tilt"])
def test_sharded_fusion_bit_exact(ranks, port_single, jax_ref, name):
    got_v, got_w = ranks[0][f"{name}_value"], ranks[0][f"{name}_weight"]
    single = port_single[name]
    np.testing.assert_array_equal(got_v, _np(single[0]))
    np.testing.assert_array_equal(got_w, _np(single[1]))
    np.testing.assert_array_equal(got_v, jax_ref[name][0])
    np.testing.assert_array_equal(got_w, jax_ref[name][1])
    assert int(np.count_nonzero(got_w)) > 5000


@pytest.mark.parametrize("name", ["packed", "exact_a", "exact_b"])
def test_sharded_fields_bit_exact(ranks, port_single, jax_ref, name):
    np.testing.assert_array_equal(ranks[0][name], port_single[name])
    np.testing.assert_array_equal(ranks[0][name], jax_ref[name])


@pytest.mark.parametrize("name", ["parity_pose", "packed_pose",
                                  "freeze_pose"])
def test_sharded_registration_pose(ranks, port_single, jax_ref, name):
    got = ranks[0][name]
    w.assert_pose_close(got, jax_ref[name])
    w.assert_pose_close(got, port_single[name])
    # it corrected most of the (90, -60, 40) / (70, -50, 30) mm offset
    assert np.linalg.norm(got[:3, 3]) < 80


def test_demo_window_and_pose(ranks, jax_ref):
    np.testing.assert_array_equal(ranks[0]["demo_value"],
                                  jax_ref["demo"][0])
    np.testing.assert_array_equal(ranks[0]["demo_weight"],
                                  jax_ref["demo"][1])
    w.assert_pose_close(ranks[0]["demo_pose"], jax_ref["demo_pose"])
