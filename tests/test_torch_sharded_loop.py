"""Port vs JAX: the sharded registration loops
(``parallel/sharded.run_registration_sharded``), which run the JAX
package's ``shard_map`` + ``while_loop`` registrations
(``warpsense_tpu/parallel/sharded.py`` ``register_cloud_sharded`` and
``register_cloud_packed_sharded``) as K3 on each rank's slab, the ranks'
rows all-gathered, and K4 on every rank on the same rows.  On the CPU the
halves are their plain versions (``reg_stats_plain`` on the slab, one row
a rank; ``reg_step_plain``).

The scenes are tests/_torch_dist_worker.py's at SIZE = (80, 41, 41): the
flat room fused on the level grid (the LM over packed fields, without and
with the gather freeze, and over exact fields) and the box room
ray-marched (the GN in its parity and fast modes).  Worlds of 2 and 4 are
spawned gloo CPU ranks (a world of 1 too, through a group of one); a
world of 1 without a group runs in this process.  Tolerances:

* a world of one is ``run_registration`` on the whole window to the bit
  (the same row, the same step);
* the slabs' rows, summed in the step's order (``sum_partials``), are the
  whole window's statistics within 1e-5 relative (H, g, e against their
  largest entry; float32 sums of the points in two groupings), c exactly;
* every rank ends on the same carry and traces the same steps, bit for
  bit, each step the plain step's replay; the chunk size (1, 3, 8)
  changes no bit;
* the loop's fused order (one iteration: the step on the rows gathered
  last, then the next statistics on the same carry, double-buffered:
  ``fused_iteration_plain``, the plain version of ``shard_iter_kernel``)
  is the two-phase order (statistics, gather, step:
  ``_torch_dist_worker.two_phase_loop``) to the bit: end state,
  iterations and trace, at every world and chunk size;
* against JAX's sharded functions on conftest's 8-device CPU mesh: poses
  within 0.5 mm and 1e-4 rad (the port's registration tolerance; the
  statistics are summed in another order), the LM's iterations equal.
  The parity GN's iteration count is not held against JAX here: its
  4-error window closes where float-order noise puts it
  (tests/test_torch_regloop.py holds it where it is stable).  The
  fast-mode GN is held against JAX's sharded one at FAST_GN_ITERATIONS
  (5) iterations, not at 60: on this scene its rotation never settles,
  and from the 8th iteration on JAX's own single-window and sharded fast
  GN part by more than the tolerance (by 0.01-0.03 rad from 10 to 60
  iterations; ``test_jax_fast_gn_parts_with_itself`` holds the ends).

PyTorch's CPU reductions split a sum by the thread count, so the loops
compared bit for bit with the one-thread ranks run on one thread here too
(``one_thread``).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as w
from warpsense_tpu.map.local_map import LocalMapState as JState
from warpsense_tpu.parallel import sharded as jsh
from warpsense_tpu_torch.ops import registration as treg
from warpsense_tpu_torch.parallel import sharded as sh

LM_NAMES = ("packed", "packed_freeze", "exact")


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    return w.loop_scenes()


@pytest.fixture(scope="module")
def problems(scenes):
    """The whole window's problems."""
    return w.loop_problems(scenes)


@pytest.fixture(scope="module")
def whole(problems):
    """``run_registration`` on the whole window (the plain loop), traced
    with one row of statistics an iteration."""
    out = {}
    for name, (prob, pose) in problems.items():
        trace = torch.zeros((prob.max_iterations, treg.trace_width(1)))
        state = treg.init_state(prob, pose, "cpu")
        with one_thread():
            treg.loop_plain(state, prob, lambda st, cache: (
                treg.reg_stats_plain(st, prob, cache)), trace=trace)
        out[name] = (state, trace)
    return out


@pytest.fixture(scope="module")
def jax_ref(scenes):
    """JAX's sharded registrations on the 8-device mesh, from the port's
    windows (the fusions are bit-exact with JAX's:
    tests/test_torch_sharded.py)."""
    (level, pts, mask), (ray, rpts, rmask) = scenes
    mesh = jsh.make_mesh(8)

    def jstate(st):
        return jsh.shard_state(JState(*(np.asarray(t) for t in st)), mesh)

    jlevel = jstate(level)
    jpts, jmask = jnp.asarray(pts.numpy()), jnp.asarray(mask.numpy())
    out = {}
    for name, exact, freeze, pose in (("packed", False, False, w.PERT),
                                      ("packed_freeze", False, True,
                                       w.PERT_FREEZE),
                                      ("exact", True, False, w.PERT)):
        f = jsh.precompute_fields_packed_sharded(jlevel, mesh=mesh, tau=w.TAU,
                                                 exact=exact)
        pose_, iters, _ = jsh.register_cloud_packed_sharded(
            f, jlevel.pos, jlevel.offset, jpts, jmask, jnp.asarray(pose),
            mesh=mesh, gather_freeze=freeze, **w.PACKED_REG_KW)
        out[name] = (np.asarray(pose_), int(iters))
    jray, jrpts, jrmask = (jstate(ray), jnp.asarray(rpts.numpy()),
                           jnp.asarray(rmask.numpy()))
    out["gn_parity"] = (np.asarray(jsh.register_cloud_sharded(
        jray, jrpts, jrmask, jnp.asarray(w.PERT), mesh=mesh,
        **w.PARITY_REG_KW)), None)
    out["gn_fast_early"] = (np.asarray(jsh.register_cloud_sharded(
        jray, jrpts, jrmask, jnp.asarray(w.PERT), mesh=mesh, mode="fast",
        **dict(w.PARITY_REG_KW, max_iterations=w.FAST_GN_ITERATIONS))),
        None)
    return out


@pytest.fixture(scope="module", params=[1, 2, 4],
                ids=["world1", "world2", "world4"])
def ranks(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    w.env_one_thread(mp)
    try:
        outs = w.launch("loop", request.param,
                        tmp_path_factory.mktemp(f"loop{request.param}"))
    finally:
        mp.undo()
    return outs


def _pose(prob, state):
    at = treg.S_ACC if prob.lm else treg.S_TRIAL
    return np.asarray(state[at:at + 16]).reshape(4, 4)


@pytest.mark.parametrize("name", w.LOOP_NAMES)
def test_world1_is_the_whole_window_loop(problems, whole, name):
    """Without a group the sharded loop is ``run_registration``: the same
    end state, header and traced steps, bit for bit."""
    prob, pose = problems[name]
    want, wtrace = whole[name]
    trace = torch.zeros_like(wtrace)
    calls = treg.run_registration.calls
    with one_thread():
        got, head = sh.run_registration_sharded(
            prob, pose, sh.make_mesh("cpu"), trace=trace)
        state, rhead = treg.run_registration(prob, pose)
    assert treg.run_registration.calls == calls + 2
    assert torch.equal(got, want) and head == want[:treg.S_HEAD].tolist()
    assert torch.equal(trace, wtrace)
    assert torch.equal(state, got) and rhead == head
    assert 2 < head[treg.S_I] <= prob.max_iterations


def test_the_loop_kernel_takes_the_whole_window_only(problems, scenes):
    """A rank's slab runs through the sharded loop; the one-launch loop
    (``reg_loop``, whose kernel does not test ownership) refuses it."""
    from warpsense_tpu_torch.kernels.registration import reg_loop
    prob, pose = w.loop_problems(scenes, (0, w.SIZE[0] // 2))["packed"]
    with pytest.raises(ValueError, match="whole window"):
        reg_loop(treg.init_state(prob, pose, "cpu"), prob)


@pytest.mark.parametrize("name", w.LOOP_NAMES)
@pytest.mark.parametrize("world", [2, 4])
def test_slab_rows_sum_to_the_window(problems, scenes, whole, name, world):
    """At every carry of the whole window's loop, each slab's plain row
    (``reg_stats_plain`` on the rows it owns, its own gather-freeze cache),
    summed over the slabs in the step's order, is the whole window's
    statistics: c exactly, H, g and e within 1e-5."""
    prob, _ = problems[name]
    state, trace = whole[name]
    X = w.SIZE[0]
    slabs = [w.loop_problems(scenes, (r * X // world, (r + 1) * X // world))
             [name][0] for r in range(world)]
    caches = [{} for _ in slabs]
    cache: dict = {}
    n = int(state[treg.S_I])
    for i in range(n):
        carry = trace[i, :treg.STATE_LEN].clone()
        want = treg.reg_stats_plain(carry, prob, cache)[0]
        rows = torch.cat([treg.reg_stats_plain(carry, sp, c)
                          for sp, c in zip(slabs, caches)])
        got = treg.sum_partials(rows)
        assert got[28] == want[28] and want[28] > 100, (i, got[28], want[28])
        for lo, hi in ((0, 21), (21, 27), (27, 28)):
            d = float((got[lo:hi].double() - want[lo:hi].double()).abs().max())
            assert d <= 1e-5 * float(want[lo:hi].abs().max()), (i, lo, d)


def test_sharded_rows_sum_is_k4s_lane_order():
    """The step sums a world's gathered rows (world x 16 on the card, one a
    rank on the CPU) in ``sum_partials``' lane order over all of them,
    rank-major; at up to 8 rows (one a lane) that is the rank-order sum."""
    rng = np.random.default_rng(4)
    for world, k in ((2, 16), (4, 16), (8, 1), (3, 1)):
        p = torch.from_numpy(rng.normal(size=(world * k, treg.PARTIALS))
                             .astype(np.float32) * 1e4)
        want = torch.zeros(treg.PARTIALS)
        for lane in range(treg.STEP_LANES):
            t = torch.zeros(treg.PARTIALS)
            for r in range(lane, world * k, treg.STEP_LANES):
                t = t + p[r]
            want = want + t
        assert torch.equal(treg.sum_partials(p), want)
        if k == 1:
            acc = p[0]
            for row in p[1:]:
                acc = acc + row
            assert torch.equal(treg.sum_partials(p), acc)


@pytest.mark.parametrize("chunk", w.LOOP_CHUNKS)
def test_chunk_size_changes_no_bit(problems, whole, chunk):
    """The header read every ``chunk`` iterations changes no bit."""
    for name in ("packed_freeze", "gn_fast"):
        prob, pose = problems[name]
        with one_thread():
            got, _ = sh.run_registration_sharded(
                prob, pose, sh.make_mesh("cpu"), chunk=chunk)
        assert torch.equal(got, whole[name][0])


def test_every_rank_ends_on_the_same_carry(ranks):
    """Every rank's end states, headers, traces, poses and iterations are
    rank 0's, bit for bit."""
    for k, v in ranks[0].items():
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[k], v, err_msg=k)


@pytest.mark.parametrize("name", w.LOOP_NAMES)
def test_chunks_and_replay_on_a_mesh(ranks, problems, whole, name):
    """On every world: the chunk sizes give the same bits; every traced
    step is the plain step's replay on the gathered rows; at a world of
    one (a gloo group of one) the whole window's loop to the bit."""
    prob, _ = problems[name]
    r0 = ranks[0]
    state = r0[f"{name}_state_{w.LOOP_CHUNKS[0]}"]
    trace = r0[f"{name}_trace_{w.LOOP_CHUNKS[0]}"]
    for chunk in w.LOOP_CHUNKS[1:]:
        np.testing.assert_array_equal(r0[f"{name}_state_{chunk}"], state)
        np.testing.assert_array_equal(r0[f"{name}_trace_{chunk}"], trace)
        np.testing.assert_array_equal(r0[f"{name}_head_{chunk}"],
                                      r0[f"{name}_head_{w.LOOP_CHUNKS[0]}"])
    _, differ, tests, err = treg.replay_trace(torch.from_numpy(trace),
                                              torch.from_numpy(state), prob)
    assert differ == [] and err == 0.0 and len(tests) > 2
    if len(ranks) == 1:
        assert torch.equal(torch.from_numpy(state), whole[name][0])
        assert torch.equal(torch.from_numpy(trace), whole[name][1])


@pytest.mark.parametrize("name", LM_NAMES + ("gn_parity",))
def test_sharded_loops_match_jax(ranks, problems, whole, jax_ref, name):
    """The public entry points from the ranks' sharded maps and the direct
    loop: poses within 0.5 mm / 1e-4 rad of JAX's sharded ones and of
    the whole window's; the LM's iterations JAX's."""
    prob, _ = problems[name]
    r0 = ranks[0]
    jpose, jiters = jax_ref[name]
    got = r0[f"{name}_pose"]
    w.assert_pose_close(got, jpose)
    w.assert_pose_close(got, _pose(prob, whole[name][0]))
    w.assert_pose_close(_pose(prob, r0[f"{name}_state_8"]), got)
    if name in LM_NAMES:
        assert int(r0[f"{name}_iters"]) == jiters
        assert int(r0[f"{name}_head_8"][treg.S_I]) == jiters
    # it corrected most of the (90, -60, 40) / (70, -50, 30) mm offset
    assert np.linalg.norm(got[:3, 3]) < 80


def test_sharded_fast_gn_matches_jax(ranks, jax_ref):
    """The fast-mode GN (``register_cloud_sharded(mode="fast")``) from the
    ranks' sharded maps at FAST_GN_ITERATIONS: within 0.5 mm / 1e-4 rad of
    JAX's sharded fast GN."""
    w.assert_pose_close(ranks[0]["gn_fast_early_pose"],
                        jax_ref["gn_fast_early"][0])


def test_jax_fast_gn_parts_with_itself(scenes):
    """Why the fast-mode GN is held against JAX at FAST_GN_ITERATIONS
    only: at that count JAX's single-window and sharded fast GN agree
    within the tolerance, at 60 they part by more than 1e-3 rad."""
    from warpsense_tpu.ops import registration as jreg
    _, (ray, rpts, rmask) = scenes
    jray = JState(*(np.asarray(t) for t in ray))
    mesh = jsh.make_mesh(8)
    args = (jnp.asarray(rpts.numpy()), jnp.asarray(rmask.numpy()),
            jnp.asarray(w.PERT))
    poses = {}
    for n in (w.FAST_GN_ITERATIONS, w.PARITY_REG_KW["max_iterations"]):
        kw = dict(w.PARITY_REG_KW, max_iterations=n, mode="fast")
        poses[n] = (np.asarray(jreg.register_cloud(jray, *args, **kw)),
                    np.asarray(jsh.register_cloud_sharded(
                        jsh.shard_state(jray, mesh), *args, mesh=mesh,
                        **kw)))
    w.assert_pose_close(*poses[w.FAST_GN_ITERATIONS])
    assert w.rot_err(*poses[w.PARITY_REG_KW["max_iterations"]]) > 1e-3


@pytest.mark.parametrize("name", w.LOOP_NAMES)
def test_fused_order_is_the_two_phase_loop(ranks, name):
    """On every world (1 through a gloo group of one, 2 and 4) and at every
    chunk size: the fused order's end state, iterations and trace are the
    two-phase loop's, bit for bit."""
    r0 = ranks[0]
    want = r0[f"{name}_two_phase_state"]
    wtrace = r0[f"{name}_two_phase_trace"]
    assert 2 < want[treg.S_I]
    for chunk in w.LOOP_CHUNKS:
        np.testing.assert_array_equal(r0[f"{name}_state_{chunk}"], want)
        np.testing.assert_array_equal(r0[f"{name}_trace_{chunk}"], wtrace)
        assert r0[f"{name}_head_{chunk}"][treg.S_I] == want[treg.S_I]


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("name", ["packed", "exact", "gn_parity"])
def test_fused_order_without_a_group(problems, name, chunk):
    """A world of one without a group, in this process: the fused order's
    end state, header and trace are the two-phase loop's, bit for bit."""
    prob, pose = problems[name]
    mesh = sh.make_mesh("cpu")
    trace = torch.zeros((prob.max_iterations, treg.trace_width(1)))
    wtrace = torch.zeros_like(trace)
    with one_thread():
        got, head = sh.run_registration_sharded(prob, pose, mesh,
                                                chunk=chunk, trace=trace)
        want = w.two_phase_loop(prob, pose, mesh, wtrace)
    assert torch.equal(got, want) and head == want[:treg.S_HEAD].tolist()
    assert torch.equal(trace, wtrace)


def test_fused_iteration_is_a_step_then_the_next_statistics(problems):
    """One fused iteration from slot 0 into slot 1: with no rows pending
    it only computes the statistics (and copies the carry); with rows
    pending it takes the plain step on them, then the statistics at the
    stepped carry; slot 0 stays as it was; a stopped carry clears
    PENDING and leaves the rows."""
    prob, pose = problems["packed"]
    carry = torch.zeros((2, treg.CARRY_LEN))
    treg.init_state(prob, pose, "cpu", out=carry[0, :treg.STATE_LEN])
    rows = torch.zeros((2, 1, treg.PARTIALS))
    with one_thread():
        state = treg.init_state(prob, pose, "cpu")
        before = carry[0].clone()
        treg.fused_iteration_plain(carry[0], carry[1], rows[0], rows[1],
                                   prob, {})
        assert torch.equal(carry[0], before)
        assert torch.equal(carry[1, :treg.STATE_LEN], state)
        assert carry[1, treg.PENDING] == 1.0
        row = treg.reg_stats_plain(state, prob, {})
        assert torch.equal(rows[1], row)
        treg.fused_iteration_plain(carry[1], carry[0], rows[1], rows[0],
                                   prob, {})
        treg.reg_step_plain(state, row, prob)
        assert torch.equal(carry[0, :treg.STATE_LEN], state)
        assert torch.equal(rows[0], treg.reg_stats_plain(state, prob, {}))
        done = carry[0].clone()
        done[treg.S_FIN] = 1.0
        done[treg.PENDING] = 0.0
        kept = rows.clone()
        out = torch.ones(treg.CARRY_LEN)
        treg.fused_iteration_plain(done, out, rows[0], rows[1], prob, {})
        assert torch.equal(out[:treg.STATE_LEN], done[:treg.STATE_LEN])
        assert out[treg.PENDING] == 0.0
        assert torch.equal(rows, kept)


def test_header_reads_of_the_fused_chunks():
    """A chunk's first launch steps on the rows of the chunk before, so
    a registration of n steps ends after n + 1 launches:
    ceil((n + 1) / chunk) header reads."""
    assert [treg.shard_reads(n) for n in (1, 5, 6, 7, 8, 15, 200)] == [
        1, 1, 1, 1, 2, 2, 26]
    assert treg.shard_reads(5, 1) == 6
