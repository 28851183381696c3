"""Port vs JAX: the registration loops run as the JAX ``lax.while_loop``,
with the carry in one state buffer and the plain versions of the loop
kernel's halves, K3 (``reg_stats_plain``) and K4 (``reg_step_plain``), on
the CPU, driven in chunks (``run_registration``); the trace replay that
holds the loop kernel's steps to the plain step on the card; the loop
kernel's point plan.

Same map, fields and cloud in both (handed over through numpy), at a
81 x 81 x 65 window.  Tolerances: poses within 0.5 mm and 1e-4 rad (the
repo's registration bound), iteration counts equal: the statistics are
float32 sums in another order than XLA's and the 6x6 solve is K4's LU
rather than XLA's, so each step differs from JAX's in its last bits, far
below what moves a decision of the loop on these scenes.  The chunk size
changes nothing: a finished state ignores the iterations enqueued after
it, so k = 1, 3 and 8 give the same bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.core.consts import MATRIX_RESOLUTION as MR
from warpsense_tpu.core.consts import WEIGHT_RESOLUTION
from warpsense_tpu.core.geometry import rodrigues
from warpsense_tpu.map.local_map import LocalMapState as JState
from warpsense_tpu.ops import registration as jreg
from warpsense_tpu.ops import tsdf as jt
from warpsense_tpu.ops.tsdf_projective import tsdf_update_projective
from warpsense_tpu_torch.interop import (packed_fields_from_numpy,
                                         registration_fields_from_numpy)
from warpsense_tpu_torch.kernels import registration as kreg
from warpsense_tpu_torch.ops import registration as treg

TAU, RES = 600, 64
SIZE = (81, 81, 65)
HALF, ZHALF = 2200.0, 1700.0
POSE_MM, ROT_RAD = 0.5, 1e-4


def _walls(n, rng):
    """Points on a box room's walls plus two pillars (rotation
    observability), int32 mm."""
    pts = []
    for ax in range(3):
        for s in (-1.0, 1.0):
            p = np.stack([rng.uniform(-HALF, HALF, n),
                          rng.uniform(-HALF, HALF, n),
                          rng.uniform(-ZHALF, ZHALF, n)], axis=1)
            p[:, ax] = s * (ZHALF if ax == 2 else HALF)
            pts.append(p)
    m = n // 2
    for x in (600.0, 1000.0):
        pts.append(np.stack([np.full(m, x), rng.uniform(700, 1100, m),
                             rng.uniform(-ZHALF, ZHALF, m)], axis=1))
    return np.round(np.concatenate(pts)).astype(np.int32)


def _empty_state():
    return JState(value=jnp.full(SIZE, TAU, jnp.int16),
                  weight=jnp.zeros(SIZE, jnp.int16),
                  pos=jnp.zeros(3, jnp.int32),
                  offset=jnp.asarray([s // 2 for s in SIZE], jnp.int32))


@pytest.fixture(scope="module")
def fast_scene():
    """A map fused by JAX's projective fusion and a cloud of the room."""
    rng = np.random.default_rng(11)
    st = _empty_state()
    kw = dict(size=SIZE, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
              resolution=RES, channels=64, columns=512, vfov_deg=90.0)
    for origin in ((0, 0, 0), (4, -3, 1), (-5, 2, -1)):
        mp = _walls(4000, rng)
        st = tsdf_update_projective(
            st, jnp.asarray(mp), jnp.ones(len(mp), bool),
            jnp.asarray(origin, jnp.int32), jnp.eye(3, dtype=jnp.float32),
            **kw)
    return st, _walls(500, rng)


@pytest.fixture(scope="module")
def parity_scene():
    """A map fused by JAX's ray march and a voxel-snapped, dedup'd cloud,
    as parity mode registers."""
    rng = np.random.default_rng(12)
    st = _empty_state()
    steps = jt.plan_raymarch(TAU, RES, 5000)
    for origin in ((0, 0, 0), (4, -3, 1)):
        mp = _walls(3000, rng)
        st = jt.tsdf_update(
            st, jnp.asarray(mp), jnp.ones(len(mp), bool),
            jnp.asarray(origin, jnp.int32), jnp.asarray([0, 0, MR], jnp.int32),
            size=SIZE, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
            resolution=RES, max_steps=steps[0], max_isteps=steps[1])
    cloud = np.unique(_walls(400, rng) // RES * RES + RES // 2,
                      axis=0).astype(np.int32)
    return st, cloud


def _perturbation(seed):
    rng = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)
    axis = rng.normal(size=3)
    axis *= np.radians(1.0) / np.linalg.norm(axis)
    pose[:3, :3] = np.asarray(rodrigues(jnp.asarray(axis, jnp.float32)))
    pose[:3, 3] = rng.uniform(-60, 60, 3)
    return pose


def _rot_err(a, b):
    m = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    v = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v) / 2.0)))


def _mask(n):
    mask = np.ones(n, bool)
    mask[::13] = False
    return mask


def _t(a):
    return torch.as_tensor(np.array(a))


def _packed(st, exact):
    if exact:
        jf = jreg.precompute_fields_packed2(st)
        return jf, packed_fields_from_numpy(np.asarray(jf.plane_a),
                                            np.asarray(jf.plane_b),
                                            device="cpu")
    jf = jreg.precompute_fields_packed(st, tau=TAU)
    return jf, packed_fields_from_numpy(np.asarray(jf.plane), device="cpu")


LM_KW = dict(size=SIZE, resolution=RES, tau=TAU, max_iterations=50,
             it_weight_gradient=0.1, epsilon=0.03)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("coarse,freeze", [(0, False), (0, True), (4, False),
                                           (4, True)])
def test_packed_loop_matches_jax(fast_scene, exact, coarse, freeze):
    st, cloud = fast_scene
    jf, tf = _packed(st, exact)
    pert = _perturbation(20 + coarse + 2 * int(freeze) + int(exact))
    mask = _mask(len(cloud))
    kw = dict(LM_KW, coarse_iterations=coarse, gather_freeze=freeze)
    jpose, jit, jerr = jreg.register_cloud_packed(
        jf, st.pos, st.offset, jnp.asarray(cloud), jnp.asarray(mask),
        jnp.asarray(pert), **kw)
    calls = treg.run_registration.calls
    tpose, tit, terr = treg.register_cloud_packed(
        tf, _t(st.pos), _t(st.offset), _t(cloud), _t(mask), _t(pert), **kw)
    assert treg.run_registration.calls == calls + 1
    jpose, tpose = np.asarray(jpose), tpose.numpy()
    assert tit == int(jit), (tit, int(jit))
    assert np.max(np.abs(tpose[:3, 3] - jpose[:3, 3])) < POSE_MM
    assert _rot_err(tpose, jpose) < ROT_RAD
    assert abs(terr - float(jerr)) < 1e-3 * max(1.0, float(jerr))
    # the loop undid most of the perturbation (the scene's own bias is a
    # few mm)
    assert np.linalg.norm(tpose[:3, 3]) < 0.6 * np.linalg.norm(pert[:3, 3])


def _jax_gn_iterations(jf, st, cloud, mask, pert, kw, pose, n):
    """JAX's register_cloud_fields returns only the pose; its loop ran n
    iterations iff a cap of n gives the same pose and a cap of n - 1 does
    not."""
    def capped(m):
        return np.asarray(jreg.register_cloud_fields(
            jf, st.pos, st.offset, jnp.asarray(cloud), jnp.asarray(mask),
            jnp.asarray(pert), **dict(kw, max_iterations=m)))
    return (np.array_equal(capped(n), pose)
            and not np.array_equal(capped(n - 1), pose))


@pytest.mark.parametrize("mode,iters", [("parity", 200), ("fast", 30)])
def test_fields_loop_matches_jax(parity_scene, mode, iters):
    """One GN registration in each mode.  The parity GN creeps for ~100
    iterations until its 4-error window closes; where float-order noise
    moves the iteration at which it closes, the poses part by as much as
    the creep of the iterations between (on this scene, at two of four
    perturbations: 0.6 and 3.7 mm, and the LAPACK host loop's 9.5 and 0.8
    mm, CPU run), so the call held here is one that ends by the window
    at JAX's iteration."""
    st, cloud = parity_scene
    jf = jreg.precompute_fields(st)
    tf = registration_fields_from_numpy(*(np.asarray(p) for p in jf),
                                        device="cpu")
    pert = _perturbation(1)
    mask = _mask(len(cloud))
    kw = dict(size=SIZE, resolution=RES, max_iterations=iters,
              it_weight_gradient=0.1, epsilon=0.03, mode=mode)
    want = np.asarray(jreg.register_cloud_fields(
        jf, st.pos, st.offset, jnp.asarray(cloud), jnp.asarray(mask),
        jnp.asarray(pert), **kw))
    got, n = treg.register_cloud_fields(
        tf, _t(st.pos), _t(st.offset), _t(cloud), _t(mask), _t(pert),
        return_iterations=True, **kw)
    got = got.numpy()
    assert np.max(np.abs(got[:3, 3] - want[:3, 3])) < POSE_MM
    assert _rot_err(got, want) < ROT_RAD
    assert np.max(np.abs(got[:3, 3] - pert[:3, 3])) > 5.0    # it moved
    assert 1 < n <= iters
    assert _jax_gn_iterations(jf, st, cloud, mask, pert, kw, want, n)


@pytest.fixture(scope="module")
def chunk_problems(fast_scene, parity_scene):
    """A packed LM registration with the coarse phase and the freeze, and a
    parity GN one, as RegProblems with their pretransforms."""
    st, cloud = fast_scene
    _, tf = _packed(st, False)
    mask = _mask(len(cloud))
    lm = treg.RegProblem(
        fields=tf, pos=_t(st.pos), offset=_t(st.offset), points=_t(cloud),
        mask=_t(mask), size=SIZE, resolution=RES, tau=TAU,
        layout=treg.LAYOUT_PACKED, interp=True, normalize=False, lm=True,
        recenter=True, coarse_iterations=3, split=True, max_iterations=50,
        epsilon=0.03, it_weight_gradient=0.0, freeze_step_mm=float(RES))
    pst, pcloud = parity_scene
    pf = registration_fields_from_numpy(
        *(np.asarray(p) for p in jreg.precompute_fields(pst)), device="cpu")
    gn = treg.RegProblem(
        fields=pf, pos=_t(pst.pos), offset=_t(pst.offset), points=_t(pcloud),
        mask=_t(_mask(len(pcloud))), size=SIZE, resolution=RES, tau=TAU,
        layout=treg.LAYOUT_PARITY, interp=False, normalize=False, lm=False,
        recenter=False, coarse_iterations=0, split=False, max_iterations=200,
        epsilon=0.03, it_weight_gradient=0.1, freeze_step_mm=0.0)
    pert = _t(_perturbation(41))
    return {"lm": (lm, pert), "gn": (gn, pert)}


@pytest.mark.parametrize("loop", ["lm", "gn"])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_chunk_size_changes_no_bit(chunk_problems, loop, chunk):
    prob, pert = chunk_problems[loop]
    want, head = treg.run_registration(prob, pert, chunk=1)
    got, ghead = treg.run_registration(prob, pert, chunk=chunk)
    assert torch.equal(got, want)           # every field of the carry
    assert ghead == head
    assert 2 < head[treg.S_I] < prob.max_iterations and head[treg.S_FIN]


def test_wrappers_run_the_plain_versions_on_the_cpu(chunk_problems):
    """On a CPU state the loop kernel's wrapper is the plain loop and
    launches nothing; the chunked loop is the host loop's (``host=True``)
    bit for bit."""
    prob, pert = chunk_problems["lm"]
    launches = kreg.reg_loop.launches
    syncs = treg.run_registration.syncs
    state, head = treg.run_registration(prob, pert)
    assert kreg.reg_loop.launches == launches
    assert treg.run_registration.syncs == syncs      # no card, no sync
    host, hhead = treg.run_registration(prob, pert, host=True)
    assert torch.equal(state, host) and head == hhead
    direct = treg.init_state(prob, pert, "cpu")
    kreg.reg_loop(direct, prob)
    assert torch.equal(direct, host) and kreg.reg_loop.launches == launches


@pytest.fixture(scope="module")
def trace_problems(fast_scene, parity_scene):
    """RegProblems of every loop the kernel runs: the LM over packed and
    exact fields (without and with the coarse phase and the freeze) and
    the GN in its parity and fast modes."""
    st, cloud = fast_scene
    mask = _mask(len(cloud))
    lm = dict(pos=_t(st.pos), offset=_t(st.offset), points=_t(cloud),
              mask=_t(mask), size=SIZE, resolution=RES, tau=TAU,
              interp=True, normalize=False, lm=True, recenter=True,
              max_iterations=50, epsilon=0.03, it_weight_gradient=0.0,
              freeze_step_mm=float(RES))
    out = {}
    for exact in (False, True):
        tf = _packed(st, exact)[1]
        layout = treg.LAYOUT_EXACT if exact else treg.LAYOUT_PACKED
        name = "exact" if exact else "packed"
        out[name] = treg.RegProblem(fields=tf, layout=layout,
                                    coarse_iterations=0, split=False, **lm)
        out[name + "_coarse_freeze"] = treg.RegProblem(
            fields=tf, layout=layout, coarse_iterations=3, split=True, **lm)
    pst, pcloud = parity_scene
    pf = registration_fields_from_numpy(
        *(np.asarray(p) for p in jreg.precompute_fields(pst)), device="cpu")
    for mode in ("parity", "fast"):
        out["gn_" + mode] = treg.RegProblem(
            fields=pf, pos=_t(pst.pos), offset=_t(pst.offset),
            points=_t(pcloud), mask=_t(_mask(len(pcloud))), size=SIZE,
            resolution=RES, tau=TAU, layout=treg.LAYOUT_PARITY,
            interp=False, normalize=mode == "fast", lm=False,
            recenter=mode == "fast", coarse_iterations=0, split=False,
            max_iterations=200 if mode == "parity" else 30, epsilon=0.03,
            it_weight_gradient=0.1, freeze_step_mm=0.0)
    return out, _t(_perturbation(41))


@pytest.mark.parametrize("name", ["packed", "exact", "packed_coarse_freeze",
                                  "exact_coarse_freeze", "gn_parity",
                                  "gn_fast"])
def test_trace_replay_is_the_host_loop(trace_problems, name):
    """The loop's trace, replayed step by step with the plain step
    (``replay_trace``, the check the loop kernel is held to on the card),
    gives every traced carry and the end state to the bit; on a trace of
    the plain loop that end state is the host loop's.  A carry changed in
    the trace is found at the step before it."""
    probs, pert = trace_problems
    prob = probs[name]
    trace = torch.zeros((prob.max_iterations, kreg.TRACE_WIDTH))
    state = treg.init_state(prob, pert, "cpu")
    kreg.reg_loop(state, prob, trace=trace)
    host, _ = treg.run_registration(prob, pert, host=True)
    replayed, differ, tests, err = treg.replay_trace(trace, state, prob)
    assert differ == [] and err == 0.0
    assert torch.equal(replayed, host) and torch.equal(state, host)
    n = int(host[treg.S_I])
    assert 2 < n == len(tests) and all(t is not None for t in tests)
    assert not trace[n:].any()                       # untouched past the end
    assert not trace[:n, treg.STATE_LEN + treg.PARTIALS:].any()
    if prob.split:
        assert bool(host[treg.S_FROZEN])        # the cached mode ran
    trace[2, treg.S_ALPHA] += 1.0
    _, differ, _, err = treg.replay_trace(trace, state, prob)
    assert differ == [1, 2] and err >= 0.999


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("n", [1, 8100, 32766, 131072])
def test_cluster_plan_takes_every_point_once(n, stride):
    """The loop kernel's point -> thread plan (fixed by the point count):
    the cluster's threads together take every point exactly once (every
    4th point in the coarse phase, ``stride`` 4), no thread more than its
    share rounded up."""
    taken = [kreg.thread_points(n, r, t, stride)
             for r in range(kreg.CLUSTER) for t in range(kreg.THREADS)]
    flat = np.concatenate([np.asarray(p, np.int64) for p in taken])
    np.testing.assert_array_equal(np.sort(flat), np.arange(0, n, stride))
    count = -(-n // stride)
    assert max(len(p) for p in taken) == -(-count
                                           // (kreg.CLUSTER * kreg.THREADS))


def _damped_normals(n, rng):
    """n damped normal matrices as the loops form them: J^T J of 64 rows
    with column scales over four decades, plus alpha * diag."""
    J = rng.normal(size=(n, 64, 6)) * np.logspace(-2, 2, 6)
    A = np.einsum("nki,nkj->nij", J, J)
    alpha = 10.0 ** rng.uniform(-5, 1, n)
    A += alpha[:, None, None] * np.eye(6) * np.diagonal(
        A, axis1=1, axis2=2)[:, :, None]
    b = rng.normal(size=(n, 6)) * np.logspace(0, 2, 6)
    return A.astype(np.float32), b.astype(np.float32)


def test_solve6_matches_lapack_on_damped_normal_matrices():
    """K4's LU (``solve6``) against ``torch.linalg.solve_ex`` on 10^4
    seeded systems whose condition numbers reach ~3e8: each solution
    within 1e-4 relative (max norm) of LAPACK's; each within cond(A) x
    2^-23 of the float64 solution (a backward-stable solve's forward
    error), and the worst no worse than LAPACK's worst (measured: 6.4e-5
    against 7.2e-5)."""
    A, b = _damped_normals(10_000, np.random.default_rng(5))
    got = treg.solve6(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    ref, info = torch.linalg.solve_ex(torch.from_numpy(A),
                                      torch.from_numpy(b))
    assert int(info.abs().max()) == 0
    ref = ref.numpy()
    A64 = A.astype(np.float64)
    exact = np.linalg.solve(A64, b.astype(np.float64)[..., None])[..., 0]
    scale = np.abs(exact).max(axis=1)
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - ref).max(axis=1) / scale) < 1e-4
    err_lu = np.abs(got - exact).max(axis=1) / scale
    err_lapack = np.abs(ref - exact).max(axis=1) / scale
    assert np.all(err_lu <= np.linalg.cond(A64) * 2.0 ** -23)
    assert err_lu.max() <= err_lapack.max()


def test_singular_system_gives_nan_and_a_skipped_step(chunk_problems):
    """A zero pivot makes the whole solution NaN; in the GN loop (alpha
    still 0) the step is skipped without stopping: the pose stays, the
    iteration counts and the damping ramps."""
    A = torch.eye(6)
    A[3, 3] = 0.0
    y = treg.solve6(A, torch.ones(6))
    assert torch.isnan(y).all()
    batch = treg.solve6(torch.stack([A, torch.eye(6)]), torch.ones(2, 6))
    assert torch.isnan(batch[0]).all() and torch.equal(batch[1],
                                                       torch.ones(6))
    prob, pert = chunk_problems["gn"]
    state = treg.init_state(prob, pert, "cpu")
    H = torch.eye(6) * 1e-2
    H[2, 2] = 0.0                                  # rank deficient
    row = treg.pack_stats(H, torch.ones(6), torch.tensor(50.0),
                          torch.tensor(100.0))
    before = state.clone()
    treg.reg_step_plain(state, row, prob)
    assert state[treg.S_OK] == 0 and state[treg.S_FIN] == 0
    assert state[treg.S_I] == 1
    assert torch.equal(state[treg.S_TRIAL:treg.S_TRIAL + 16],
                       before[treg.S_TRIAL:treg.S_TRIAL + 16])
    assert float(state[treg.S_ALPHA]) == np.float32(0.1)


def test_the_partials_sum_is_k4s_lane_order():
    """``sum_partials``: rows l, l + 8, ... summed in order per lane, then
    the lanes in order (the order in which the loop kernel's step sums its
    CTAs' rows), not a library reduction."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.normal(size=(37, treg.PARTIALS)).astype(
        np.float32) * 1e4)
    want = torch.zeros(treg.PARTIALS)
    for lane in range(treg.STEP_LANES):
        t = torch.zeros(treg.PARTIALS)
        for r in range(lane, 37, treg.STEP_LANES):
            t = t + p[r]
        want = want + t
    assert torch.equal(treg.sum_partials(p), want)
