"""Wrappers of the registration kernels of ``csrc/registration.cu``: the
loop kernel (``ws_reg_loop``, a whole GN or LM registration in one launch)
and the sharded loop's two halves (``ws_reg_shard_stats``,
``ws_reg_shard_step``).

They replace no TPU kernel: the JAX package runs its registration loops as
XLA code inside one ``lax.while_loop`` (``warpsense_tpu/ops/registration.py``
``_gn_loop`` :212, ``_lm_loop`` :572, statistics ``jacobian_stats_fields``
:106 and ``make_packed_stats`` :454), under ``shard_map`` on a mesh
(``warpsense_tpu/parallel/sharded.py`` :145, :397).  The loop kernel runs
that loop on the card as one thread-block cluster: K3 (an iteration's
statistics) and K4 (the step) are its two halves, and its carry is the
state buffer of ``ops/registration.py`` (``S_*``).  The sharded loop
launches them apart, K3 on the rank's slab (``shard_stats``) and K4 on
every rank's rows (``shard_step``), with the collective between them
(``parallel/sharded.run_registration_sharded``).  A CUDA state launches
the kernels (or raises); a CPU state runs the plain versions,
``reg_stats_plain`` and ``reg_step_plain``.  Each wrapper counts its
launches (``reg_loop.launches``, ``shard_stats.launches``,
``shard_step.launches``).
"""
from __future__ import annotations

import ctypes

import torch

from typing import NamedTuple

from ..ops.registration import (CHUNK, LAYOUT_PARITY, PARTIALS, S_I,
                                STATE_LEN, RegProblem, loop_plain,
                                packed_shifts, reg_stats_plain,
                                reg_step_plain, slab_of, stopped,
                                trace_width)
from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int

# a CTA's threads, and the CTAs of the one cluster a registration runs on
# (csrc/registration.cu's kCluster): 16, the non-portable size, which an
# H100 places, took 0.76-0.88 of the portable 8's device time an iteration
# on every REGLOOP problem (PERF.md section 6)
THREADS = 512
CLUSTER = 16
TRACE_WIDTH = trace_width(CLUSTER)


def thread_points(n: int, rank: int, thread: int, stride: int = 1) -> range:
    """The points thread ``thread`` of CTA ``rank`` sums, in its order (the
    loop kernel's plan, fixed by ``n`` alone): global thread g takes
    every ``CLUSTER * THREADS``-th of the strided points from g on;
    ``stride`` 4 in the coarse phase."""
    g = rank * THREADS + thread
    count = -(-n // stride)
    return range(g * stride, count * stride, CLUSTER * THREADS * stride)


def _lib():
    lib = _build.load("registration")
    if lib.ws_reg_loop.argtypes is None:
        if lib.ws_reg_cluster() != CLUSTER:
            raise RuntimeError(f"the loop kernel was built for clusters of "
                               f"{lib.ws_reg_cluster()} CTAs, not {CLUSTER}")
        lib.ws_reg_loop.argtypes = [_VP] * 16
        lib.ws_reg_loop.restype = _I
        lib.ws_reg_loop_clusters.argtypes = [_I]
        lib.ws_reg_loop_clusters.restype = _I
        lib.ws_reg_cluster_empty.argtypes = [_VP, _I, _VP]
        lib.ws_reg_cluster_empty.restype = _I
        lib.ws_reg_empty.argtypes = [_VP]
        lib.ws_reg_empty.restype = _I
        lib.ws_reg_shard_plan_size.argtypes = []
        lib.ws_reg_shard_plan_size.restype = _I
        lib.ws_reg_shard_plan.argtypes = [_VP] * 16 + [_I] + [_VP] * 3
        lib.ws_reg_shard_plan.restype = _I
        for fn in (lib.ws_reg_shard_stats, lib.ws_reg_shard_step):
            fn.argtypes = [_VP]
            fn.restype = _I
    return lib


_placed: dict = {}


def max_clusters(layout: int) -> int:
    """How many clusters of the loop kernel the card holds at once
    (``cudaOccupancyMaxActiveClusters``, asked once per layout); raises
    when the query fails or the cluster cannot be placed."""
    key = (torch.cuda.current_device(), layout)
    if key not in _placed:
        n = _lib().ws_reg_loop_clusters(layout)
        if n < 0:
            _build.check(-n, f"cluster occupancy of the loop kernel "
                         f"({CLUSTER} CTAs)")
        if n < 1:
            raise RuntimeError(f"a cluster of {CLUSTER} CTAs of "
                               f"{THREADS} threads cannot be placed on "
                               f"{torch.cuda.get_device_name()}")
        _placed[key] = n
    return _placed[key]


def _on(t: torch.Tensor, dev, dtype, what: str) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, the state on {dev}")
    return t.to(dtype).contiguous()


def _check_trace(trace, state, prob: RegProblem, width: int) -> None:
    if trace is not None and (trace.device != state.device
                              or trace.dtype != torch.float32
                              or tuple(trace.shape) != (
                                  prob.max_iterations, width)
                              or not trace.is_contiguous()):
        raise ValueError(f"trace must be contiguous float32 "
                         f"({prob.max_iterations}, {width}) "
                         "on the state's device")


def _kernel_args(state: torch.Tensor, prob: RegProblem) -> tuple:
    """The checked device arguments of a registration's kernels, in the C
    order (state, points, mask, three planes, pos, offset, the four cache
    buffers), the int and float parameter blocks, and the tensors to keep
    alive while they run.  Raises on what the kernels do not take."""
    if state.dtype != torch.float32 or state.shape != (STATE_LEN,) \
            or not state.is_contiguous():
        raise ValueError("the state must be contiguous float32 of STATE_LEN")
    dev = state.device
    planes = [_on(p, dev, torch.int32, "a fields plane") for p in prob.fields]
    if len({tuple(p.shape) for p in planes}) != 1 or planes[0].dim() != 3:
        raise ValueError("the fields planes must be 3-D and of one shape")
    X, Y, Z = prob.size
    x_lo, x_rows = slab_of(prob)
    if tuple(planes[0].shape) != (x_rows, Y, Z) or not (
            0 <= x_lo and x_lo + x_rows <= X):
        raise ValueError(f"fields {tuple(planes[0].shape)} are not rows "
                         f"[{x_lo}, {x_lo + x_rows}) of the window "
                         f"{tuple(prob.size)}")
    points = _on(prob.points, dev, torch.int32, "points")
    mask = _on(prob.mask, dev, torch.bool, "mask")
    if points.dim() != 2 or points.shape[1] != 3 or mask.shape != (
            points.shape[0],):
        raise ValueError("points must be (N, 3) and mask (N,)")
    pos = _on(prob.pos, dev, torch.int32, "pos")
    offset = _on(prob.offset, dev, torch.int32, "offset")
    if pos.numel() != 3 or offset.numel() != 3:
        raise ValueError("pos and offset must hold 3 ints")
    n = points.shape[0]
    if prob.split:
        cache = (torch.empty(n, dtype=torch.uint8, device=dev),
                 torch.empty(n, dtype=torch.float32, device=dev),
                 torch.empty((n, 3), dtype=torch.float32, device=dev),
                 torch.empty((n, 3), dtype=torch.int32, device=dev))
    else:
        cache = ()
    vs, gs = packed_shifts(prob.tau) if prob.layout != LAYOUT_PARITY \
        else (0, 0)
    # the slab last: ws_reg_loop reads the first 15, the shard plan all
    ip = (ctypes.c_int * 17)(
        n, X, Y, Z, prob.resolution, prob.layout, vs, gs, int(prob.interp),
        int(prob.normalize), prob.coarse_iterations, int(prob.split),
        prob.max_iterations, int(prob.lm), int(prob.recenter), x_lo, x_rows)
    fp = (ctypes.c_float * 3)(prob.epsilon, prob.it_weight_gradient,
                              prob.freeze_step_mm ** 2)
    ptrs = ([state.data_ptr(), points.data_ptr(), mask.data_ptr()]
            + [p.data_ptr() for p in planes] + [None] * (3 - len(planes))
            + [pos.data_ptr(), offset.data_ptr()]
            + ([t.data_ptr() for t in cache] or [None] * 4))
    keep = (planes, points, mask, pos, offset, cache)
    return ptrs, ip, fp, keep


def reg_loop(state: torch.Tensor, prob: RegProblem, *, trace=None,
             chunk: int = CHUNK) -> None:
    """Run the registration loop of ``prob`` on ``state`` (in place, from
    wherever its carry stands to the finished flag or max_iterations).

    CUDA state: one launch of the loop kernel on the current stream, as a
    cluster of ``CLUSTER`` CTAs (a failed build or launch, or a cluster
    that cannot be placed, raises); nothing is read back.  CPU state: the
    plain loop, reading its header once every ``chunk`` iterations.
    ``trace``: None, or a zeroed float32 (max_iterations, ``TRACE_WIDTH``)
    tensor on the state's device: row i gets the carry before step i and
    the rows of statistics the step summed (the plain loop's one row, then
    zeros).  The problem is the whole window: a rank's slab raises."""
    _check_trace(trace, state, prob, TRACE_WIDTH)
    if slab_of(prob) != (0, prob.size[0]):
        raise ValueError("the loop kernel runs the whole window; a rank's "
                         "slab runs through parallel.sharded."
                         "run_registration_sharded")
    if state.device.type == "cpu":
        loop_plain(state, prob, lambda st, cache: reg_stats_plain(
            st, prob, cache), chunk=chunk, trace=trace)
        return
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    ptrs, ip, fp, _keep = _kernel_args(state, prob)
    max_clusters(prob.layout)
    rc = _lib().ws_reg_loop(
        *ptrs, None if trace is None else trace.data_ptr(),
        ctypes.cast(ip, _VP), ctypes.cast(fp, _VP),
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(rc, "the registration loop kernel")
    reg_loop.launches += 1


reg_loop.launches = 0


class ShardPlan(NamedTuple):
    """One sharded registration's kernels and their buffers, checked and
    bound once (``shard_plan``): the carry, the problem (the rank's slab),
    this rank's rows of an iteration, the world's gathered rows, the trace,
    the per-point cache of the gather freeze (a dict on the CPU, device
    buffers on the card) and, on the card, the C plan (host memory holding
    the kernels' arguments and the stream they launch on) and the tensors
    it points into."""
    state: torch.Tensor
    prob: RegProblem
    rows: torch.Tensor
    rows_all: torch.Tensor
    trace: torch.Tensor | None
    cache: object
    block: object
    keep: tuple


def shard_plan(state: torch.Tensor, prob: RegProblem, rows: torch.Tensor,
               rows_all: torch.Tensor, *, trace=None) -> ShardPlan:
    """Bind one sharded registration: ``rows`` is this rank's float32
    (``CLUSTER``, PARTIALS) rows on a CUDA state (one row on a CPU state),
    ``rows_all`` the world's rows, rank-major, that the collective fills
    (``rows`` itself at a world of one).  ``trace``: None, or a zeroed
    float32 (max_iterations, ``trace_width(len(rows_all))``) tensor on the
    state's device.  On the card the inputs are checked and the kernels'
    arguments built here, once a registration, and both kernels launch on
    the stream current now; a build failure raises."""
    cuda = state.device.type == "cuda"
    if not cuda and state.device.type != "cpu":
        raise ValueError(f"unsupported device {state.device}")
    k = CLUSTER if cuda else 1
    for t, what in ((rows, "rows"), (rows_all, "rows_all")):
        if (t.device != state.device or t.dtype != torch.float32
                or t.dim() != 2 or t.shape[1] != PARTIALS
                or t.shape[0] % k or not t.is_contiguous()):
            raise ValueError(f"{what} must be contiguous float32 (m * {k}, "
                             f"{PARTIALS}) on the state's device")
    if rows.shape[0] != k:
        raise ValueError(f"rows must hold {k} rows")
    _check_trace(trace, state, prob, trace_width(rows_all.shape[0]))
    if not cuda:
        return ShardPlan(state, prob, rows, rows_all, trace, {}, None, ())
    ptrs, ip, fp, keep = _kernel_args(state, prob)
    lib = _lib()
    block = ctypes.create_string_buffer(lib.ws_reg_shard_plan_size())
    rc = lib.ws_reg_shard_plan(
        block, *ptrs, None if trace is None else trace.data_ptr(),
        rows.data_ptr(), rows_all.data_ptr(), rows_all.shape[0],
        ctypes.cast(ip, _VP), ctypes.cast(fp, _VP),
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(rc, "the sharded registration's plan")
    return ShardPlan(state, prob, rows, rows_all, trace, keep[-1], block,
                     keep)


def shard_stats(plan: ShardPlan) -> None:
    """K3 of this rank for one iteration into ``plan.rows``: on the card
    one launch of ``shard_stats_kernel`` (each of the ``CLUSTER`` CTAs its
    row; a failed launch raises), on the CPU ``reg_stats_plain`` on the
    slab.  Nothing on a finished carry."""
    if plan.block is None:
        row = reg_stats_plain(plan.state, plan.prob, plan.cache)
        if row is not None:
            plan.rows.copy_(row)
        return
    _build.check(_lib().ws_reg_shard_stats(plan.block),
                 "the sharded statistics kernel")
    shard_stats.launches += 1


def shard_step(plan: ShardPlan) -> None:
    """K4 on every rank's rows (``plan.rows_all``), in place on the carry:
    on the card one launch of ``shard_step_kernel`` (a failed launch
    raises), on the CPU ``reg_step_plain``; with a trace, row i gets the
    carry before step i and the rows.  Nothing on a finished carry."""
    if plan.block is None:
        state, rows = plan.state, plan.rows_all
        if plan.trace is not None and not stopped(state, plan.prob):
            t = plan.trace[int(state[S_I])]
            t[:STATE_LEN] = state
            t[STATE_LEN:] = rows.reshape(-1)
        reg_step_plain(state, rows, plan.prob)
        return
    _build.check(_lib().ws_reg_shard_step(plan.block),
                 "the sharded step kernel")
    shard_step.launches += 1


shard_stats.launches = 0
shard_step.launches = 0


def launch_cluster_empty(out: torch.Tensor, iterations: int) -> None:
    """The empty cluster loop: the loop kernel's cluster shape doing only
    each iteration's barrier and distributed-shared-memory read,
    ``iterations`` times (the design's floor; not a launch of the loop
    kernel).  ``out``: 32 float32 on the card."""
    if not (out.is_cuda and out.dtype == torch.float32 and out.numel() >= 32):
        raise ValueError("out must hold 32 float32 on the card")
    _build.check(_lib().ws_reg_cluster_empty(
        out.data_ptr(), iterations, torch.cuda.current_stream(out.device).cuda_stream),
        "the empty cluster loop")


def launch_empty(stream: int) -> None:
    """One empty kernel on ``stream`` (a ``cuda_stream`` handle): one
    launch's floor (not a launch of the loop kernel)."""
    _build.check(_lib().ws_reg_empty(stream), "empty kernel")

