"""Wrappers of the registration kernels of ``csrc/registration.cu``: the
loop kernel (``ws_reg_loop``, a whole GN or LM registration in one launch)
and the sharded loop's iteration (``ws_reg_shard_iter``).

They replace no TPU kernel: the JAX package runs its registration loops as
XLA code inside one ``lax.while_loop`` (``warpsense_tpu/ops/registration.py``
``_gn_loop`` :212, ``_lm_loop`` :572, statistics ``jacobian_stats_fields``
:106 and ``make_packed_stats`` :454), under ``shard_map`` on a mesh
(``warpsense_tpu/parallel/sharded.py`` :145, :397).  The loop kernel runs
that loop on the card as one thread-block cluster: K3 (an iteration's
statistics) and K4 (the step) are its two halves, and its carry is the
state buffer of ``ops/registration.py`` (``S_*``).  The sharded loop
launches ``shard_iter_kernel`` once an iteration (``shard_iter``): K4 of
the iteration before on every rank's gathered rows, then K3 of this one
on the rank's slab, with the collective between two launches
(``parallel/sharded.run_registration_sharded``); a chunk of them can be
captured as a CUDA graph (``capture_chunk``) and replayed
(``replay_chunk``).  A CUDA state launches the kernels (or raises); a CPU
state runs the plain versions, ``reg_stats_plain`` and ``reg_step_plain``
(``fused_iteration_plain`` for the sharded iteration).  Each wrapper
counts its launches (``reg_loop.launches``, ``shard_iter.launches``; a
replayed chunk counts its launches, and ``shard_iter.replays`` and
``shard_iter.captures`` count the graphs).
"""
from __future__ import annotations

import ctypes

import torch

from typing import NamedTuple

from ..ops.registration import (CARRY_LEN, CHUNK, LAYOUT_PARITY, PARTIALS,
                                STATE_LEN, RegProblem,
                                fused_iteration_plain, loop_plain,
                                packed_shifts, reg_stats_plain, slab_of,
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
        lib.ws_reg_shard_args_size.argtypes = []
        lib.ws_reg_shard_args_size.restype = _I
        lib.ws_reg_shard_args.argtypes = [_VP] * 16 + [_I] + [_VP] * 2
        lib.ws_reg_shard_args.restype = _I
        lib.ws_reg_shard_iter.argtypes = [_VP, _I, _I, _VP]
        lib.ws_reg_shard_iter.restype = _I
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


class ShardBuffers(NamedTuple):
    """What the sharded iterations of one kind of registration read and
    write, kept from one registration to the next (a captured chunk holds
    their addresses): the carry, (2, CARRY_LEN), double-buffered by a
    launch's parity; this rank's rows of statistics, (2, k, PARTIALS), k
    = ``CLUSTER`` on the card and 1 on the CPU; the world's gathered rows,
    (2, nrows, PARTIALS), rank-major (``rows`` itself at a world of one
    without a collective); and on the card the arguments' block on the
    device and its pinned staging copy on the host."""
    carry: torch.Tensor
    rows: torch.Tensor
    rows_all: torch.Tensor
    args: torch.Tensor | None
    host: torch.Tensor | None


def shard_buffers(device, world: int, *, shared: bool = False
                  ) -> ShardBuffers:
    """Zeroed ``ShardBuffers`` on ``device`` for a world of ``world``
    ranks; ``shared``: the gathered rows are this rank's own (a world of
    one without a collective)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if not cuda and device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    k = CLUSTER if cuda else 1
    f32 = dict(dtype=torch.float32, device=device)
    rows = torch.zeros((2, k, PARTIALS), **f32)
    if shared and world != 1:
        raise ValueError("only a world of one shares its rows")
    rows_all = rows if shared else torch.zeros((2, world * k, PARTIALS),
                                               **f32)
    args = host = None
    if cuda:
        n = _lib().ws_reg_shard_args_size()
        args = torch.zeros(n, dtype=torch.uint8, device=device)
        host = torch.zeros(n, dtype=torch.uint8).pin_memory()
    return ShardBuffers(torch.zeros((2, CARRY_LEN), **f32), rows, rows_all,
                        args, host)


class ShardPlan(NamedTuple):
    """One sharded registration bound to its buffers (``shard_plan``): the
    problem (the rank's slab), the trace, the per-point cache of the
    gather freeze (a dict on the CPU, device buffers on the card) and the
    tensors the arguments point into."""
    bufs: ShardBuffers
    prob: RegProblem
    trace: torch.Tensor | None
    cache: object
    keep: tuple


def shard_plan(bufs: ShardBuffers, prob: RegProblem, *,
               trace=None) -> ShardPlan:
    """Bind one sharded registration of ``prob`` to ``bufs`` (whose carry
    slot 0 holds its initial carry).  ``trace``: None, or a zeroed float32
    (max_iterations, ``trace_width(nrows)``) tensor on the buffers'
    device.  On the card the inputs are checked and the kernel's
    arguments written to ``bufs.args`` (an asynchronous copy from pinned
    memory on the current stream); a build failure raises."""
    carry = bufs.carry
    cuda = carry.device.type == "cuda"
    nrows = bufs.rows_all.shape[1]
    _check_trace(trace, carry, prob, trace_width(nrows))
    if not cuda:
        return ShardPlan(bufs, prob, trace, {}, ())
    ptrs, ip, fp, keep = _kernel_args(carry[0, :STATE_LEN], prob)
    lib = _lib()
    rc = lib.ws_reg_shard_args(
        bufs.host.data_ptr(), *ptrs[1:],
        None if trace is None else trace.data_ptr(), carry.data_ptr(),
        bufs.rows.data_ptr(), bufs.rows_all.data_ptr(), nrows,
        ctypes.cast(ip, _VP), ctypes.cast(fp, _VP))
    _build.check(rc, "the sharded iteration's arguments")
    bufs.args.copy_(bufs.host, non_blocking=True)
    return ShardPlan(bufs, prob, trace, keep[-1], keep)


def shard_iter(plan: ShardPlan, parity: int) -> None:
    """One sharded iteration from the carry slot ``parity`` into the other
    one: the step of the slot's iteration on the gathered rows of slot
    ``parity`` when they are pending, then this rank's statistics of the
    next iteration into slot ``1 - parity`` of its rows.  On the card one
    launch of ``shard_iter_kernel`` on the current stream (counted unless
    the stream is being captured; a failed launch raises), on the CPU
    ``fused_iteration_plain``."""
    b = plan.bufs
    if b.args is None:
        fused_iteration_plain(b.carry[parity], b.carry[1 - parity],
                              b.rows_all[parity], b.rows[1 - parity],
                              plan.prob, plan.cache, plan.trace)
        return
    dev = b.carry.device
    _build.check(_lib().ws_reg_shard_iter(
        b.args.data_ptr(), plan.prob.layout, parity,
        torch.cuda.current_stream(dev).cuda_stream),
        "the sharded iteration kernel")
    if not torch.cuda.is_current_stream_capturing():
        shard_iter.launches += 1


def capture_chunk(plan: ShardPlan, gather, chunk: int = CHUNK):
    """A CUDA graph of one chunk: ``chunk`` times (``shard_iter`` of
    parity 0, 1, 0, ..., then ``gather(q)``, the collective that fills
    slot q = 1 - parity of the gathered rows), captured on a side stream
    of the carry's device.  Nothing runs while it is captured; the graph
    reads the buffers' arguments block at each replay, so it serves every
    registration planned on the same buffers.  ``chunk`` must be even
    (the carry ends in slot 0).  A failed capture raises."""
    if chunk % 2:
        raise ValueError("a captured chunk takes an even number of "
                         "iterations")
    dev = plan.bufs.carry.device
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for j in range(chunk):
                shard_iter(plan, j % 2)
                gather(1 - j % 2)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    shard_iter.captures += 1
    return graph


def replay_chunk(graph, chunk: int = CHUNK) -> None:
    """Replay a ``capture_chunk`` graph on the current stream: ``chunk``
    launches of ``shard_iter_kernel`` with their collectives."""
    graph.replay()
    shard_iter.launches += chunk
    shard_iter.replays += 1


shard_iter.launches = 0
shard_iter.replays = 0
shard_iter.captures = 0


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

