"""Wrapper of the registration loop kernel (``ws_reg_loop``,
``csrc/registration.cu``): a whole GN or LM registration in one launch.

It replaces no TPU kernel: the JAX package runs its registration loops as
XLA code inside one ``lax.while_loop`` (``warpsense_tpu/ops/registration.py``
``_gn_loop`` :212, ``_lm_loop`` :572, statistics ``jacobian_stats_fields``
:106 and ``make_packed_stats`` :454).  The loop kernel runs that loop on
the card as one thread-block cluster: K3 (an iteration's statistics) and K4
(the step) are its two halves, and its carry is the state buffer of
``ops/registration.py`` (``S_*``).  A CUDA state launches the kernel (or
raises); a CPU state runs the plain loop, ``reg_stats_plain`` and
``reg_step_plain`` (``ops/registration.loop_plain``).  The wrapper counts
its launches (``reg_loop.launches``).
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.registration import (CHUNK, LAYOUT_PARITY, STATE_LEN, RegProblem,
                                loop_plain, packed_shifts, reg_stats_plain,
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
    zeros)."""
    if trace is not None and (trace.device != state.device
                              or trace.dtype != torch.float32
                              or tuple(trace.shape) != (
                                  prob.max_iterations, TRACE_WIDTH)
                              or not trace.is_contiguous()):
        raise ValueError(f"trace must be contiguous float32 "
                         f"({prob.max_iterations}, {TRACE_WIDTH}) "
                         "on the state's device")
    if state.device.type == "cpu":
        loop_plain(state, prob, lambda st, cache: reg_stats_plain(
            st, prob, cache), chunk=chunk, trace=trace)
        return
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    if state.dtype != torch.float32 or state.shape != (STATE_LEN,) \
            or not state.is_contiguous():
        raise ValueError("the state must be contiguous float32 of STATE_LEN")
    dev = state.device
    planes = [_on(p, dev, torch.int32, "a fields plane") for p in prob.fields]
    if len({tuple(p.shape) for p in planes}) != 1 or planes[0].dim() != 3:
        raise ValueError("the fields planes must be 3-D and of one shape")
    X, Y, Z = planes[0].shape
    if tuple(prob.size) != (X, Y, Z):
        raise ValueError(f"fields {(X, Y, Z)} != window {tuple(prob.size)}")
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
    max_clusters(prob.layout)
    vs, gs = packed_shifts(prob.tau) if prob.layout != LAYOUT_PARITY \
        else (0, 0)
    ip = (ctypes.c_int * 15)(
        n, X, Y, Z, prob.resolution, prob.layout, vs, gs, int(prob.interp),
        int(prob.normalize), prob.coarse_iterations, int(prob.split),
        prob.max_iterations, int(prob.lm), int(prob.recenter))
    fp = (ctypes.c_float * 3)(prob.epsilon, prob.it_weight_gradient,
                              prob.freeze_step_mm ** 2)
    ptr = [p.data_ptr() for p in planes] + [None] * (3 - len(planes))
    cptr = [t.data_ptr() for t in cache] or [None] * 4
    rc = _lib().ws_reg_loop(
        state.data_ptr(), points.data_ptr(), mask.data_ptr(), *ptr,
        pos.data_ptr(), offset.data_ptr(), *cptr,
        None if trace is None else trace.data_ptr(),
        ctypes.cast(ip, _VP), ctypes.cast(fp, _VP),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "the registration loop kernel")
    reg_loop.launches += 1


reg_loop.launches = 0


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

