"""Multi-GPU sharding of the TSDF window and the SLAM step over a
``torch.distributed`` process group.

Counterpart of ``warpsense_tpu/parallel/sharded.py`` (the reference is
single-GPU; this layer is new capability).  Each rank of the group is one
process that owns one device and one x-slab of the window:

* the window (value, weight) is block-split along its ARRAY x-axis: rank r
  holds rows [r X/n, (r+1) X/n) as (X/n, Y, Z) int16 tensors on its
  device; ``pos`` and ``offset`` are replicated, so the ring index math is
  unchanged;
* **fusion**: every rank builds the beam table (or marches every ray) from
  the whole cloud and sweeps or scatters into its own slab only: kernel K1
  per slab for the projective update, with no communication;
* **fields**: the +-1-voxel gradient stencil crosses slab boundaries, so
  each rank sends its first and last YZ-planes to its ring neighbours
  (rank 0's left neighbour is rank n-1: the window is a torus) and runs
  kernel K2 on its slab padded with the two halo planes;
* **registration** (``run_registration_sharded``): the loop's carry lives
  on every rank's device, the same bits on each.  An iteration is one
  launch of ``shard_iter_kernel``: K4 of the iteration before on the
  ranks' rows, gathered in rank order (summed in one fixed order, so every
  rank's solve, stop test and pose update see the same bits with nothing
  broadcast: an all-reduce's order depends on the algorithm and the
  backend), then K3 on the points whose cells the rank owns, a row of
  statistics a CTA; then the rows' all-gather.  The host enqueues
  ``CHUNK`` iterations and then reads the carry's header once; over NCCL
  and without a group the chunk is a CUDA graph, captured once per kind
  of registration and replayed;
* the backend is the group's: with NCCL halos and rows stay on the device
  and the collective runs in the stream; with gloo (which moves CPU
  tensors) they pass through host memory, one copy each way an iteration
  for the rows, and the chunk is a host loop.

A ``Mesh`` without a group is a world of one (no collectives): the whole
window on one device.  Keep the JAX names; the functions take the same
arguments plus ``mesh``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..map.local_map import LocalMapState
from ..ops.registration import (CHUNK, LAYOUT_EXACT, LAYOUT_PACKED,
                                LAYOUT_PARITY, S_ACC, S_ERR, S_FIN, S_HEAD,
                                S_I, S_TRIAL, STATE_LEN, PackedFields,
                                PackedFields2, RegistrationFields, RegProblem,
                                count_registration, init_state, stopped)
from ..ops.tsdf import tsdf_update
from ..ops.tsdf_projective import tsdf_update_projective
from ..utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the x-sharded layout.  ``loops``: this mesh's
    sharded registration loops by kind (their buffers and captured chunks,
    ``_Loop``), kept from one registration to the next; every mesh,
    ``dataclasses.replace``'s too, starts with none."""
    group: object | None     # torch.distributed ProcessGroup; None: no group
    rank: int
    world: int
    device: torch.device
    loops: dict = field(default_factory=dict, init=False, repr=False,
                        compare=False)


def make_mesh(device="cuda", group=None) -> Mesh:
    """This process's ``Mesh`` over ``group`` (default: the initialized
    default group; a world of one when none is initialized), with its own
    ``loops``."""
    device = resolve_device(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 0, 1, device)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                device)


def slab_rows(mesh: Mesh, X: int) -> tuple[int, int]:
    """[lo, hi): the array x-rows this rank owns."""
    if X % mesh.world:
        raise ValueError(f"window x extent {X} must divide the "
                         f"{mesh.world}-rank mesh")
    xs = X // mesh.world
    return mesh.rank * xs, (mesh.rank + 1) * xs


def shard_state(state: LocalMapState, mesh: Mesh) -> LocalMapState:
    """This rank's slab of a whole-window state (numpy arrays or tensors on
    any device), copied to ``mesh.device``; pos/offset replicated."""
    lo, hi = slab_rows(mesh, state.value.shape[0])

    def slab(t):
        t = torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t)
        return t[lo:hi].to(device=mesh.device, dtype=torch.int16,
                           copy=True).contiguous()

    def rep(t):
        t = torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t)
        return t.to(device=mesh.device, dtype=torch.int32, copy=True)

    return LocalMapState(value=slab(state.value), weight=slab(state.weight),
                         pos=rep(state.pos), offset=rep(state.offset))


# ------------------------------------------------------------- collectives

def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the group's backend can move it: host memory for gloo
    (which moves CPU tensors), the device otherwise."""
    if dist.get_backend(mesh.group) == "gloo":
        return t.cpu()
    return t


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as uint8 (neither gloo nor NCCL moves
    int16); ``.view(dtype)`` restores it."""
    return t.contiguous().view(torch.uint8)


def _peer(mesh: Mesh, rank: int) -> int:
    return dist.get_global_rank(mesh.group, rank)


def _halo_exchange_x(blocks: list[torch.Tensor], mesh: Mesh
                     ) -> list[torch.Tensor]:
    """Each (Xs, Y, Z) block of this rank -> (Xs+2, Y, Z), a fresh
    contiguous tensor with its ring-neighbour halos: the last plane of the
    left neighbour and the first plane of the right one.  The blocks share
    one dtype and travel in one pair of messages each way."""
    if mesh.world == 1:
        return [torch.cat([b[-1:], b, b[:1]]) for b in blocks]
    dev, dtype = blocks[0].device, blocks[0].dtype
    to_right = _wire(mesh, _bytes(torch.stack([b[-1] for b in blocks])))
    to_left = _wire(mesh, _bytes(torch.stack([b[0] for b in blocks])))
    from_left = torch.empty_like(to_right)
    from_right = torch.empty_like(to_left)
    left = _peer(mesh, (mesh.rank - 1) % mesh.world)
    right = _peer(mesh, (mesh.rank + 1) % mesh.world)
    # the tags tell the two messages apart at a world of two, where both
    # neighbours are one rank; NCCL matches them in this same order
    ops = [dist.P2POp(dist.isend, to_right, right, mesh.group, tag=0),
           dist.P2POp(dist.isend, to_left, left, mesh.group, tag=1),
           dist.P2POp(dist.irecv, from_left, left, mesh.group, tag=0),
           dist.P2POp(dist.irecv, from_right, right, mesh.group, tag=1)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    from_left = from_left.to(dev).view(dtype)
    from_right = from_right.to(dev).view(dtype)
    return [torch.cat([from_left[i:i + 1], b, from_right[i:i + 1]])
            for i, b in enumerate(blocks)]


def _padded(state: LocalMapState, mesh: Mesh) -> LocalMapState:
    """The rank's slab with its two halo planes (value and weight fresh
    tensors, so they share K2's 16-byte alignment)."""
    value, weight = _halo_exchange_x([state.value, state.weight], mesh)
    return LocalMapState(value=value, weight=weight, pos=state.pos,
                         offset=state.offset)


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (Xs, ...) block concatenated along x in rank order, on
    the host of every rank."""
    if mesh.group is None:
        return t.cpu()
    x = _wire(mesh, _bytes(t))
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat([p.cpu() for p in parts]).view(t.dtype)


def any_rank(mesh: Mesh, flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any rank: one all-reduce
    (MAX) of one integer (in host memory for gloo; on the device for NCCL,
    whose read syncs); ``flag`` itself without a group."""
    if mesh.group is None:
        return bool(flag)
    dev = "cpu" if dist.get_backend(mesh.group) == "gloo" else mesh.device
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def rows_gather(mesh: Mesh, bufs):
    """``gather(q)``: the collective that fills slot q of ``bufs.rows_all``
    with every rank's slot q of ``bufs.rows``, rank-major.  Without a group
    the rows are their own gathered rows and there is none; with NCCL one
    all-gather on the device in the current stream; with gloo through host
    memory (on the card a copy each way, so a sync an iteration)."""
    if mesh.group is None:
        return lambda q: None
    rows, rows_all = bufs.rows, bufs.rows_all
    if dist.get_backend(mesh.group) != "gloo":
        return lambda q: dist.all_gather_into_tensor(
            rows_all[q], rows[q], group=mesh.group)
    cpu = rows.device.type == "cpu"
    host = rows_all if cpu else torch.empty(rows_all.shape,
                                            dtype=rows_all.dtype)
    parts = [list(host[q].chunk(mesh.world)) for q in (0, 1)]
    if cpu:
        return lambda q: dist.all_gather(parts[q], rows[q], group=mesh.group)

    def gather(q):
        dist.all_gather(parts[q], rows[q].cpu(), group=mesh.group)
        rows_all[q].copy_(host[q])
    return gather


class _Loop:
    """One kind of sharded registration (a mesh's device, a layout, a
    chunk size): its buffers, its collective, whether one registration ran
    (the warm-up before a capture) and its captured chunk."""

    def __init__(self, mesh: Mesh, device, graphable: bool):
        from ..kernels.registration import shard_buffers
        self.bufs = shard_buffers(device, mesh.world,
                                  shared=mesh.group is None)
        self.gather = rows_gather(mesh, self.bufs)
        self.graphable = graphable
        self.warm = False
        self.graph = None


def _loop(mesh: Mesh, prob: RegProblem, device, chunk: int) -> _Loop:
    """The ``_Loop`` of this kind of registration in ``mesh.loops``, made
    at its first one.  Its chunk is captured on the card with NCCL or no
    group, and an even ``chunk`` (the carry ends where it starts, in slot
    0); gloo's rows pass through host memory, which a graph cannot
    capture, so its chunk stays a host loop (the backend's name
    decides), as does an odd chunk."""
    device = torch.device(device)
    key = (device, prob.layout, chunk)
    if key not in mesh.loops:
        graphable = device.type == "cuda" and chunk % 2 == 0 and (
            mesh.group is None or dist.get_backend(mesh.group) == "nccl")
        mesh.loops[key] = _Loop(mesh, device, graphable)
    return mesh.loops[key]


def run_registration_sharded(prob: RegProblem, pretransform, mesh: Mesh, *,
                             chunk: int = CHUNK, trace=None):
    """One registration of ``prob`` (the rank's slab: ``x_lo``,
    ``x_rows``) on every rank of ``mesh``; returns (final state, its
    header as a list of floats), the same bits on every rank.

    The carry starts from ``init_state`` in slot 0 of the kind's carry on
    the device of ``prob.points``.  Then, ``chunk`` iterations at a time:
    the fused iteration (``kernels.registration.shard_iter``: the step on
    the rows gathered last, then this rank's statistics), the ranks' rows
    gathered in rank order; then one read of the header, counted in
    ``run_registration.syncs`` (a CUDA state) and ``calls``.  On the card
    the iteration is a kernel, launched whether or not the carry has
    finished (it returns at once on a finished one; a build, launch or
    capture failure raises).  The first registration of a kind launches
    from the host; from the second on, where ``_loop`` lets it, the chunk
    is its captured CUDA graph, replayed.  On the CPU the plain version,
    one row a rank, and a chunk ends where the loop does.  ``trace``: as
    ``shard_plan`` takes it."""
    from ..kernels.registration import (capture_chunk, replay_chunk,
                                        shard_iter, shard_plan)
    t0 = time.perf_counter()
    dev = prob.points.device
    loop = _loop(mesh, prob, dev, chunk)
    carry = loop.bufs.carry
    cuda = carry.is_cuda
    # every registration starts at parity 0: slot 0 whole (PENDING clear);
    # the first launch writes all of slot 1 that a launch reads
    init_state(prob, pretransform, dev, out=carry[0])
    plan = shard_plan(loop.bufs, prob, trace=trace)
    replay = loop.graphable and loop.warm
    if replay and loop.graph is None:
        loop.graph = capture_chunk(plan, loop.gather, chunk)
    parity = reads = 0
    while True:
        if replay:
            replay_chunk(loop.graph, chunk)
        else:
            for _ in range(chunk):
                if not cuda and stopped(carry[parity, :STATE_LEN], prob):
                    break
                shard_iter(plan, parity)
                loop.gather(1 - parity)
                parity ^= 1
        head = carry[parity, :S_HEAD].tolist()
        reads += 1
        if head[S_FIN] != 0 or head[S_I] >= prob.max_iterations:
            break
    loop.warm = True
    count_registration(head, reads if cuda else 0, t0)
    return carry[parity, :STATE_LEN].clone(), head


def _slab_problem(mesh: Mesh, size, **kw) -> RegProblem:
    lo, hi = slab_rows(mesh, size[0])
    return RegProblem(size=tuple(size), x_lo=lo, x_rows=hi - lo, **kw)


# ------------------------------------------------------------ parity mode

def register_cloud_sharded(state: LocalMapState, points, mask, pretransform,
                           *, mesh: Mesh, size, resolution, max_iterations,
                           it_weight_gradient, epsilon,
                           mode: str = "parity") -> torch.Tensor:
    """Sharded Gauss-Newton registration: the contract of
    ``ops.registration.register_cloud`` with the map x-sharded.  The
    parity fields are computed on the rank's slab padded with its halo
    planes (kernel K2's parity mode, its plain version on the CPU: the
    x wrap of the padded slab is the window's); the loop is
    ``run_registration_sharded``.  The refined 4x4 pose (on
    ``mesh.device``) is the same on every rank."""
    from ..kernels.fields import fields_parity
    padded = fields_parity(_padded(state, mesh))
    prob = _slab_problem(
        mesh, size, fields=RegistrationFields(*(p[1:-1] for p in padded)),
        pos=state.pos, offset=state.offset, points=points, mask=mask,
        resolution=resolution, tau=0, layout=LAYOUT_PARITY, interp=False,
        normalize=mode == "fast", lm=False, recenter=mode == "fast",
        coarse_iterations=0, split=False, max_iterations=max_iterations,
        epsilon=epsilon, it_weight_gradient=it_weight_gradient,
        freeze_step_mm=0.0)
    st, _ = run_registration_sharded(prob, pretransform, mesh)
    return st[S_TRIAL:S_TRIAL + 16].reshape(4, 4).to(mesh.device)


def tsdf_update_sharded(state: LocalMapState, points, points_mask,
                        scanner_pos, up, *, mesh: Mesh, size, tau, max_weight,
                        resolution, max_steps, max_isteps, channels: int = 128,
                        vfov_deg: float = 45.0) -> LocalMapState:
    """Sharded ray-march fusion, in place on the rank's slab: the march is
    replicated over points and the scatter-min and merge touch only the
    rank's rows."""
    return tsdf_update(state, points, points_mask, scanner_pos, up,
                       size=size, tau=tau, max_weight=max_weight,
                       resolution=resolution, max_steps=max_steps,
                       max_isteps=max_isteps, channels=channels,
                       vfov_deg=vfov_deg,
                       x_rows=slab_rows(mesh, size[0]))


# -------------------------------------------------------------- fast mode

def precompute_fields_packed_sharded(state: LocalMapState, *, mesh: Mesh,
                                     tau: int, exact: bool = False):
    """Sharded ``precompute_fields_packed[2]``: kernel K2 (its plain
    version on the CPU) on the rank's slab padded with its two halo
    planes, outer output planes dropped.  The stencil reaches +-1 in x and
    wraps only in y and z inside a plane, so the kept planes are the
    single-window planes of the rank's rows, bit for bit."""
    from ..kernels.fields import fields_packed
    f = fields_packed(_padded(state, mesh), tau=tau, exact=exact)
    if exact:
        return PackedFields2(plane_a=f.plane_a[1:-1], plane_b=f.plane_b[1:-1])
    return PackedFields(plane=f.plane[1:-1])


def register_cloud_packed_sharded(fields, pos, offset, points, mask,
                                  pretransform, *, mesh: Mesh, size,
                                  resolution: int, tau: int,
                                  max_iterations: int, epsilon: float,
                                  interp: bool = True,
                                  gather_freeze: bool = False):
    """Sharded ``register_cloud_packed`` over the rank's packed or exact
    slab fields: returns ``(pose, iterations, err)``, the same on every
    rank (the pose on ``mesh.device``).  Each rank sums only the points
    whose cells it owns (src/warpsense/cuda/registration.cu:14-257 scaled
    out); the loop is ``run_registration_sharded``."""
    prob = _slab_problem(
        mesh, size, fields=fields, pos=pos, offset=offset, points=points,
        mask=mask, resolution=resolution, tau=tau,
        layout=LAYOUT_EXACT if isinstance(fields, PackedFields2)
        else LAYOUT_PACKED, interp=interp, normalize=False, lm=True,
        recenter=True, coarse_iterations=0, split=gather_freeze,
        max_iterations=max_iterations, epsilon=epsilon,
        it_weight_gradient=0.0, freeze_step_mm=float(resolution))
    st, head = run_registration_sharded(prob, pretransform, mesh)
    return (st[S_ACC:S_ACC + 16].reshape(4, 4).to(mesh.device),
            int(head[S_I]), head[S_ERR])


def tsdf_update_projective_sharded(
        state: LocalMapState, points, points_mask, scanner_pos, rotation, *,
        mesh: Mesh, size, tau, max_weight, resolution, channels: int = 128,
        columns: int = 1024, vfov_deg: float = 45.0,
        level: bool = False) -> LocalMapState:
    """Sharded ``tsdf_update_projective``, in place on the rank's slab: the
    beam table is built from the whole cloud on every rank; kernel K1 (its
    plain version on the CPU) sweeps the rank's rows, given by their own
    scanner-relative x coordinates, with no communication: the same update
    with the slab's ``x_rows``.  ``level=True`` runs K1's level sweep
    (identity rotation); otherwise K1's general sweep bins with
    ``rotation`` (the JAX function runs its XLA sweep there)."""
    return tsdf_update_projective(
        state, points, points_mask, scanner_pos, rotation, size=size,
        tau=tau, max_weight=max_weight, resolution=resolution,
        channels=channels, columns=columns, vfov_deg=vfov_deg, level=level,
        x_rows=slab_rows(mesh, size[0]))


def slam_step_sharded(state: LocalMapState, points, mask, pretransform, *,
                      mesh: Mesh, params, size, max_steps=None,
                      max_isteps=None, scanner_pos=None, up=None,
                      mode: str = "parity", capture_pose=None):
    """One SLAM step (fusion, then registration) on the mesh; returns
    ``(state, pose)``.

    ``mode="fast"``: projective fusion (level grid inside the tilt
    envelope of ``capture_pose``, the sensor attitude beyond it; a level
    platform when ``capture_pose`` is None), packed fields and the LM
    registration.  ``"parity"``: the ray march and Gauss-Newton."""
    m = params.map
    if mode == "fast":
        from ..pipeline.fusion_backend import grid_rotation_for
        if capture_pose is None:
            grid_rot, level = torch.eye(3, dtype=torch.float32), True
        else:
            grid_rot, level = grid_rotation_for(np.asarray(capture_pose),
                                                params.lidar.vfov)
        tsdf_update_projective_sharded(
            state, points, mask, scanner_pos, grid_rot, mesh=mesh,
            size=size, tau=m.tau, max_weight=m.max_weight_scaled,
            resolution=m.resolution, channels=params.lidar.channels,
            columns=params.lidar.hresolution, vfov_deg=params.lidar.vfov,
            level=level)
        fields = precompute_fields_packed_sharded(state, mesh=mesh, tau=m.tau)
        pose, _iters, _err = register_cloud_packed_sharded(
            fields, state.pos, state.offset, points, mask, pretransform,
            mesh=mesh, size=size, resolution=m.resolution, tau=m.tau,
            max_iterations=params.registration.max_iterations,
            epsilon=params.registration.epsilon,
            gather_freeze=params.registration.gather_freeze)
        return state, pose
    tsdf_update_sharded(
        state, points, mask, scanner_pos, up, mesh=mesh, size=size,
        tau=m.tau, max_weight=m.max_weight_scaled, resolution=m.resolution,
        max_steps=max_steps, max_isteps=max_isteps,
        channels=params.lidar.channels, vfov_deg=params.lidar.vfov)
    pose = register_cloud_sharded(
        state, points, mask, pretransform, mesh=mesh, size=size,
        resolution=m.resolution,
        max_iterations=params.registration.max_iterations,
        it_weight_gradient=params.registration.it_weight_gradient,
        epsilon=params.registration.epsilon, mode=mode)
    return state, pose
