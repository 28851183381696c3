"""Process-group bring-up for the sharded SLAM layer.

Counterpart of ``warpsense_tpu/parallel/distributed.py``: initialize
``torch.distributed``, build this rank's ``Mesh`` and its slab of the
window, and gather slabs back.  A run of N processes (for example under
``torchrun --nproc-per-node N``) is N ranks, each with its own device:

    torchrun --nproc-per-node 4 -m warpsense_tpu_torch.parallel.distributed

One card cannot hold an NCCL group of two ranks (NCCL refuses two ranks on
one device), so two ranks on one GPU use gloo:

    torchrun --nproc-per-node 2 -m warpsense_tpu_torch.parallel.distributed \\
        --backend gloo --device cuda:0

A single process with nothing configured is a world of one:
``init_distributed`` does nothing and ``global_mesh`` has no group.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..map.local_map import LocalMapState
from .sharded import Mesh, gather_rows, make_mesh, shard_state, slab_rows


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str = "nccl") -> bool:
    """Initialize the default process group from the arguments, else from
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` (what torchrun
    sets).  ``coordinator_address``: "host:port" (TCP rendezvous) or an
    init-method URL ("file:///path").  A world of one with no address
    does nothing and returns False; otherwise returns True.  ``backend``
    is the group's ("nccl" across GPUs, "gloo" for CPU ranks or several
    ranks on one GPU)."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        if num_processes == 1:
            return False
        raise ValueError(f"a {num_processes}-process run needs a "
                         "coordinator address (or MASTER_ADDR)")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return True


def global_mesh(device="cuda") -> Mesh:
    """This rank's mesh over the default group (every rank of the job) on
    ``device``."""
    return make_mesh(device)


def shard_state_global(state: LocalMapState, mesh: Mesh) -> LocalMapState:
    """This rank's slab of a whole-window state (``sharded.shard_state``;
    every rank builds the same whole window and keeps its rows)."""
    return shard_state(state, mesh)


def host_slab_bounds(mesh: Mesh, size: tuple[int, int, int]
                     ) -> tuple[int, int]:
    """[x0, x1): the array x-rows this rank owns, whose slab IO (shift
    eviction and load, persistence) it performs."""
    return slab_rows(mesh, size[0])


def gather_state(state: LocalMapState, mesh: Mesh,
                 dst: int | None = None) -> LocalMapState | None:
    """The whole window as numpy on every rank (``dst=None``) or on rank
    ``dst`` only (the others get None); every rank must call it."""
    value = gather_rows(state.value, mesh).numpy()
    weight = gather_rows(state.weight, mesh).numpy()
    if dst is not None and mesh.rank != dst:
        return None
    return LocalMapState(value=value, weight=weight,
                         pos=state.pos.cpu().numpy(),
                         offset=state.offset.cpu().numpy())


# ------------------------------------------------------------ runnable entry

def _demo_cloud(n: int, half: int, zhalf: int, seed: int = 7) -> np.ndarray:
    """Deterministic box-room cloud (int32 mm), identical on every rank."""
    from ..io.synthetic import box_room_cloud
    return box_room_cloud(n, half, zhalf, seed=seed)


def run_demo(mesh: Mesh, size=(80, 41, 41)) -> tuple[dict, LocalMapState,
                                                     np.ndarray]:
    """One sharded fusion + packed registration step on the demo cloud:
    (report, gathered whole-window state, pose).  Every rank must call
    it."""
    from ..core.consts import WEIGHT_RESOLUTION
    from ..map.local_map import create_state
    from .sharded import (precompute_fields_packed_sharded,
                          register_cloud_packed_sharded,
                          tsdf_update_projective_sharded)

    size = tuple(size)
    TAU, RES = 600, 64
    dev = mesh.device
    state = shard_state(create_state(size, TAU, 0, force_odd=False), mesh)
    pts = torch.as_tensor(_demo_cloud(3000, half=1100, zhalf=350),
                          device=dev)
    mask = torch.ones((pts.shape[0],), dtype=torch.bool, device=dev)
    tsdf_update_projective_sharded(
        state, pts, mask, torch.zeros(3, dtype=torch.int32, device=dev),
        torch.eye(3, dtype=torch.float32), mesh=mesh, size=size, tau=TAU,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=RES, channels=32,
        columns=128, vfov_deg=45.0, level=True)
    fields = precompute_fields_packed_sharded(state, mesh=mesh, tau=TAU)
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = [90, -60, 40]
    pose, iters, _err = register_cloud_packed_sharded(
        fields, state.pos, state.offset, pts, mask,
        torch.as_tensor(pert, device=dev), mesh=mesh, size=size,
        resolution=RES, tau=TAU, max_iterations=30, epsilon=0.03,
        gather_freeze=True)
    full = gather_state(state, mesh)
    pose = pose.cpu().numpy()
    report = {
        "rank": mesh.rank, "world": mesh.world, "device": str(dev),
        "backend": (None if mesh.group is None
                    else dist.get_backend(mesh.group)),
        "slab": list(host_slab_bounds(mesh, size)),
        "pose": pose.tolist(), "iters": int(iters),
        "weight_nonzero": int((full.weight != 0).sum()),
        "value_sum": int(np.asarray(full.value, np.int64).sum()),
    }
    return report, full, pose


def main(argv=None) -> dict:
    """Demo and check of the multi-GPU layer: bring up the process group,
    run one sharded fusion + packed registration step on a deterministic
    box-room cloud, and print one JSON line per rank with its slab, the
    registered pose and checksums of the gathered window (the same on
    every rank and equal to a world of one's)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--coordinator", default=None,
                    help="host:port or an init-method URL (default: "
                         "MASTER_ADDR/MASTER_PORT, as torchrun sets)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--device", default=None,
                    help="this rank's device (default cuda:LOCAL_RANK)")
    ap.add_argument("--size", type=int, nargs=3, default=[80, 41, 41])
    ap.add_argument("--out", default=None,
                    help="rank 0 writes value/weight/pose here (.npz)")
    args = ap.parse_args(argv)

    device = args.device or f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     backend=args.backend)
    try:
        mesh = global_mesh(device)
        report, full, pose = run_demo(mesh, args.size)
        print(json.dumps(report), flush=True)
        if args.out and mesh.rank == 0:
            np.savez(args.out, value=full.value, weight=full.weight,
                     pose=pose)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return report


if __name__ == "__main__":
    main()
