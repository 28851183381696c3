"""Ring-buffer local TSDF map as tensors plus its host shell.

Counterpart of ``warpsense_tpu/map/local_map.py``:

* the dense window is two int16 tensors (value, weight) of shape (X, Y, Z),
  sizes forced odd like the reference (src/map/hdf5_local_map.cpp:6-20);
* ring indexing ``array = (global - pos + offset) mod size`` is a pure
  function; the floor ``mod`` is ``torch.remainder``;
* ``shift`` evicts only the vacated slabs to the HDF5 global map and loads
  the newly visible ones.

Where the JAX package returns a new immutable state, the port updates the
value and weight tensors IN PLACE (the donated-buffer idiom of the JAX
functions becomes plain mutation here).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .global_map import GlobalMap
from .tsdf_entry import pack, unpack


class LocalMapState(NamedTuple):
    """Local-map state: int16 (value, weight) planes plus the ring origin."""
    value: torch.Tensor   # (X, Y, Z) int16 — TSDF value, mm
    weight: torch.Tensor  # (X, Y, Z) int16 — fixed-point weight
    pos: torch.Tensor     # (3,) int32 — global voxel coords of window center
    offset: torch.Tensor  # (3,) int32 — ring offset of the center cell


def make_odd(n: int) -> int:
    return n if n % 2 == 1 else n + 1


def create_state(size: tuple[int, int, int], default_value: int,
                 default_weight: int = 0, *, device="cpu",
                 force_odd: bool = True) -> LocalMapState:
    """A fresh window on ``device``; ``force_odd=False`` keeps even extents
    (an even axis spans [pos - s/2, pos + (s-1)/2])."""
    size = tuple((make_odd(int(s)) if force_odd else int(s)) for s in size)
    return LocalMapState(
        value=torch.full(size, default_value, dtype=torch.int16,
                         device=device),
        weight=torch.full(size, default_weight, dtype=torch.int16,
                          device=device),
        pos=torch.zeros((3,), dtype=torch.int32, device=device),
        offset=torch.tensor([s // 2 for s in size], dtype=torch.int32,
                            device=device),
    )


def clone_state(state: LocalMapState) -> LocalMapState:
    return LocalMapState(*(t.clone() for t in state))


# --------------------------------------------------------------- pure indexing

def _size_tensor(size, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(size, dtype=like.dtype, device=like.device)


def ring_coords(points, pos, offset, size):
    """Global voxel coords (..., 3) -> array coords (..., 3)."""
    return torch.remainder(points - pos + offset, _size_tensor(size, points))


def ring_index(points, pos, offset, size: tuple[int, int, int]):
    """Global voxel coords (..., 3) -> flat index into the (X,Y,Z) array."""
    a = ring_coords(points, pos, offset, size)
    return a[..., 0] * (size[1] * size[2]) + a[..., 1] * size[2] + a[..., 2]


def in_bounds(points, pos, size, buffer=0):
    """Per-point bool: inside the window, shrunk (buffer>0) or grown
    (buffer<0).  Floor convention for even axes, like the JAX function."""
    d = points - pos
    sz = _size_tensor(size, d)
    lo = -torch.div(sz, 2, rounding_mode="floor") + buffer
    hi = torch.div(sz - 1, 2, rounding_mode="floor") - buffer
    return torch.all((d >= lo) & (d <= hi), dim=-1)


# ------------------------------------------------------------- host-side shell

class LocalMap:
    """Host orchestration shell around a numpy LocalMapState + GlobalMap.

    Owns shift / write_back (host IO).  In device-backed mode (between
    ``attach_device`` and ``detach_device``) slab IO reads and writes the
    attached tensors directly and in place.
    """

    def __init__(self, size: tuple[int, int, int], global_map: GlobalMap,
                 force_odd: bool = True):
        self.size = tuple((make_odd(int(s)) if force_odd else int(s))
                          for s in size)
        self.global_map = global_map
        s = self.size
        self.state = LocalMapState(
            value=np.full(s, global_map.default_value, np.int16),
            weight=np.full(s, global_map.default_weight, np.int16),
            pos=np.zeros((3,), np.int32),
            offset=np.asarray([v // 2 for v in s], np.int32))
        self._dev: LocalMapState | None = None

    # -------------------------------------------------- device-backed mode
    def attach_device(self, state: LocalMapState,
                      x_rows: tuple[int, int] | None = None) -> None:
        """Enter device-backed mode: per shift only the evicted and loaded
        slabs move between device and host.  The attached ``state``'s value
        and weight tensors are updated IN PLACE by ``shift``; pass a clone
        to keep the caller's tensors unchanged.  While attached, the host
        numpy mirror is stale; ``detach_device`` returns the device state.

        ``x_rows`` (the multi-process slab scope) is not ported yet."""
        if x_rows is not None:
            raise NotImplementedError(
                "x_rows slab scoping is the multi-GPU layer (ROADMAP item 14)")
        self._dev = LocalMapState(
            value=state.value, weight=state.weight,
            pos=np.asarray(state.pos.cpu(), np.int32).copy(),
            offset=np.asarray(state.offset.cpu(), np.int32).copy())
        self.state.pos[:] = self._dev.pos
        self.state.offset[:] = self._dev.offset

    def detach_device(self) -> LocalMapState:
        dev = self._dev
        self._dev = None
        device = dev.value.device
        return LocalMapState(
            value=dev.value, weight=dev.weight,
            pos=torch.as_tensor(self.state.pos.copy(), device=device),
            offset=torch.as_tensor(self.state.offset.copy(), device=device))

    def _dev_slab_index(self, start, end):
        pos = self.state.pos.astype(np.int64)
        off = self.state.offset.astype(np.int64)
        device = self._dev.value.device
        axes = []
        for i in range(3):
            rng = np.arange(start[i], end[i] + 1, dtype=np.int64)
            axes.append(torch.as_tensor((rng - pos[i] + off[i])
                                        % self.size[i], device=device))
        return axes

    def _dev_gather(self, start, end):
        ax, ay, az = self._dev_slab_index(start, end)

        def take(t):
            return t.index_select(0, ax).index_select(1, ay).index_select(
                2, az).cpu().numpy()
        return take(self._dev.value), take(self._dev.weight)

    def _dev_scatter(self, start, end, v, w) -> None:
        """In-place write of a host slab into the attached tensors."""
        ax, ay, az = self._dev_slab_index(start, end)
        ix = (ax[:, None, None], ay[None, :, None], az[None, None, :])
        device = self._dev.value.device
        self._dev.value[ix] = torch.as_tensor(np.asarray(v, np.int16),
                                              device=device)
        self._dev.weight[ix] = torch.as_tensor(np.asarray(w, np.int16),
                                               device=device)

    # ------------------------------------------- host cell access (twins)
    def _coords(self, p: np.ndarray) -> np.ndarray:
        return (p - self.state.pos + self.state.offset) % np.asarray(self.size)

    def _in_bounds(self, p: np.ndarray) -> bool:
        return bool(np.all(np.abs(p - self.state.pos)
                           <= np.asarray(self.size) // 2))

    def value_at(self, p) -> tuple[int, int]:
        """(value, weight) of the host mirror at global voxel ``p``."""
        p = np.asarray(p, dtype=np.int64)
        if not self._in_bounds(p):
            raise IndexError(f"index out of local-map bounds: {p.tolist()}")
        a = self._coords(p)
        return (int(self.state.value[a[0], a[1], a[2]]),
                int(self.state.weight[a[0], a[1], a[2]]))

    def set_value_at(self, p, value: int, weight: int) -> None:
        p = np.asarray(p, dtype=np.int64)
        if not self._in_bounds(p):
            raise IndexError(f"index out of local-map bounds: {p.tolist()}")
        a = self._coords(p)
        self.state.value[a[0], a[1], a[2]] = np.int16(value)
        self.state.weight[a[0], a[1], a[2]] = np.int16(weight)

    # ------------------------------------------------------------------- shift
    def _area_array_index(self, start: np.ndarray, end: np.ndarray):
        """np.ix_ index of array coords covering the inclusive global box."""
        pos = np.asarray(self.state.pos)
        off = np.asarray(self.state.offset)
        axes = []
        for i in range(3):
            rng = np.arange(start[i], end[i] + 1, dtype=np.int64)
            axes.append(((rng - pos[i] + off[i]) % self.size[i])
                        .astype(np.int64))
        return np.ix_(*axes)

    def _save_area(self, start, end) -> None:
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        if self._dev is not None:
            v, w = self._dev_gather(start, end)
        else:
            ix = self._area_array_index(start, end)
            v, w = self.state.value[ix], self.state.weight[ix]
        self.global_map.write_area(start, pack(v, w))

    def _load_area(self, start, end) -> None:
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        v, w = unpack(self.global_map.read_area(start, end))
        if self._dev is not None:
            self._dev_scatter(start, end, v, w)
            return
        ix = self._area_array_index(start, end)
        self.state.value[ix] = v
        self.state.weight[ix] = w

    def shift(self, new_pos) -> None:
        """Re-center the window on ``new_pos`` (global voxel coords), axis
        by axis: save the vacated slab, advance pos/offset, load the newly
        visible slab (src/map/hdf5_local_map.cpp:53-118).  Moves beyond the
        window extent are walked in window-sized hops."""
        new_pos = np.asarray(new_pos, dtype=np.int64)
        size = np.asarray(self.size, dtype=np.int64)
        for axis in range(3):
            while int(new_pos[axis] - self.state.pos[axis]) != 0:
                full = int(new_pos[axis] - int(self.state.pos[axis]))
                diff = int(np.clip(full, -self.size[axis], self.size[axis]))
                self._shift_axis(axis, diff, size)

    def _shift_axis(self, axis: int, diff: int, size) -> None:
        """One axis hop (|diff| <= size[axis])."""
        pos = np.asarray(self.state.pos, dtype=np.int64)
        start = pos - size // 2
        end = pos + (size - 1) // 2
        if diff > 0:
            end[axis] = start[axis] + diff - 1
        else:
            start[axis] = end[axis] + diff + 1
        self._save_area(start, end)

        self.state.pos[axis] += diff
        self.state.offset[axis] = (self.state.offset[axis] + diff) \
            % self.size[axis]

        pos = np.asarray(self.state.pos, dtype=np.int64)
        start = pos - size // 2
        end = pos + (size - 1) // 2
        if diff > 0:
            start[axis] = end[axis] - (diff - 1)
        else:
            end[axis] = start[axis] - diff - 1
        self._load_area(start, end)

    def write_back(self) -> None:
        pos = np.asarray(self.state.pos, dtype=np.int64)
        size = np.asarray(self.size, dtype=np.int64)
        self._save_area(pos - size // 2, pos + (size - 1) // 2)
        self.global_map.write_back()

    def load_window(self, pos) -> None:
        """Center the window on ``pos`` and fill it from the global map (the
        resume path)."""
        pos = np.asarray(pos, dtype=np.int64)
        size = np.asarray(self.size, dtype=np.int64)
        self.state.pos[:] = pos.astype(np.int32)
        self.state.offset[:] = (size // 2).astype(np.int32)
        self._load_area(pos - size // 2, pos + (size - 1) // 2)

    # ----------------------------------------------------------- device bridge
    def device_state(self, device) -> LocalMapState:
        """Tensor copy of the host state on ``device``."""
        return LocalMapState(*(torch.as_tensor(x.copy(), device=device)
                               for x in self.state))

    def absorb(self, state: LocalMapState) -> None:
        """Copy a device state back into the host mirror."""
        self.state = LocalMapState(
            value=state.value.cpu().numpy().astype(np.int16, copy=True),
            weight=state.weight.cpu().numpy().astype(np.int16, copy=True),
            pos=state.pos.cpu().numpy().astype(np.int32, copy=True),
            offset=state.offset.cpu().numpy().astype(np.int32, copy=True),
        )
