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

    ``slab_copies``: how the HOST path (no device attached) copies slabs
    between the numpy window and the global map's staging buffers:
    ``"native"`` (the default; ``ws_ring_gather`` / ``ws_ring_scatter`` of
    native/native.cpp, built at first use, raises when it cannot be) or
    ``"numpy"`` (the numpy twin).  Both give the same bytes.

    ``evaluator``: an ``obs.profiler.RuntimeEvaluator`` that times the
    device-backed shift's phases (spans ``shift.gather``: the slab's
    index selects and copy to the host; ``shift.store``: ``pack`` and the
    global map's chunk writes; ``shift.load``: its chunk reads and
    ``unpack``; ``shift.scatter``: the copy to the device and the indexed
    write) and counts the bytes each way (``shift_bytes_d2h``,
    ``shift_bytes_h2d``), on whatever thread runs them; None records
    nothing.
    """

    def __init__(self, size: tuple[int, int, int], global_map: GlobalMap,
                 force_odd: bool = True, slab_copies: str = "native",
                 evaluator=None):
        if slab_copies not in ("native", "numpy"):
            raise ValueError(f"unknown slab_copies {slab_copies!r}")
        self.size = tuple((make_odd(int(s)) if force_odd else int(s))
                          for s in size)
        self.global_map = global_map
        self.slab_copies = slab_copies
        self.eval = evaluator
        s = self.size
        self.state = LocalMapState(
            value=np.full(s, global_map.default_value, np.int16),
            weight=np.full(s, global_map.default_weight, np.int16),
            pos=np.zeros((3,), np.int32),
            offset=np.asarray([v // 2 for v in s], np.int32))
        self._dev: LocalMapState | None = None
        self._x_scope: tuple[int, int] | None = None
        self._dev_row0 = 0          # array x-row of the attached row 0

    # -------------------------------------------------- device-backed mode
    def attach_device(self, state: LocalMapState,
                      x_rows: tuple[int, int] | None = None) -> None:
        """Enter device-backed mode: per shift only the evicted and loaded
        slabs move between device and host.  The attached ``state``'s value
        and weight tensors are updated IN PLACE by ``shift``; pass a clone
        to keep the caller's tensors unchanged.  While attached, the host
        numpy mirror is stale; ``detach_device`` returns the device state.

        ``x_rows=(lo, hi)``: restrict slab IO to ARRAY x-rows [lo, hi), the
        rows one rank of the multi-GPU layer owns
        (``parallel.distributed.host_slab_bounds``): each rank evicts, loads
        and persists only its own rows.  The attached tensors then hold
        either the whole window or exactly rows [lo, hi) (the rank's slab,
        ``parallel.sharded.shard_state``)."""
        rows = state.value.shape[0]
        if x_rows is not None:
            lo, hi = (int(x_rows[0]), int(x_rows[1]))
            if not 0 <= lo <= hi <= self.size[0]:
                raise ValueError(f"x_rows {x_rows} outside the window's "
                                 f"{self.size[0]} rows")
            if rows not in (self.size[0], hi - lo):
                raise ValueError(f"attached state has {rows} x-rows; x_rows "
                                 f"{x_rows} needs {hi - lo} or the whole "
                                 f"window's {self.size[0]}")
            self._x_scope = (lo, hi)
            self._dev_row0 = 0 if rows == self.size[0] else lo
        else:
            if rows != self.size[0]:
                raise ValueError(f"attached state has {rows} x-rows, the "
                                 f"window {self.size[0]}: pass x_rows")
            self._x_scope = None
            self._dev_row0 = 0
        self._dev = LocalMapState(
            value=state.value, weight=state.weight,
            pos=np.asarray(state.pos.cpu(), np.int32).copy(),
            offset=np.asarray(state.offset.cpu(), np.int32).copy())
        self.state.pos[:] = self._dev.pos
        self.state.offset[:] = self._dev.offset

    def detach_device(self) -> LocalMapState:
        dev = self._dev
        self._dev = None
        self._x_scope = None
        self._dev_row0 = 0
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
            a = (rng - pos[i] + off[i]) % self.size[i]
            if i == 0:
                a = a - self._dev_row0
            axes.append(torch.as_tensor(a, device=device))
        return axes

    def _dev_gather(self, start, end):
        prof = self.eval
        if prof:
            prof.start("shift.gather")
        ax, ay, az = self._dev_slab_index(start, end)

        def take(t):
            return t.index_select(0, ax).index_select(1, ay).index_select(
                2, az).cpu().numpy()
        v, w = take(self._dev.value), take(self._dev.weight)
        if prof:
            prof.stop("shift.gather")
            prof.count("shift_bytes_d2h", v.nbytes + w.nbytes)
        return v, w

    def _dev_scatter(self, start, end, v, w) -> None:
        """In-place write of a host slab into the attached tensors."""
        prof = self.eval
        if prof:
            prof.start("shift.scatter")
        ax, ay, az = self._dev_slab_index(start, end)
        ix = (ax[:, None, None], ay[None, :, None], az[None, None, :])
        device = self._dev.value.device
        v, w = np.asarray(v, np.int16), np.asarray(w, np.int16)
        # one slab on the device at a time: the peak stays one slab
        self._dev.value[ix] = torch.as_tensor(v, device=device)
        self._dev.weight[ix] = torch.as_tensor(w, device=device)
        if prof:
            prof.stop("shift.scatter")
            prof.count("shift_bytes_h2d", v.nbytes + w.nbytes)

    def _store_slab(self, start, v, w) -> None:
        """Pack a gathered slab and write it into the global map."""
        prof = self.eval
        if prof:
            prof.start("shift.store")
        self.global_map.write_area(np.asarray(start), pack(v, w))
        if prof:
            prof.stop("shift.store")

    def _load_slab(self, start, end):
        """Read a box of the global map and unpack it: (value, weight)."""
        prof = self.eval
        if prof:
            prof.start("shift.load")
        vw = unpack(self.global_map.read_area(start, end))
        if prof:
            prof.stop("shift.load")
        return vw

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

    def _native_args(self, start, end, raw):
        """ctypes arguments of ws_ring_gather / ws_ring_scatter over the
        host window; the last item keeps the temporaries alive."""
        import ctypes
        from ..native import load as load_native
        i16p = ctypes.POINTER(ctypes.c_int16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        for t in (self.state.value, self.state.weight):
            if not (t.flags.c_contiguous and t.dtype == np.int16):
                raise ValueError("host window must be contiguous int16")
        size = np.asarray(self.size, np.int32)
        pos = np.asarray(self.state.pos, np.int32)
        off = np.asarray(self.state.offset, np.int32)
        start = np.ascontiguousarray(start, np.int64)
        end = np.ascontiguousarray(end, np.int64)
        if raw.shape != tuple((end - start + 1).tolist()) or not (
                raw.flags.c_contiguous and raw.dtype == np.uint32):
            raise ValueError("slab buffer must be contiguous uint32 of the "
                             "box's shape")
        return load_native(), (
            self.state.value.ctypes.data_as(i16p),
            self.state.weight.ctypes.data_as(i16p),
            size.ctypes.data_as(i32p), pos.ctypes.data_as(i32p),
            off.ctypes.data_as(i32p), start.ctypes.data_as(i64p),
            end.ctypes.data_as(i64p), raw.ctypes.data_as(u32p)), (
            size, pos, off, start, end, raw)

    def _x_runs(self, start, end):
        """Split the global x range [start[0], end[0]] into runs whose
        ARRAY rows fall inside the x scope (ring-aware: a contiguous global
        range maps to at most a handful of scoped runs); one run covering
        everything when unscoped."""
        if self._x_scope is None:
            return [(int(start[0]), int(end[0]))]
        lo, hi = self._x_scope
        pos = int(self.state.pos[0])
        off = int(self.state.offset[0])
        X = self.size[0]
        runs, cur = [], None
        for gx in range(int(start[0]), int(end[0]) + 1):
            if lo <= (gx - pos + off) % X < hi:
                if cur is None:
                    cur = [gx, gx]
                else:
                    cur[1] = gx
            elif cur is not None:
                runs.append(tuple(cur))
                cur = None
        if cur is not None:
            runs.append(tuple(cur))
        return runs

    def _save_area(self, start, end) -> None:
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        for gx0, gx1 in self._x_runs(start, end):
            s, e = start.copy(), end.copy()
            s[0], e[0] = gx0, gx1
            self._save_area_run(s, e)

    def _save_area_run(self, start, end) -> None:
        if self._dev is not None:
            self._store_slab(start, *self._dev_gather(start, end))
            return
        if self.slab_copies == "native":
            raw = np.empty(tuple((end - start + 1).tolist()), np.uint32)
            lib, args, _keep = self._native_args(start, end, raw)
            lib.ws_ring_gather(*args)
            self.global_map.write_area(start, raw)
            return
        ix = self._area_array_index(start, end)
        self.global_map.write_area(
            start, pack(self.state.value[ix], self.state.weight[ix]))

    def _load_area(self, start, end) -> None:
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        for gx0, gx1 in self._x_runs(start, end):
            s, e = start.copy(), end.copy()
            s[0], e[0] = gx0, gx1
            self._load_area_run(s, e)

    def _load_area_run(self, start, end) -> None:
        if self._dev is not None:
            self._dev_scatter(start, end, *self._load_slab(start, end))
            return
        raw = self.global_map.read_area(start, end)
        if self.slab_copies == "native":
            raw = np.ascontiguousarray(raw, np.uint32)
            lib, args, _keep = self._native_args(start, end, raw)
            lib.ws_ring_scatter(*args)
            return
        v, w = unpack(raw)
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

    # -------------------------------------------- overlapped (staged) shift
    #
    # The staged shift keeps every device copy on the calling thread:
    #   begin_shift  (caller)  gather the evicted boxes off the device
    #   shift_io     (worker)  global-map writes and reads only
    #   finish_shift (caller)  advance pos/offset, scatter the loaded boxes
    # Array coords of a fixed global voxel do not change when pos and
    # offset advance together, so the interior O∩N never moves and the
    # evicted (O\N) and loaded (N\O) boxes are disjoint: the result equals
    # the axis-sequenced ``shift`` (hdf5_local_map.cpp:53-118).

    @staticmethod
    def _box_diff(a_start, a_end, b_start, b_end):
        """Disjoint inclusive boxes covering A \\ B (axis peeling)."""
        boxes = []
        cur_s = np.asarray(a_start, np.int64).copy()
        cur_e = np.asarray(a_end, np.int64).copy()
        for ax in range(3):
            if cur_e[ax] < b_start[ax] or cur_s[ax] > b_end[ax]:
                boxes.append((cur_s.copy(), cur_e.copy()))   # fully outside
                return boxes
            if cur_s[ax] < b_start[ax]:
                s, e = cur_s.copy(), cur_e.copy()
                e[ax] = b_start[ax] - 1
                boxes.append((s, e))
                cur_s[ax] = b_start[ax]
            if cur_e[ax] > b_end[ax]:
                s, e = cur_s.copy(), cur_e.copy()
                s[ax] = b_end[ax] + 1
                boxes.append((s, e))
                cur_e[ax] = b_end[ax]
        return boxes                      # remaining core lies inside B

    def begin_shift(self, new_pos) -> dict:
        """Phase 1/3 (the caller's thread, device attached without an
        x-row scope): gather the evicted boxes to host memory.  Returns the
        shift plan.  Exact at any distance: a move beyond the window evicts
        all of the old window and loads all of the new one."""
        if self._dev is None or self._x_scope is not None:
            raise RuntimeError("begin_shift needs attach_device without an "
                               "x-row scope (multi-rank shifts are "
                               "synchronous)")
        new_pos = np.asarray(new_pos, np.int64)
        pos = np.asarray(self.state.pos, np.int64)
        size = np.asarray(self.size, np.int64)
        o_s, o_e = pos - size // 2, pos + (size - 1) // 2
        n_s, n_e = new_pos - size // 2, new_pos + (size - 1) // 2
        evict = [(s, e) + self._dev_gather(s, e)
                 for s, e in self._box_diff(o_s, o_e, n_s, n_e)]
        return {"new_pos": new_pos, "evict": evict,
                "load_boxes": self._box_diff(n_s, n_e, o_s, o_e),
                "loaded": None}

    def shift_io(self, plan: dict) -> None:
        """Phase 2/3 (safe on a worker thread): global-map IO only."""
        for s, e, v, w in plan["evict"]:
            self._store_slab(s, v, w)
        plan["loaded"] = [(s, e) + self._load_slab(s, e)
                          for s, e in plan["load_boxes"]]

    def finish_shift(self, plan: dict) -> LocalMapState:
        """Phase 3/3 (the caller's thread): advance pos/offset, scatter the
        loaded boxes into the attached tensors (in place), detach."""
        size = np.asarray(self.size, np.int64)
        diff = plan["new_pos"] - np.asarray(self.state.pos, np.int64)
        self.state.pos[:] = plan["new_pos"].astype(np.int32)
        self.state.offset[:] = ((self.state.offset + diff) % size
                                ).astype(np.int32)
        for s, e, v, w in plan["loaded"]:
            self._dev_scatter(s, e, v, w)
        return self.detach_device()

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
