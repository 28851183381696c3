"""Persistent chunked global TSDF map (HDF5).

Same on-disk schema as the reference so existing tooling (LVR2 meshing etc.)
keeps working — src/map/hdf5_global_map.cpp and
include/map/hdf5_constants.h:
* group ``/map``   — one uint32 dataset per 64^3 chunk, named ``x_y_z``
  (chunk coordinates), C-order index ``x*CS^2 + y*CS + z``;
  meta attributes tau / map_size_* / max_distance / map_resolution /
  max_weight on the group.
* group ``/poses`` — one subgroup per pose (``/poses/<n>/pose``), a 7-float
  dataset ``[tx, ty, tz, qx, qy, qz, qw]`` rounded to 3 decimals.

Improvements over the reference (documented capability deltas):
* ``truncate=False`` reopens an existing map — true resume, which the
  reference cannot do (it always opens with Truncate,
  hdf5_global_map.cpp:5).
* chunk IO is vectorized numpy instead of per-cell loops.

``path=None`` keeps the same groups, datasets and attributes in memory
(``_MemoryFile``) for machines without h5py; nothing is persisted then.
``evaluator``: an ``obs.profiler.RuntimeEvaluator`` that counts the chunks
the LRU did not hold (``chunk_miss``; once it is full each also evicts
one); None counts nothing.
"""
from __future__ import annotations

import threading
from pathlib import Path

import numpy as np

from .tsdf_entry import pack

CHUNK_SIZE = 64
NUM_ACTIVE_CHUNKS = 64  # LRU capacity, parity hdf5_global_map.h

MAP_GROUP = "/map"
POSES_GROUP = "/poses"
POSE_DATASET = "pose"
POSE_SIZE = 7


def tag_from_chunk_pos(pos) -> str:
    return f"{int(pos[0])}_{int(pos[1])}_{int(pos[2])}"


class _MemoryGroup(dict):
    """The subset of an h5py group that GlobalMap uses, held in memory."""

    def __init__(self):
        super().__init__()
        self.attrs: dict = {}

    def require_group(self, name: str) -> "_MemoryGroup":
        return self.setdefault(name, _MemoryGroup())

    def create_group(self, name: str) -> "_MemoryGroup":
        if name in self:
            raise ValueError(f"group {name!r} exists")
        self[name] = _MemoryGroup()
        return self[name]

    def create_dataset(self, name: str, data, dtype=None):
        self[name] = np.array(data, dtype=dtype)
        return self[name]


class _MemoryFile(_MemoryGroup):
    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class GlobalMap:
    def __init__(self, path: str | Path | None, default_value: int,
                 default_weight: int = 0, truncate: bool = True,
                 meta: dict | None = None, evaluator=None):
        if path is None:
            self.path = None
            self._f = _MemoryFile()
        else:
            import h5py

            self.path = Path(path)
            mode = "w" if truncate or not self.path.exists() else "a"
            self._f = h5py.File(self.path, mode)
        # ONE lock around every h5py access + the LRU dict: the async
        # map-shift worker calls write_area/read_area while the main
        # thread writes poses every scan — h5py releases the GIL around
        # HDF5 IO, and two threads inside the (non-threadsafe) library
        # deadlock it (measured: a shift worker hung mid-corridor, the
        # fusion queue starved the map, and the pose flew off unmapped
        # terrain).  Coarse by design: uncontended in the common path.
        self._lock = threading.RLock()
        self.eval = evaluator
        self.default_value = int(default_value)
        self.default_weight = int(default_weight)
        self._map = self._f.require_group(MAP_GROUP[1:])
        self._poses = self._f.require_group(POSES_GROUP[1:])
        self._num_poses = len(self._poses)
        # LRU: chunk_pos tuple -> np.uint32[CS^3]; dict preserves insertion
        # order, move_to_end semantics implemented manually.
        self._active: dict[tuple[int, int, int], np.ndarray] = {}
        if meta:
            self.write_meta(meta)

    # ------------------------------------------------------------------ chunks
    def _default_chunk(self) -> np.ndarray:
        raw = pack(np.int16(self.default_value), np.int16(self.default_weight))
        return np.full(CHUNK_SIZE ** 3, raw, dtype=np.uint32)

    def activate_chunk(self, chunk_pos) -> np.ndarray:
        """Return the chunk's raw uint32 buffer, loading / LRU-evicting as
        needed (parity hdf5_global_map.cpp:59-137)."""
        with self._lock:
            key = (int(chunk_pos[0]), int(chunk_pos[1]), int(chunk_pos[2]))
            if key in self._active:
                chunk = self._active.pop(key)
                self._active[key] = chunk  # refresh recency
                return chunk
            if self.eval:
                self.eval.count("chunk_miss")
            tag = tag_from_chunk_pos(key)
            if tag in self._map:
                chunk = np.asarray(self._map[tag][...],
                                   dtype=np.uint32).reshape(-1)
            else:
                chunk = self._default_chunk()
            if len(self._active) >= NUM_ACTIVE_CHUNKS:
                old_key, old_chunk = next(iter(self._active.items()))
                del self._active[old_key]
                self._store(old_key, old_chunk)
            self._active[key] = chunk
            return chunk

    def _store(self, key, chunk: np.ndarray) -> None:
        tag = tag_from_chunk_pos(key)
        if tag in self._map:
            self._map[tag][...] = chunk
        else:
            self._map.create_dataset(tag, data=chunk, dtype=np.uint32)

    def get_value_raw(self, pos) -> int:
        pos = np.asarray(pos, dtype=np.int64)
        chunk_pos = np.floor_divide(pos, CHUNK_SIZE)
        chunk = self.activate_chunk(chunk_pos)
        local = pos - chunk_pos * CHUNK_SIZE
        idx = int(local[0]) * CHUNK_SIZE * CHUNK_SIZE + int(local[1]) * CHUNK_SIZE + int(local[2])
        return int(chunk[idx])

    def set_value_raw(self, pos, raw: int) -> None:
        pos = np.asarray(pos, dtype=np.int64)
        chunk_pos = np.floor_divide(pos, CHUNK_SIZE)
        chunk = self.activate_chunk(chunk_pos)
        local = pos - chunk_pos * CHUNK_SIZE
        idx = int(local[0]) * CHUNK_SIZE * CHUNK_SIZE + int(local[1]) * CHUNK_SIZE + int(local[2])
        chunk[idx] = np.uint32(raw)

    # --------------------------------------------------------------- bulk area
    def read_area(self, start, end) -> np.ndarray:
        """Raw uint32 block for the inclusive global-coordinate box
        [start, end] — vectorized per-chunk copies."""
        start = np.asarray(start, dtype=np.int64)
        end = np.asarray(end, dtype=np.int64)
        shape = tuple((end - start + 1).tolist())
        out = np.empty(shape, dtype=np.uint32)
        self._for_each_chunk(start, end, out, save=False)
        return out

    def write_area(self, start, block: np.ndarray) -> None:
        """Write a raw uint32 block with its minimum corner at ``start``."""
        start = np.asarray(start, dtype=np.int64)
        end = start + np.asarray(block.shape, dtype=np.int64) - 1
        self._for_each_chunk(start, end, np.ascontiguousarray(block), save=True)

    def _for_each_chunk(self, start, end, block: np.ndarray, save: bool) -> None:
        cs = CHUNK_SIZE
        c0 = np.floor_divide(start, cs)
        c1 = np.floor_divide(end, cs)
        with self._lock:
            self._for_each_chunk_locked(c0, c1, start, end, block, save)

    def _for_each_chunk_locked(self, c0, c1, start, end, block, save):
        cs = CHUNK_SIZE
        for cx in range(c0[0], c1[0] + 1):
            for cy in range(c0[1], c1[1] + 1):
                for cz in range(c0[2], c1[2] + 1):
                    chunk = self.activate_chunk((cx, cy, cz)).reshape(cs, cs, cs)
                    lo = np.maximum(start, np.array([cx, cy, cz]) * cs)
                    hi = np.minimum(end, np.array([cx, cy, cz]) * cs + cs - 1)
                    csl = tuple(slice(int(lo[i] - [cx, cy, cz][i] * cs),
                                      int(hi[i] - [cx, cy, cz][i] * cs) + 1) for i in range(3))
                    bsl = tuple(slice(int(lo[i] - start[i]), int(hi[i] - start[i]) + 1) for i in range(3))
                    if save:
                        chunk[csl] = block[bsl]
                    else:
                        block[bsl] = chunk[csl]

    # ------------------------------------------------------------------- poses
    def write_pose(self, translation, quat_xyzw, scale: float = 1.0) -> None:
        with self._lock:
            g = self._poses.create_group(str(self._num_poses))
            self._num_poses += 1
            t = np.asarray(translation, dtype=np.float32) / float(scale)
            q = np.asarray(quat_xyzw, dtype=np.float32)
            vals = np.round(np.concatenate([t, q]) * 1000.0) / 1000.0
            g.create_dataset(POSE_DATASET, data=vals.astype(np.float32))

    def read_poses(self) -> np.ndarray:
        with self._lock:
            out = []
            for i in range(len(self._poses)):
                out.append(np.asarray(self._poses[str(i)][POSE_DATASET][...],
                                      dtype=np.float32))
            return (np.stack(out) if out
                    else np.zeros((0, POSE_SIZE), np.float32))

    # -------------------------------------------------------------------- meta
    def write_meta(self, meta: dict) -> None:
        with self._lock:
            for k, v in meta.items():
                self._map.attrs[k] = v
            self._f.flush()

    def read_meta(self) -> dict:
        return dict(self._map.attrs)

    # ---------------------------------------------------------------- lifetime
    def write_back(self) -> None:
        with self._lock:
            for key, chunk in self._active.items():
                self._store(key, chunk)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self.write_back()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
