"""GIL-free byte queue backed by the native C++ ring buffer.

Counterpart of ``warpsense_tpu/utils/native_queue.py``: carries raw scan
frames between data-loader and pipeline threads without holding the GIL
while it waits (the role of the reference's
``ConcurrentRingBuffer<sensor_msgs::PointCloud2ConstPtr>``,
include/featsense/buffers.h:15-42).  ``ScanQueue``'s caller picks its
backend: the native queue, or the Python ``ConcurrentRingBuffer``.

Frames cross the native queue in a fixed binary layout (stamp, shape and
float32 payload), so popping never unpickles.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Any, Optional

import numpy as np

from ..native import load as load_native
from .ring_buffer import ConcurrentRingBuffer


class NativeByteQueue:
    """Bounded queue of byte payloads (``ws_ringbuf_*``); ``lib`` defaults
    to the native library (built if needed; raises when it cannot be)."""

    def __init__(self, capacity: int, lib=None):
        self._lib = lib if lib is not None else load_native()
        self._h = self._lib.ws_ringbuf_create(capacity)

    def push(self, payload: bytes, *, force: bool = False,
             timeout: float = -1.0) -> bool:
        """Push a copy of ``payload``; ``force`` drops the oldest item when
        full, ``timeout < 0`` never blocks.  True when pushed."""
        buf = (ctypes.c_char * len(payload)).from_buffer_copy(payload)
        return bool(self._lib.ws_ringbuf_push(
            self._h, buf, len(payload), int(force), timeout))

    def pop(self, *, timeout: float = -1.0, max_bytes: int = 1 << 24
            ) -> Optional[bytes]:
        """The oldest payload, or None when empty at the timeout."""
        out = (ctypes.c_char * max_bytes)()
        n = ctypes.c_size_t(0)
        rc = self._lib.ws_ringbuf_pop(self._h, out, max_bytes,
                                      ctypes.byref(n), timeout)
        if rc == -1:  # payload larger than the buffer: retry sized
            return self.pop(timeout=timeout, max_bytes=int(n.value))
        if rc != 1:
            return None
        return bytes(out[: n.value])

    def __len__(self) -> int:
        return int(self._lib.ws_ringbuf_size(self._h))

    def clear(self) -> None:
        self._lib.ws_ringbuf_clear(self._h)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.ws_ringbuf_destroy(h)


_HEAD = struct.Struct("<dI")


def _encode(stamp: float, cloud: np.ndarray) -> bytes:
    cloud = np.ascontiguousarray(cloud, dtype=np.float32)
    return (_HEAD.pack(float(stamp), cloud.ndim)
            + struct.pack(f"<{cloud.ndim}q", *cloud.shape) + cloud.tobytes())


def _decode(payload: bytes) -> tuple[float, np.ndarray]:
    stamp, ndim = _HEAD.unpack_from(payload)
    shape = struct.unpack_from(f"<{ndim}q", payload, _HEAD.size)
    data = payload[_HEAD.size + 8 * ndim:]
    return stamp, np.frombuffer(data, np.float32).reshape(shape).copy()


class ScanQueue:
    """Typed scan queue of (stamp, float32 cloud) frames with one API over
    either backend: ``backend="native"`` (the default; the C++ ring buffer,
    raises when the library cannot be built) or ``"python"`` (the
    ``ConcurrentRingBuffer``)."""

    def __init__(self, capacity: int, backend: str = "native"):
        if backend not in ("native", "python"):
            raise ValueError(f"unknown ScanQueue backend {backend!r}")
        self._backend = backend
        self._q = (NativeByteQueue(capacity) if backend == "native"
                   else ConcurrentRingBuffer(capacity))

    @property
    def backend(self) -> str:
        """"native" or "python": the queue this one runs on."""
        return self._backend

    def push(self, stamp: float, cloud: np.ndarray, *, force: bool = False,
             timeout: float = -1.0) -> bool:
        if self.backend == "python":
            item = (stamp, np.asarray(cloud, np.float32))
            return (self._q.push_nb(item, force=force) if timeout < 0
                    else self._q.push(item, timeout=timeout))
        return self._q.push(_encode(stamp, cloud), force=force,
                            timeout=timeout)

    def pop(self, *, timeout: float = -1.0) -> Optional[tuple[float, Any]]:
        if self.backend == "python":
            return (self._q.pop_nb() if timeout < 0
                    else self._q.pop(timeout=timeout))
        payload = self._q.pop(timeout=timeout)
        return None if payload is None else _decode(payload)

    def __len__(self) -> int:
        return len(self._q)

    def clear(self) -> None:
        self._q.clear()
