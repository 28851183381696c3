"""Bounded concurrent ring buffer — the pipeline's dataflow primitive.

Behavioral parity: include/util/concurrent_ring_buffer.h
(mutex + condvar ring with push_nb(force), pop(timeout), pop_nb,
pop_nb_if(pred), peek, clear).  Python threads around the device step
play the role the reference's std::threads play around CUDA launches.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Optional


class ConcurrentRingBuffer:
    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

    def push_nb(self, item: Any, force: bool = False) -> bool:
        """Non-blocking push; with force=True the oldest item is dropped."""
        with self._lock:
            if len(self._buf) >= self.capacity:
                if not force:
                    return False
                self._buf.popleft()
            self._buf.append(item)
            self._not_empty.notify()
            return True

    def push(self, item: Any, timeout: Optional[float] = None) -> bool:
        with self._not_full:
            if not self._not_full.wait_for(
                    lambda: len(self._buf) < self.capacity, timeout):
                return False
            self._buf.append(item)
            self._not_empty.notify()
            return True

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        with self._not_empty:
            if not self._not_empty.wait_for(lambda: len(self._buf) > 0, timeout):
                return None
            item = self._buf.popleft()
            self._not_full.notify()
            return item

    def pop_nb(self) -> Optional[Any]:
        with self._lock:
            if not self._buf:
                return None
            item = self._buf.popleft()
            self._not_full.notify()
            return item

    def pop_nb_if(self, pred: Callable[[Any], bool]) -> Optional[Any]:
        """Pop the head only if ``pred(head)`` holds (imu stamp gating)."""
        with self._lock:
            if not self._buf or not pred(self._buf[0]):
                return None
            item = self._buf.popleft()
            self._not_full.notify()
            return item

    def peek(self) -> Optional[Any]:
        with self._lock:
            return self._buf[0] if self._buf else None

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._not_full.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)
