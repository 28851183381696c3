"""Sliding-window moving-average filter.

Behavioral parity: include/util/filter.h:45-110 — including
its quirks: values are returned unfiltered until the window fills, and the
running mean is maintained incrementally (back - front) / window.
Used for IMU gyro smoothing (window 10, app.cpp:49) and runtime averages.
"""
from __future__ import annotations

from collections import deque

import numpy as np


class SlidingWindowFilter:
    def __init__(self, window_size: int):
        self.window_size = float(window_size)
        self.buffer: deque = deque()
        self.mean = None

    def update(self, new_value):
        new_value = np.asarray(new_value, dtype=np.float64)
        if self.mean is None:
            self.mean = np.zeros_like(new_value)
        if self.window_size < 2:
            return new_value
        self.buffer.append(new_value)
        if len(self.buffer) <= self.window_size:
            self.mean = self.mean + new_value / self.window_size
            return new_value
        self.mean = self.mean + (self.buffer[-1] - self.buffer[0]) / self.window_size
        self.buffer.popleft()
        return self.mean
