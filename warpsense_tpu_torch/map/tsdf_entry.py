"""Packed TSDF entry <-> (value, weight) conversions.

Parity: include/map/tsdf.h:16-140 — one little-endian uint32
holds ``int16 value`` in the low half and ``int16 weight`` in the high half.
The on-device map keeps value/weight as two separate int16 arrays (better
layout for elementwise kernels); packing is only needed at the HDF5
boundary and in the deterministic scatter-combine key.
"""
from __future__ import annotations

import numpy as np


def pack(value: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """(int16 value, int16 weight) -> uint32 raw."""
    v = np.asarray(value).astype(np.int16).view(np.uint16).astype(np.uint32)
    w = np.asarray(weight).astype(np.int16).view(np.uint16).astype(np.uint32)
    return (w << 16) | v


def unpack(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint32 raw -> (int16 value, int16 weight)."""
    raw = np.asarray(raw, dtype=np.uint32)
    v = (raw & 0xFFFF).astype(np.uint16).view(np.int16)
    w = (raw >> 16).astype(np.uint16).view(np.int16)
    return v, w
