"""Carry state between the JAX package and the port through numpy.

The system has no weights: its state is the map window and the registration
fields.  These helpers put the port into the state a JAX run reached
(arrays come in as numpy, e.g. ``np.asarray(jax_state.value)``).  The
global map needs no helper: both packages read and write the same HDF5
schema, so a map file the JAX app persisted resumes in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.config import Params
from .map.local_map import LocalMapState
from .ops.registration import PackedFields, PackedFields2


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype, copy=True),
                           device=device)


def state_from_numpy(value, weight, pos, offset,
                     device="cpu") -> LocalMapState:
    """A ``LocalMapState`` on ``device`` from numpy (or array-like) planes
    and ring origin."""
    return LocalMapState(value=_t(value, np.int16, device),
                         weight=_t(weight, np.int16, device),
                         pos=_t(pos, np.int32, device),
                         offset=_t(offset, np.int32, device))


def packed_fields_from_numpy(plane_or_a, plane_b=None, device="cpu"):
    """``PackedFields`` from one int32 plane, or ``PackedFields2`` from
    the two exact planes."""
    if plane_b is None:
        return PackedFields(plane=_t(plane_or_a, np.int32, device))
    return PackedFields2(plane_a=_t(plane_or_a, np.int32, device),
                         plane_b=_t(plane_b, np.int32, device))


def params_from_dict(d: dict) -> Params:
    """``Params`` from ``dataclasses.asdict`` of a JAX ``Params`` (derived
    map fields are recomputed, not copied)."""
    return Params.from_dict(d)
