"""Carry state between the JAX package and the port through numpy.

The system has no weights: its state is the map window, the registration
fields and the featsense odometry (feature maps and pose).  These helpers
put the port into the state a JAX run reached (arrays come in as numpy,
e.g. ``np.asarray(jax_state.value)``), on the card unless the caller asks
for the CPU (``device="cpu"``; a CUDA device without a GPU raises).  The
global map needs no helper: both packages read and write the same HDF5
schema, so a map file the JAX app persisted resumes in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.config import Params
from .frontends.featsense.odometry import FeatureMapState, OdomEstimation
from .map.local_map import LocalMapState
from .ops.registration import PackedFields, PackedFields2, RegistrationFields
from .utils.device import resolve_device


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype, copy=True),
                           device=resolve_device(device))


def state_from_numpy(value, weight, pos, offset,
                     device="cuda") -> LocalMapState:
    """A ``LocalMapState`` on ``device`` from numpy (or array-like) planes
    and ring origin."""
    return LocalMapState(value=_t(value, np.int16, device),
                         weight=_t(weight, np.int16, device),
                         pos=_t(pos, np.int32, device),
                         offset=_t(offset, np.int32, device))


def packed_fields_from_numpy(plane_or_a, plane_b=None, device="cuda"):
    """``PackedFields`` from one int32 plane, or ``PackedFields2`` from
    the two exact planes."""
    if plane_b is None:
        return PackedFields(plane=_t(plane_or_a, np.int32, device))
    return PackedFields2(plane_a=_t(plane_or_a, np.int32, device),
                         plane_b=_t(plane_b, np.int32, device))


def registration_fields_from_numpy(vw, gxy, gz,
                                   device="cuda") -> RegistrationFields:
    """Parity-mode ``RegistrationFields`` from its three int32 planes."""
    return RegistrationFields(vw=_t(vw, np.int32, device),
                              gxy=_t(gxy, np.int32, device),
                              gz=_t(gz, np.int32, device))


def feature_map_from_numpy(points, mask,
                           device="cuda") -> FeatureMapState:
    """A featsense ``FeatureMapState`` (float32 points, bool mask)."""
    return FeatureMapState(points=_t(points, np.float32, device),
                           mask=_t(mask, bool, device))


def odom_estimation_from_numpy(edge_map, surf_map, odom, last_odom,
                               optimization_count: int, initialized: bool,
                               device="cuda", **kwargs) -> OdomEstimation:
    """An ``OdomEstimation`` (built with ``kwargs``) in a given state:
    ``edge_map``/``surf_map`` are (points, mask) pairs, ``odom`` and
    ``last_odom`` 4x4 poses in meters."""
    est = OdomEstimation(device=device, **kwargs)
    est.edge_map = feature_map_from_numpy(*edge_map, device=device)
    est.surf_map = feature_map_from_numpy(*surf_map, device=device)
    est.odom = np.array(odom, dtype=np.float64)
    est.last_odom = np.array(last_odom, dtype=np.float64)
    est.optimization_count = int(optimization_count)
    est.initialized = bool(initialized)
    return est


def params_from_dict(d: dict) -> Params:
    """``Params`` from ``dataclasses.asdict`` of a JAX ``Params`` (derived
    map fields are recomputed, not copied)."""
    return Params.from_dict(d)
