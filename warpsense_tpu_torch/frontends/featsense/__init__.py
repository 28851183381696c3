"""Featsense front end on tensors: F-LOAM feature odometry + VGICP
refinement (counterpart of ``warpsense_tpu/frontends/featsense``)."""
from .features import extract_features
from .features_reference import FeatureParams
from .odometry import FeatureMapState, OdomEstimation, odom_update
from .vgicp import vgicp_align

__all__ = ["extract_features", "FeatureParams", "FeatureMapState",
           "OdomEstimation", "odom_update", "vgicp_align"]
