"""Fixed-point conventions shared by every layer of the framework.

Reference parity: include/warpsense/consts.h:9-13.

The whole system works in integer millimeters for positions and in two
fixed-point scales:

* ``WEIGHT_RESOLUTION`` — scale of TSDF weights (a weight of ``1.0`` is
  stored as ``64``).
* ``MATRIX_RESOLUTION`` — scale used for rotation matrices and normalized
  vectors when they must live in integer arithmetic (``1.0`` == ``1 << 15``).
"""

WEIGHT_RESOLUTION: int = 1 << 6  # 64
MATRIX_RESOLUTION: int = 1 << 15  # 32768

# Packed TSDF entry layout (matches reference include/map/tsdf.h:16-140):
# one uint32 = low int16 value | high int16 weight.
TSDF_VALUE_BITS = 16
TSDF_WEIGHT_BITS = 16

# Default per-call point capacities (reference caps:
# src/warpsense/cuda/registration.cu:261 and
# include/warpsense/cuda/update_tsdf.h:33). Clouds keep static shapes, so
# they are padded/masked to these capacities.
MAX_REGISTRATION_POINTS: int = 128 * 1024
MAX_TSDF_POINTS: int = 1024 * 1024
