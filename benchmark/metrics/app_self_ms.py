"""The app step's own time a scan: the "total" span less its child spans
(preprocessing, tsdf, registration, shift): the subsample, padding, the
host-to-device copy of the cloud, the gate and the pose's bookkeeping."""
from harness.spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "total", minus=("preprocessing", "tsdf",
                                           "registration", "shift"))
