"""The share of fusions that binned on the sensor's attitude grid (K1's
general sweep): 100 x ``fusion_grid_attitude`` / (it +
``fusion_grid_level``), the program's counters where
``pipeline.fusion_backend.fuse_cloud`` picks the grid; None where the
program has no such counters."""
from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator


def read(ctx):
    counters = getattr(RuntimeEvaluator.get_instance(), "counters", None)
    if counters is None:
        return None
    c = counters()
    level = c.get("fusion_grid_level", 0)
    attitude = c.get("fusion_grid_attitude", 0)
    if level + attitude == 0:
        return None
    return 100.0 * attitude / (level + attitude)
