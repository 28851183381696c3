"""The "preprocessing" span a scan (voxel dedup and pose transform)."""
from harness.spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "preprocessing")
