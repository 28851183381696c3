"""The "tsdf.table" span a fused scan, until its work is done: the beam
table and the sweep's coordinate grid, the part of "tsdf" before K1;
None where the program has no such span."""
from harness.spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "tsdf.table")
