"""The "tsdf.sweep" span a fused scan, until its work is done: K1's
launch, the level or the general sweep with its merge; None where the
program has no such span."""
from harness.spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "tsdf.sweep")
