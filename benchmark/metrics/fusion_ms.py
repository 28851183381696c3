"""The "tsdf" span a fused scan (beam table and K1), less the benchmark's
probes that count the changed voxels around each fusion."""
from harness.spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "tsdf", minus_s=ctx["probe_s"])
