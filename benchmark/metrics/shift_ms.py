"""The "shift" span a window shift (evict, load, scatter); None where the
window never shifted."""
from harness.spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "shift")
