"""The "fields" span a computation of the registration fields (K2's packed
fields, or the plain parity fields)."""
from harness.spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "fields")
