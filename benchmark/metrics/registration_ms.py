"""The "registration" span a scan less its nested "fields": the loop
kernel's registration with its set-up and header read."""
from harness.spans import per_call_ms


def read(ctx):
    count = ctx["spans"].get("registration", (0, 0.0))[0]
    if count == 0:
        return None
    return per_call_ms(ctx, "registration", minus=("fields",))
