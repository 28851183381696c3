"""The "glue" span a scan: ``cloud_callback``'s subsample, sort and pad
of the cloud and its two copies to the device, until they are done."""
from harness.spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "glue")
