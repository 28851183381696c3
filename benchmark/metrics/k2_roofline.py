"""K2's share of its memory roofline: the window's value and weight read
once and the packed fields written once (``harness.roofline.
fields_bytes``, at the bytes the call returns), at the card's published
bandwidth, over the device time of what the call launched."""
from harness import roofline

NAME = "precompute_fields_packed_auto"


def read(ctx):
    seconds = sum(ctx["fields_device_s"][NAME])
    nbytes = sum(b for n, b in ctx["fields"] if n == NAME)
    if nbytes == 0 or seconds <= 0:
        return None
    return roofline.share_pct(nbytes, seconds, ctx["card"])
