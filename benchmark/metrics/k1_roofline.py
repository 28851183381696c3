"""K1's share of its memory roofline over the traced fusions: the least
time of every fusion's bytes (``harness.roofline.fusion_bytes``: the
voxels it changed, read and written, and the scan's points) at the card's
published bandwidth, over the device time of everything the fusion call
launched (beam table and sweep)."""
from harness import roofline


def read(ctx):
    seconds = sum(ctx["fusion_device_s"])
    if not ctx["fusions"] or seconds <= 0:
        return None
    nbytes = sum(roofline.fusion_bytes(c, p) for c, p in ctx["fusions"])
    return roofline.share_pct(nbytes, seconds, ctx["card"])
