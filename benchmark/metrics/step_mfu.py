"""The whole step's share of the card's peak over the traced window: the
least time of the work every scan must do whatever implements it (each
fusion's changed voxels read and written and its points read, at the
published bandwidth) over the window's time."""
from harness import roofline


def read(ctx):
    nbytes = sum(roofline.fusion_bytes(c, p) for c, p in ctx["fusions"])
    if nbytes == 0:
        return None
    return roofline.share_pct(nbytes, ctx["window_s"], ctx["card"])
