"""The fused scans' share of the card's peak: the least time of their
fusions' bytes (as ``step_mfu``) over their scans' host time from call
to return, the benchmark's probes left out."""
from harness import roofline


def read(ctx):
    fused = ctx["fused_wall"]
    wall = sum(w for w, _ in fused)
    if not fused or wall <= 0:
        return None
    nbytes = sum(roofline.fusion_bytes(c, p) for _, (c, p) in fused)
    return roofline.share_pct(nbytes, wall, ctx["card"])
