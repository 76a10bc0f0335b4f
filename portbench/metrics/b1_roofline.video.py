"""B1's share of its roofline in fly-through frames (work.b1_work)."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "video", "b1")
