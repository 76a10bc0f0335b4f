"""B2's share of its roofline in train steps (work.b2_work)."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "train", "b2")
