"""B1's share of its roofline in train steps (work.b1_work over its
device time)."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "train", "b1")
