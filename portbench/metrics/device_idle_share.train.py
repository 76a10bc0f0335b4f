"""% of the traced window of whole train steps in which the device ran
nothing (device_idle_share of the training cells)."""
from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "train")
