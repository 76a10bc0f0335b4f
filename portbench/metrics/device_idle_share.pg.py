"""% of the traced window of whole hybrid frames in which the device ran
nothing."""
from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "hybrid")
