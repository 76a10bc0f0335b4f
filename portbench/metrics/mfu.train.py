"""% of the float32 peak that a train step's counted operations take over
the traced window: both compositors (work.py), projection, SH, the loss
with its backward and Adam."""
from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
