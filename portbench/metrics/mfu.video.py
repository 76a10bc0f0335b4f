"""% of the float32 peak that a frame's counted operations take over the
traced window: B1 (work.py), projection and SH."""
from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "video")
