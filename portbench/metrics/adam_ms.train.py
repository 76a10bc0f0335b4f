"""Device ms a train step spends under "train.adam" (optimizers.py)."""
from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "train", "train.adam")
