"""Device ms a train step spends under the projection's span
"3dgut.project" (ops/projection.py)."""
from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "train", "3dgut.project")
