"""Device ms a frame spends under the projection's span "3dgut.project"."""
from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "video", "3dgut.project")
