"""Device ms a hybrid frame spends under the 3DGRT cull's spans "3dgrt.cull"
and "3dgrt.cull.*" (render/grt.py), the secondary rays' culls above all."""
from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "hybrid", "3dgrt.cull")
