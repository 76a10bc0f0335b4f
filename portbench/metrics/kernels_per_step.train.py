"""Device kernels a train step launches, eager glue included, from the
profiler (less the copies the launch recorder adds)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    n = len(ctx.trace.kernels) - ctx.extra_kernels
    return n / ctx.trace.units
