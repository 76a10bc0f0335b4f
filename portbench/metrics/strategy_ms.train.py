"""Device ms a train step spends under the strategy's spans "strategy.*"
(relocate, add, perturb; strategy/mcmc.py), over every step of the window."""
from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "train", "strategy")
