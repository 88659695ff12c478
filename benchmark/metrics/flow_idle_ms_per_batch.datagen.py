"""Device idle ms inside a batch's flow: the idle device time inside the
program's `flow` spans (the device trace on the host's clock), over the
number of those spans."""

from benchmark.metrics.program import view


def read(ctx):
    v = view(ctx)
    flows = v.named("flow") if v is not None and v.idle is not None else []
    return float(v.idle_s(flows).sum()) * 1e3 / len(flows) if flows else None
