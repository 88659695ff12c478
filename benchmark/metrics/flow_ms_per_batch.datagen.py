"""Device ms of a batch's flow: the mean `flow` span (the batched DiT solve
with its prompt and padding)."""

from benchmark.metrics.reduce import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "flow")
