"""Device ms of a batched token2wav step of the stream scheduler: the mean
`hop` span (CUDA events at the edges of each BatchedStreamGroup.step; work
that other threads queue on the device in between counts too)."""

from benchmark.metrics.reduce import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "hop")
