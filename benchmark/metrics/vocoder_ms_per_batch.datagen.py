"""Device ms of a batch's vocoder: the mean `vocoder` span (the batched
causal HiFT and the audio's fetch)."""

from benchmark.metrics.reduce import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "vocoder")
