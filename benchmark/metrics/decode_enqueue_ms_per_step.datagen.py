"""Host ms to issue one decode step of the batched LM: the mean of the
program's `llm.step` spans (sampling, then the 24 layers' launches)."""

from benchmark.metrics.program import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "llm.step")
