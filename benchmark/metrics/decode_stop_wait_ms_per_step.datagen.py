"""Host ms blocked on each step's stop check of the batched LM: the mean of
the program's `llm.stop_check` spans (the `bool(done.all())` read, which
waits for the device to finish the step)."""

from benchmark.metrics.program import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "llm.stop_check")
