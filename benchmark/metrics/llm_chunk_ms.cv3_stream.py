"""Device ms of a shared decode chunk of the LLM scheduler: the mean
`llm_chunk` span (CUDA events at the edges of LLMScheduler._run_chunk; work
that other threads queue on the device in between counts too)."""

from benchmark.metrics.reduce import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "llm_chunk")
