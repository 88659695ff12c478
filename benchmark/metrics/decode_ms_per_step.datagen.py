"""Device ms a decode step of the batched LM: the `llm` spans (prefill and
every decode step of each batch) over the decode steps they ran."""

from benchmark.metrics.reduce import span_ms


def read(ctx):
    ms, steps = span_ms(ctx, "llm"), (ctx.get("work") or {}).get("decode_steps")
    return sum(ms) / steps if ms and steps else None
