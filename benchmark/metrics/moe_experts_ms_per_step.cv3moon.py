"""Device ms of the grouped expert kernel's launches (prefill and decode)
over the decode steps the program counted (`llm.decode_steps`)."""

from benchmark.metrics.program import view

PATTERN = "fangyan_moe_"


def read(ctx):
    v, trace = view(ctx), ctx.get("trace")
    if v is None or trace is None or v.counters.get("llm.decode_steps", 0) <= 0:
        return None
    times = trace.kernel_times_s(PATTERN)
    return 1e3 * sum(times) / v.counters["llm.decode_steps"] if times else None
