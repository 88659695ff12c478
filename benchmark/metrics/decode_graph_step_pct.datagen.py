"""Share of the batched LM's decode steps run by replaying a captured CUDA
graph: 100 x the program's `llm.graph_steps` over its `llm.decode_steps`
(the rest ran eagerly: a bucket's first step, before its capture)."""

from benchmark.metrics.program import view


def read(ctx):
    v = view(ctx)
    if v is None or "llm.graph_steps" not in v.counters or v.counters.get("llm.decode_steps", 0) <= 0:
        return None
    return 100.0 * v.counters["llm.graph_steps"] / v.counters["llm.decode_steps"]
