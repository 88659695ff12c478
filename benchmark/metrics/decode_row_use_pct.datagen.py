"""Share of the batched LM's row-steps that emitted a token: 100 x the
program's `llm.tokens` over its `llm.row_steps` (rows x decode steps); the
rest is padding behind a batch's longest row."""

from benchmark.metrics.program import view


def read(ctx):
    v = view(ctx)
    rows = v.counters.get("llm.row_steps", 0) if v is not None else 0
    if rows <= 0 or "llm.tokens" not in v.counters:
        return None
    return 100.0 * v.counters["llm.tokens"] / rows
