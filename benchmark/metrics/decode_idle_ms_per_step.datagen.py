"""Device idle ms a decode step of the batched LM: for each batch, the idle
device time from its first `llm.step` to its last `llm.stop_check` (the
device trace on the host's clock), summed and divided by the program's
`llm.decode_steps` counter."""

from benchmark.metrics.program import view


def read(ctx):
    v = view(ctx)
    steps = v.counters.get("llm.decode_steps", 0) if v is not None else 0
    if v is None or v.idle is None or steps <= 0:
        return None
    first, last = {}, {}
    for r in v.named("llm.step"):
        first[r["parent"]] = min(first.get(r["parent"], r["t0_ns"]), r["t0_ns"])
    for r in v.named("llm.stop_check"):
        last[r["parent"]] = max(last.get(r["parent"], r["t1_ns"]), r["t1_ns"])
    batches = [p for p in first if p in last]
    if not batches:
        return None
    idle = v.idle.within([first[p] / 1e9 for p in batches], [last[p] / 1e9 for p in batches])
    return float(idle.sum()) * 1e3 / steps
