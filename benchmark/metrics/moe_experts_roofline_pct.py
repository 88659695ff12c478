"""Share of its roofline that the grouped expert kernel (ops/moe.py, two
launches a MoE layer call) reaches over the window: the least time of the
calls the program counted (counters_moe.moe_least_ms, per phase, from its
moe.* counters) over the device time the trace gives the kernel's
launches. None without a trace or the counters, or where the trace holds
another number of launches than the program counted (two a call)."""

from benchmark.metrics import counters_moe
from benchmark.metrics.program import view

PATTERN = "fangyan_moe_"


def read(ctx):
    v, trace = view(ctx), ctx.get("trace")
    if v is None or trace is None:
        return None
    calls = v.counters.get("moe.calls.decode", 0) + v.counters.get("moe.calls.prefill", 0)
    times = trace.kernel_times_s(PATTERN)
    ctx.setdefault("notes", []).append(f"moe experts: {len(times)} launches traced, {2 * calls} counted")
    least = counters_moe.moe_least_ms(counters_moe.cell_config(ctx), v.counters)
    if not calls or len(times) != 2 * calls or least is None or sum(times) <= 0:
        return None
    return 100.0 * least / 1e3 / sum(times)
