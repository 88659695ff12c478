"""Share of the routed experts that a decode step's MoE call touches:
100 x the program's `moe.active_experts.decode` (experts with at least one
row, summed over the calls) over 64 experts a call x `moe.calls.decode`."""

from benchmark.metrics import counters_moe
from benchmark.metrics.program import view


def read(ctx):
    v = view(ctx)
    if v is None or v.counters.get("moe.calls.decode", 0) <= 0:
        return None
    experts = counters_moe.cell_config(ctx)["n_routed_experts"]
    return 100.0 * v.counters["moe.active_experts.decode"] / (experts * v.counters["moe.calls.decode"])
