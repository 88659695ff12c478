"""Share of the DiT's AdaLN norms that the fused kernel ran: 100 x the
program's `dit.fused_norms` over its `dit.norms` (ops/adaln: every norm of
a DiT call, the blocks' two and the final one, on either route). Nothing to
read where the program does not count them."""

from benchmark.metrics.program import view


def read(ctx):
    v = view(ctx)
    if v is None or v.counters.get("dit.norms", 0) <= 0:
        return None
    return 100.0 * v.counters.get("dit.fused_norms", 0) / v.counters["dit.norms"]
