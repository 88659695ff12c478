"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's completed work over the window's seconds at 989 TFLOP/s."""

from benchmark.metrics import counters


def read(ctx):
    flops = (ctx.get("work") or {}).get("model_flops")
    return 100.0 * flops / (ctx["window_s"] * counters.BF16_FLOP_PER_S) if flops else None
