"""Share of its roofline that the bf16 decode-attention kernel reaches over
the window's launches (kernel name pattern below)."""

from benchmark.metrics.reduce import roofline_pct

PATTERN = "decode_attention_kernel"


def read(ctx):
    return roofline_pct(ctx, "decode_attention", PATTERN)
