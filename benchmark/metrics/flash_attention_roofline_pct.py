"""Share of its roofline that the bf16 chunk flash-attention kernel reaches
over the window's launches (kernel name pattern below)."""

from benchmark.metrics.reduce import roofline_pct

PATTERN = "chunk_flash_attention_kernel"


def read(ctx):
    return roofline_pct(ctx, "flash_attention", PATTERN)
