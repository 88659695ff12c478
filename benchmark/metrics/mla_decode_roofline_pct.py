"""Share of its roofline that the MLA decode kernel (ops/mla_decode.py: the
split pass and the merge, two launches a layer a decode step) reaches over
the window's launches, predicted from the traffic (kernel name pattern
below)."""

from benchmark.metrics.reduce import roofline_pct

PATTERN = "fangyan_mla_decode"


def read(ctx):
    return roofline_pct(ctx, "mla_decode", PATTERN)
