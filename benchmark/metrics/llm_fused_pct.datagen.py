"""Share of the LM backbone's element-wise chains that the fused kernels
ran: 100 x (the program's `llm.fused_norms` + `llm.fused_qkv`) over its
(`llm.norms` + `llm.qkv`) (ops/rms_norm: every RMSNorm of a backbone
forward with the residual add before it; ops/qkv_rope: every Qwen2 qkv
epilogue; either route, counted on the host at each call, so a replayed
decode graph counts as its capture did). Nothing to read where the
program does not count them."""

from benchmark.metrics.program import view


def read(ctx):
    v = view(ctx)
    if v is None:
        return None
    total = v.counters.get("llm.norms", 0) + v.counters.get("llm.qkv", 0)
    if total <= 0:
        return None
    return 100.0 * (v.counters.get("llm.fused_norms", 0) + v.counters.get("llm.fused_qkv", 0)) / total
