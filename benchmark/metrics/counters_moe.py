"""The yardstick's arithmetic for the MLA-MoE speech LM (a DeepSeek-V3-style
decoder): the bytes and operations of its two kernels, and the model FLOPs
of completed work. Peaks and `bound` are counters.py's; later changes to
the system under test do not move these.

Expert kernel (the routed experts of one MoE layer call, two launches).
Bytes: each touched expert's weights once (gate, up and down, 3 D I bf16:
17.30 MB at Moonlight's widths) and each routed row in and out (D bf16
each way). Operations: 2 x 3 D I a routed row. The counts are taken per
phase, from the program's counters (calls, experts with a row, routed
rows), and each phase is bound by bytes at this cell's shapes, so the
phase's least time is its bytes over the peak: a decode call routes 16
rows x 6 = 96 rows over 64 experts, 1.5 rows an expert, against the ~295
operations a byte at which the card's tensor cores, not its memory, would
bound an expert (an expert does 2 operations a weight byte per row); a
1.5 k-row prefill call gives an expert about 144 rows, still under 295.
The per-phase sum of bytes over the peak is then the sum of every call's
least time.

MLA decode kernel (one layer's decode attention over the latent cache,
two launches: the split pass and the merge). Bytes: each open slot's
latent row (latent + rope, bf16) once for all heads, the absorbed query
and the output (bf16), the float32 bias row. Operations: 2 x heads x
(latent + rope + latent) an open slot: the scores over the whole slot row
and the weighted sum of the latents.
"""

from __future__ import annotations

from benchmark.harness import HERE, read_json
from benchmark.metrics import counters


def cell_config(ctx: dict) -> dict:
    """The configuration of the run's cell (`ctx["cell"]`), as its file holds it."""
    spec = read_json(HERE / "workloads" / f"{ctx['cell']}.json")
    return read_json(HERE / "configs" / f"{spec['config']}.json")


def expert_bytes(c: dict) -> int:
    """One routed expert's weights: gate, up and down, bf16."""
    return 3 * c["hidden_size"] * c["moe_intermediate_size"] * 2


def moe_phase_work(c: dict, active_experts: int, routed_rows: int) -> tuple[float, float]:
    """(bytes, operations) of a phase's expert-kernel calls, from the sum
    over its calls of the experts with a row and of the routed rows."""
    d, i = c["hidden_size"], c["moe_intermediate_size"]
    nbytes = active_experts * expert_bytes(c) + routed_rows * d * 2 * 2
    return float(nbytes), float(routed_rows * 2 * 3 * d * i)


def moe_least_ms(c: dict, counts: dict) -> float | None:
    """The least ms of every expert-kernel call the program counted, per
    phase (`counts` holds the tracer's moe.* counters); None where none."""
    total, seen = 0.0, False
    for phase in ("decode", "prefill"):
        if counts.get(f"moe.calls.{phase}", 0) <= 0:
            continue
        seen = True
        total += counters.bound(*moe_phase_work(c, counts[f"moe.active_experts.{phase}"],
                                                counts[f"moe.routed_rows.{phase}"]))[0]
    return total if seen else None


def mla_decode_work(b: int, s: int, heads: int, latent: int, rope: int, open_slots: int) -> tuple[float, float]:
    """(bytes, operations) of one MLA decode call over B rows and an S-slot
    cache, `open_slots` the slots the rows' masks leave open, summed over
    the rows."""
    row = latent + rope
    nbytes = open_slots * row * 2 + b * heads * row * 2 + b * heads * latent * 2 + b * s * 4
    return float(nbytes), float(2 * heads * (row + latent) * open_slots)


# ---- model FLOPs of completed work ------------------------------------------

def token_flops(c: dict) -> float:
    """Dense FLOPs of one token through the decoder's active weights and the
    speech head: 2 x the weights it multiplies (the routed experts it is
    sent to, not all of them; the tables are lookups)."""
    d, nh = c["hidden_size"], c["num_attention_heads"]
    dn, dr, dv, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
    attn = d * nh * (dn + dr) + d * (r + dr) + r * nh * (dn + dv) + nh * dv * d
    dense = 3 * d * c["intermediate_size"]
    i = c["moe_intermediate_size"]
    moe = d * c["n_routed_experts"] + 3 * d * i * (c["num_experts_per_tok"] + c["n_shared_experts"])
    n_dense = c["first_k_dense_replace"]
    layers = c["num_hidden_layers"] * attn + n_dense * dense + (c["num_hidden_layers"] - n_dense) * moe
    return 2.0 * (layers + c["llm_output_size"] * (c["speech_token_size"] + c["extra_tokens"]))


def attention_flops(c: dict, keys_seen: int) -> float:
    """Attention FLOPs of queries that see `keys_seen` keys in all: the
    scores over 192-wide heads and the weighted 128-wide values, every
    layer and head."""
    return 2.0 * c["num_hidden_layers"] * c["num_attention_heads"] * (
        c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"]) * keys_seen


def lm_sequence_flops(c: dict, prompt_len: int, new_tokens: int) -> float:
    n = prompt_len + new_tokens
    return token_flops(c) * n + attention_flops(c, n * (n + 1) // 2)
