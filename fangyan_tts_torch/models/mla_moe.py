"""A DeepSeek-V3-style decoder backbone: latent attention (MLA) and sparse
experts (MoE), at the sizes of `config.MLAMoEConfig` (Moonlight-16B-A3B by
default). It takes the Qwen2 backbone's place in the CosyVoice3 speech LM
(models/llm.CosyVoice3LM picks it when `LLMConfig.qwen` is an
MLAMoEConfig); the JAX package has no counterpart.

The block, for layer l and input x (hidden D = 2048; 16 heads):

    h      = RMSNorm_in(x)                                    (eps 1e-5)
    q      = W_q h, 16 heads of 192 = q_nope (128) ‖ q_pe (64)
    c ‖ k_pe = W_kva h,   c in R^512, k_pe in R^64 shared by every head
    c      = RMSNorm_kv(c)
    k_nope_h ‖ v_h = (W_kvb c)_h,   each 128
    q_pe, k_pe rotated by RoPE (theta 50,000) in modeling_deepseek.py's
           layout: the pairs de-interleaved (view(d/2, 2).transpose) before
           the half rotation
    attn_h = softmax((q_h . k_h) / sqrt(192) + mask) v_h,   k_h = k_nope_h ‖ k_pe
    x      = x + W_o attn                                     (W_o 2048 x 2048)
    h2     = RMSNorm_post(x)
    layer 0 (dense):  x = x + W_down(silu(W_gate h2) * W_up h2),   width 11,264
    layers 1-26 (MoE):
           s   = sigmoid(W_g h2)       W_g 64 x 2048, the product in float32
           T   = top6(s + b)           b = e_score_correction_bias: it selects only
           w_e = 2.446 s_e / (sum_T s + 1e-20)
           x   = x + sum_{e in T} w_e E_e(h2) + S(h2)
           E_e a SiLU-gated MLP of width 1,408; S the 2 shared experts as one
           SiLU-gated MLP of width 2,816
    after the last layer: the final RMSNorm (the speech head is the LM's).
Each residual add is taken by the norm that follows it, as in
models/qwen2.py (ops/rms_norm: one launch on the card; kv_a_layernorm
reads its strided split of kv_a_proj's output as it is).

Two departures from the published forward, both exact in real arithmetic:
- Absorbed decode. A one-token decode step runs attention over the latent
  cache in absorbed form: score_t = (W_uk,h^T q_nope,h) . c_t + q_pe,h . k_pe,t
  and out_h = W_uv,h sum_t p_t c_t, where W_uk,h and W_uv,h are head h's
  k_nope and v rows of W_kvb. It reassociates the same products
  (ops/mla_decode.py, one 576-wide latent row a slot shared by the 16
  query heads).
- What the cache holds. A slot keeps c_t after its norm and the rotated
  k_pe,t, 576 values a layer, in the cache's dtype (bfloat16 in the
  served decode), instead of the 16 heads' keys and values. A prompt
  prefill (T > 1) writes its slots and attends over the whole buffer
  decompressed (W_kvb c) in plain PyTorch, as Qwen2's prefill does; the
  cache-free forward (cache=None, training and tests) attends over the
  call's own rows.

Parameters: `layers.{i}.self_attn.{q_proj, kv_a_proj_with_mqa,
kv_a_layernorm, kv_b_proj, o_proj}` in the published names and torch's
(out, in) layout, the two block norms, `layers.0.mlp.{gate_up_proj,
down_proj}` (gate and up fused, as Qwen2's), `layers.{i}.mlp.gate.{weight,
e_score_correction_bias}`, the routed experts stacked as
`layers.{i}.mlp.experts.{gate_up (E, 2I, D), down (E, D, I)}` for
ops/moe.moe_experts, `layers.{i}.mlp.shared_experts.{gate_up_proj,
down_proj}` and `norm`. `from_hf` / `to_hf` convert the published
checkpoint's names.

The cache is {'kv': (L, B, S, 576), 'index': (B,) int32 next write slot}.
The MoE layers keep their work on the device in `counters` (calls, experts
with at least one row, routed rows; decode and prefill apart), which the
decode loop reads into the tracer once a call (`read_counters`), never a
step. Spans `mla` and `moe` mark each attention and MoE call on the eager
paths; a replayed CUDA graph has none.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import MLAMoEConfig
from ..ops.mla_decode import mla_decode
from ..ops.moe import moe_experts
from ..ops.qkv_rope import apply_rope
from ..utils.profiling import span
from .qwen2 import RMSNorm, qdense, rope_cos_sin

DECODE, PREFILL = 0, 1  # rows of the device counters
COUNTERS = ("calls", "active_experts", "routed_rows")


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """modeling_deepseek.py's rope layout: (..., d) pairs (2i, 2i + 1) to
    halves [even ‖ odd], before the half rotation."""
    d = x.shape[-1]
    return x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)


class DenseMLP(nn.Module):
    """SiLU-gated MLP with gate and up fused: the dense first layer and the shared experts."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_up_proj = nn.Linear(hidden, 2 * width, bias=False)
        self.down_proj = nn.Linear(width, hidden, bias=False)

    def forward(self, x):
        gate, up = qdense(x, self.gate_up_proj).chunk(2, dim=-1)
        return qdense(F.silu(gate) * up, self.down_proj)


class Router(nn.Module):
    def __init__(self, hidden: int, n_experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_experts, hidden))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(n_experts))


class Experts(nn.Module):
    """The routed experts' weights, stacked: gate_up (E, 2I, D), down (E, D, I)."""

    def __init__(self, n_experts: int, hidden: int, width: int):
        super().__init__()
        self.gate_up = nn.Parameter(torch.empty(n_experts, 2 * width, hidden))
        self.down = nn.Parameter(torch.empty(n_experts, hidden, width))


class MoE(nn.Module):
    def __init__(self, cfg: MLAMoEConfig):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg.hidden_size, cfg.n_routed_experts)
        self.experts = Experts(cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size)
        self.shared_experts = DenseMLP(cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts)

    def route(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (N, D) -> (experts (N, k) int64, weights (N, k) float32):
        sigmoid scores in float32, the top k of scores + bias, the chosen
        scores normalized and scaled."""
        c = self.cfg
        scores = torch.sigmoid(F.linear(x.float(), self.gate.weight.float()))
        chosen = torch.topk(scores + self.gate.e_score_correction_bias.float(), c.num_experts_per_tok, dim=-1).indices
        w = scores.gather(1, chosen)
        if c.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return chosen, w * c.routed_scaling_factor

    def forward(self, x: torch.Tensor, stats: torch.Tensor | None = None) -> torch.Tensor:
        b, t, d = x.shape
        flat = x.reshape(b * t, d)
        chosen, w = self.route(flat)
        y = moe_experts(flat, chosen, w, self.experts.gate_up, self.experts.down, stats)
        return (y + self.shared_experts(flat)).reshape(b, t, d)


class MLAttention(nn.Module):
    def __init__(self, cfg: MLAMoEConfig):
        super().__init__()
        self.cfg = cfg
        nh, d = cfg.num_attention_heads, cfg.hidden_size
        self.q_proj = nn.Linear(d, nh * cfg.q_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, cfg.latent_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False)
        self.o_proj = nn.Linear(nh * cfg.v_head_dim, d, bias=False)

    def forward(self, x, cos, sin, attn_bias, layer: int, cache: dict | None = None):
        c = self.cfg
        b, t, _ = x.shape
        nh, dn, dr, dv, r = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank
        q = qdense(x, self.q_proj).reshape(b, t, nh, dn + dr)
        q_nope, q_pe = q.split([dn, dr], dim=-1)
        q_pe = apply_rope(deinterleave(q_pe), cos, sin)
        lat, k_pe = qdense(x, self.kv_a_proj_with_mqa).split([r, dr], dim=-1)
        lat = self.kv_a_layernorm(lat)
        k_pe = apply_rope(deinterleave(k_pe)[:, :, None, :], cos, sin)[:, :, 0]
        scale = 1.0 / math.sqrt(dn + dr)
        w_kvb = self.kv_b_proj.weight.reshape(nh, dn + dv, r)

        if cache is not None and t == 1:  # absorbed decode over the latent cache
            kv = cache["kv"]
            q_lat = torch.einsum("bhd,hdr->bhr", q_nope[:, 0], w_kvb[:, :dn].to(x.dtype))
            q_full = torch.cat([q_lat, q_pe[:, 0]], dim=-1).to(kv.dtype)
            o_lat = mla_decode(q_full, torch.cat([lat[:, 0], k_pe[:, 0]], dim=-1).to(kv.dtype), kv, cache["index"],
                               attn_bias[:, 0, :].float().contiguous(), layer, scale, r)
            o = torch.einsum("bhr,hvr->bhv", o_lat.to(x.dtype), w_kvb[:, dn:].to(x.dtype))
            return qdense(o.reshape(b, 1, nh * dv), self.o_proj)

        if cache is None:  # the training forward: the call's own rows, no cache write
            lat_s, k_pe_s = lat, k_pe
        else:  # prefill: every row writes the same slots [index, index + t)
            i0 = int(cache["index"][0])
            cache["kv"][layer, :, i0: i0 + t] = torch.cat([lat, k_pe], dim=-1).to(cache["kv"].dtype)
            lat_s, k_pe_s = cache["kv"][layer].to(x.dtype).split([r, dr], dim=-1)
        s = lat_s.shape[1]
        k_nope, v = F.linear(lat_s, self.kv_b_proj.weight.to(x.dtype)).reshape(b, s, nh, dn + dv).split([dn, dv], -1)
        k = torch.cat([k_nope, k_pe_s[:, :, None, :].expand(b, s, nh, dr)], dim=-1)
        qf = torch.cat([q_nope, q_pe], dim=-1)
        scores = torch.einsum("bthd,bshd->bhts", qf, k) * scale
        probs = torch.softmax(scores.float() + attn_bias[:, None, :, :s], dim=-1).to(x.dtype)
        o = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, nh * dv)
        return qdense(o, self.o_proj)


class MLAMoEBlock(nn.Module):
    def __init__(self, cfg: MLAMoEConfig, layer: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.is_moe = layer >= cfg.first_k_dense_replace
        self.mlp = MoE(cfg) if self.is_moe else DenseMLP(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x, y, cos, sin, attn_bias, layer: int, cache: dict | None = None, stats=None):
        """x the residual stream and y the previous block's MLP output, not
        yet added (None before the first block). Returns (x, this block's MLP
        output): each residual add is taken by the norm that follows it."""
        with span("mla"):
            x, h = self.input_layernorm.residual(x, y)
            a = self.self_attn(h, cos, sin, attn_bias, layer, cache)
        x, h = self.post_attention_layernorm.residual(x, a)
        if not self.is_moe:
            return x, self.mlp(h)
        with span("moe"):
            return x, self.mlp(h, stats)


class MLAMoEModel(nn.Module):
    """The decoder stack on input embeddings, with the same calling
    convention as qwen2.Qwen2Model (the speech LM mixes its embeddings
    upstream) and the cache methods models/llm.py asks a backbone for."""

    def __init__(self, cfg: MLAMoEConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList([MLAMoEBlock(cfg, i) for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self._counters: dict = {}  # device -> (2, 3) int64: [decode, prefill] x COUNTERS

    def forward(self, inputs_embeds, positions, attn_bias, cache: dict | None = None):
        """inputs_embeds (B, T, D); positions (B, T); attn_bias (B, T, S)
        additive float32. With a cache, updates it in place (index advances
        by T); without one, attends over the T inputs themselves."""
        c = self.cfg
        cos, sin = rope_cos_sin(positions, c.qk_rope_head_dim, c.rope_theta, dtype=inputs_embeds.dtype)
        stats = self.counters(inputs_embeds.device)[DECODE if cache is not None and inputs_embeds.shape[1] == 1
                                                    else PREFILL]
        x, y = inputs_embeds, None
        for i, layer in enumerate(self.layers):
            x, y = layer(x, y, cos, sin, attn_bias, i, cache, stats)
        if cache is not None:
            cache["index"] += inputs_embeds.shape[1]
        return self.norm.residual(x, y)[1]

    # ---- the cache and the counters, as models/llm.py asks for them -------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """Zeroed latent cache; every row's next write slot is 0."""
        c = self.cfg
        return {"kv": torch.zeros((c.num_hidden_layers, batch, max_len, c.latent_dim), dtype=dtype, device=device),
                "index": torch.zeros((batch,), dtype=torch.int32, device=device)}

    @staticmethod
    def cache_slots(cache: dict) -> int:
        return cache["kv"].shape[2]

    @staticmethod
    def cache_dtype(cache: dict) -> torch.dtype:
        return cache["kv"].dtype

    def counters(self, device) -> torch.Tensor:
        """The MoE layers' running counts on `device` (made once, so that a
        captured graph keeps adding to the same tensor)."""
        device = torch.device(device)
        got = self._counters.get(device)
        if got is None:
            got = self._counters[device] = torch.zeros((2, len(COUNTERS)), dtype=torch.int64, device=device)
        return got

    def read_counters(self, device) -> dict:
        """The counts as the tracer names them (one device-to-host read)."""
        vals = self.counters(device).tolist()
        return {f"moe.{name}.{phase}": int(vals[row][j]) for row, phase in ((DECODE, "decode"), (PREFILL, "prefill"))
                for j, name in enumerate(COUNTERS)}


# ---- the published checkpoint's names -------------------------------------------------

_ATTN = ("q_proj", "kv_a_proj_with_mqa", "kv_a_layernorm", "kv_b_proj", "o_proj")


def from_hf(sd: dict, cfg: MLAMoEConfig) -> dict:
    """The published checkpoint's decoder (`model.embed_tokens`,
    `model.layers.*`, `model.norm`) in the speech LM's names: the text
    table as `embed_tokens.weight`, the decoder under `llm.`, gate and up
    fused, the routed experts stacked. `lm_head` (the text LM's own head)
    is not part of a speech LM and is dropped; so is anything else the
    mapping does not name (it raises on a layer key it cannot place)."""
    out = {"embed_tokens.weight": sd["model.embed_tokens.weight"], "llm.norm.weight": sd["model.norm.weight"]}
    for i in range(cfg.num_hidden_layers):
        src, dst = f"model.layers.{i}.", f"llm.layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"{dst}{norm}.weight"] = sd[f"{src}{norm}.weight"]
        for name in _ATTN:
            out[f"{dst}self_attn.{name}.weight"] = sd[f"{src}self_attn.{name}.weight"]
        if i < cfg.first_k_dense_replace:
            out[f"{dst}mlp.gate_up_proj.weight"] = torch.cat([sd[f"{src}mlp.gate_proj.weight"],
                                                              sd[f"{src}mlp.up_proj.weight"]])
            out[f"{dst}mlp.down_proj.weight"] = sd[f"{src}mlp.down_proj.weight"]
            continue
        for name in ("weight", "e_score_correction_bias"):
            out[f"{dst}mlp.gate.{name}"] = sd[f"{src}mlp.gate.{name}"]
        ex = [f"{src}mlp.experts.{e}." for e in range(cfg.n_routed_experts)]
        out[f"{dst}mlp.experts.gate_up"] = torch.stack(
            [torch.cat([sd[p + "gate_proj.weight"], sd[p + "up_proj.weight"]]) for p in ex])
        out[f"{dst}mlp.experts.down"] = torch.stack([sd[p + "down_proj.weight"] for p in ex])
        sh = f"{src}mlp.shared_experts."
        out[f"{dst}mlp.shared_experts.gate_up_proj.weight"] = torch.cat([sd[sh + "gate_proj.weight"],
                                                                         sd[sh + "up_proj.weight"]])
        out[f"{dst}mlp.shared_experts.down_proj.weight"] = sd[sh + "down_proj.weight"]
    known = re.compile(r"model\.layers\.(\d+)\.")
    for k in sd:
        m = known.match(k)
        if m and int(m.group(1)) >= cfg.num_hidden_layers:
            raise ValueError(f"from_hf: {k} lies past the configuration's {cfg.num_hidden_layers} layers")
    return out


def to_hf(sd: dict, cfg: MLAMoEConfig) -> dict:
    """from_hf's inverse on the names it maps."""
    out = {"model.embed_tokens.weight": sd["embed_tokens.weight"], "model.norm.weight": sd["llm.norm.weight"]}
    for i in range(cfg.num_hidden_layers):
        src, dst = f"llm.layers.{i}.", f"model.layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"{dst}{norm}.weight"] = sd[f"{src}{norm}.weight"]
        for name in _ATTN:
            out[f"{dst}self_attn.{name}.weight"] = sd[f"{src}self_attn.{name}.weight"]
        if i < cfg.first_k_dense_replace:
            out[f"{dst}mlp.gate_proj.weight"], out[f"{dst}mlp.up_proj.weight"] = \
                sd[f"{src}mlp.gate_up_proj.weight"].chunk(2)
            out[f"{dst}mlp.down_proj.weight"] = sd[f"{src}mlp.down_proj.weight"]
            continue
        for name in ("weight", "e_score_correction_bias"):
            out[f"{dst}mlp.gate.{name}"] = sd[f"{src}mlp.gate.{name}"]
        for e in range(cfg.n_routed_experts):
            p = f"{dst}mlp.experts.{e}."
            out[p + "gate_proj.weight"], out[p + "up_proj.weight"] = sd[f"{src}mlp.experts.gate_up"][e].chunk(2)
            out[p + "down_proj.weight"] = sd[f"{src}mlp.experts.down"][e]
        sh = f"{dst}mlp.shared_experts."
        out[sh + "gate_proj.weight"], out[sh + "up_proj.weight"] = \
            sd[f"{src}mlp.shared_experts.gate_up_proj.weight"].chunk(2)
        out[sh + "down_proj.weight"] = sd[f"{src}mlp.shared_experts.down_proj.weight"]
    return out
