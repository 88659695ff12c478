"""The CosyVoice3 speech-token LM on Moonlight-16B-A3B's decoder, float32,
one row at a time over the whole sequence (no cache, no padding, no
batching, no kernels), in the parameter names of the system under test.

The decoder (DeepSeek-V3's block, as modeling_deepseek.py computes it),
for layer l and input x (hidden 2048, 16 heads):

    h      = RMSNorm_in(x)                                     (eps 1e-5)
    q      = W_q h, 16 heads of 192 = q_nope (128) ‖ q_pe (64)
    c ‖ k_pe = W_kva h,   c in R^512, k_pe in R^64 shared by every head
    c      = RMSNorm_kv(c)
    k_nope_h ‖ v_h = (W_kvb c)_h,   each 128
    q_pe, k_pe rotated by RoPE (theta 50,000) after de-interleaving the
           pairs (view(d/2, 2).transpose), the half rotation
    attn_h = softmax((q_h . k_h) / sqrt(192) + causal mask) v_h,  k_h = k_nope_h ‖ k_pe
    x      = x + W_o attn
    h2     = RMSNorm_post(x)
    layer 0:      x = x + W_down(silu(W_gate h2) * W_up h2)         width 11,264
    layers 1-26:  s = sigmoid(W_g h2); T = top6(s + b) (b selects only);
                  w_e = 2.446 s_e / (sum_T s + 1e-20);
                  x = x + sum_{e in T} w_e E_e(h2) + S(h2)
                  (E_e SiLU-gated MLPs of width 1,408, S the 2 shared
                  experts as one of width 2,816)
    the final RMSNorm, then the speech head.

The speech LM around it is CosyVoice3's: text ids through the decoder's
text table, sos / task / speech ids through the speech table, the
inference prompt [sos, text, task, prompt speech], a bias-free head over
the speech vocabulary and its stop ids. The text LM's own output head is
not part of it.

Weights. At full size the weights are 62.6 GB in float32, more than the
card holds beside the program's own. So the parameters keep the dtype
they are loaded in (the benchmark loads the seed's bf16 draws as they
are) and every product upcasts its weight to float32 when it is used,
one layer (one expert) at a time. The weights are bf16 draws, so the
float32 values are exactly those a float32 copy would hold: the
arithmetic is float32 throughout. The caller turns TF32 off on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

TEXT, SPEECH = 0, 1


def f32(w: torch.Tensor) -> torch.Tensor:
    return w.float()


class Linear(nn.Module):
    """A bias-free product whose weight (out, in) is upcast at each use."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))

    def forward(self, x):
        return F.linear(x, f32(self.weight))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * f32(self.weight)


def rope(x, cos, sin):
    """De-interleave the pairs (modeling_deepseek.py), then the half
    rotation: x (L, H, d), cos / sin (L, d)."""
    l, h, d = x.shape
    x = x.reshape(l, h, d // 2, 2).transpose(-1, -2).reshape(l, h, d)
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos[:, None] + rotated * sin[:, None]


class Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.nh, self.dn, self.dr, self.dv = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                                              c["v_head_dim"])
        self.r = c["kv_lora_rank"]
        d = c["hidden_size"]
        self.q_proj = Linear(d, self.nh * (self.dn + self.dr))
        self.kv_a_proj_with_mqa = Linear(d, self.r + self.dr)
        self.kv_a_layernorm = RMSNorm(self.r, c["rms_norm_eps"])
        self.kv_b_proj = Linear(self.r, self.nh * (self.dn + self.dv))
        self.o_proj = Linear(self.nh * self.dv, d)

    def forward(self, x, cos, sin):
        l = x.shape[0]
        q = self.q_proj(x).reshape(l, self.nh, self.dn + self.dr)
        q_nope, q_pe = q.split([self.dn, self.dr], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.r, self.dr], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).reshape(l, self.nh, self.dn + self.dv)
        k_nope, v = kv.split([self.dn, self.dv], dim=-1)
        q = torch.cat([q_nope, rope(q_pe, cos, sin)], dim=-1).transpose(0, 1)  # (H, L, 192)
        k_pe = rope(k_pe[:, None, :], cos, sin).expand(l, self.nh, self.dr)
        k = torch.cat([k_nope, k_pe], dim=-1).transpose(0, 1)
        scores = q @ k.transpose(1, 2) / math.sqrt(self.dn + self.dr)
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        return self.o_proj((probs @ v.transpose(0, 1)).transpose(0, 1).reshape(l, self.nh * self.dv))


class MLP(nn.Module):
    """SiLU-gated MLP, gate and up in one (2 width, in) weight."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_up_proj = Linear(d, 2 * width)
        self.down_proj = Linear(width, d)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


class Router(nn.Module):
    def __init__(self, d: int, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(n))


class Experts(nn.Module):
    def __init__(self, n: int, d: int, width: int):
        super().__init__()
        self.gate_up = nn.Parameter(torch.empty(n, 2 * width, d))
        self.down = nn.Parameter(torch.empty(n, d, width))


class MoE(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.k, self.scale = c["num_experts_per_tok"], c["routed_scaling_factor"]
        self.norm = c["norm_topk_prob"]
        self.gate = Router(c["hidden_size"], c["n_routed_experts"])
        self.experts = Experts(c["n_routed_experts"], c["hidden_size"], c["moe_intermediate_size"])
        self.shared_experts = MLP(c["hidden_size"], c["moe_intermediate_size"] * c["n_shared_experts"])

    def forward(self, x):
        s = torch.sigmoid(x @ f32(self.gate.weight).T)
        chosen = torch.topk(s + f32(self.gate.e_score_correction_bias), self.k, dim=-1).indices
        w = s.gather(1, chosen)
        if self.norm:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        w = w * self.scale
        out = self.shared_experts(x)
        for e in torch.unique(chosen).tolist():
            rows, slots = (chosen == e).nonzero(as_tuple=True)
            gate, up = (x[rows] @ f32(self.experts.gate_up[e]).T).chunk(2, dim=-1)
            y = (F.silu(gate) * up) @ f32(self.experts.down[e]).T
            out = out.index_add(0, rows, y * w[rows, slots, None])
        return out


class Block(nn.Module):
    def __init__(self, c: dict, layer: int):
        super().__init__()
        self.input_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.self_attn = Attention(c)
        self.post_attention_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        dense = layer < c["first_k_dense_replace"]
        self.mlp = MLP(c["hidden_size"], c["intermediate_size"]) if dense else MoE(c)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class Decoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layers = nn.ModuleList([Block(c, i) for i in range(c["num_hidden_layers"])])
        self.norm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.dr, self.theta = c["qk_rope_head_dim"], c["rope_theta"]

    def forward(self, x):
        pos = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)
        inv = 1.0 / (self.theta ** (torch.arange(0, self.dr, 2, dtype=torch.float32, device=x.device) / self.dr))
        ang = pos[:, None] * inv[None, :]
        ang = torch.cat([ang, ang], dim=-1)
        cos, sin = torch.cos(ang), torch.sin(ang)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)


def head_size(c: dict) -> int:
    return c["speech_token_size"] + c["extra_tokens"]


class SpeechLM(nn.Module):
    """CosyVoice3LM's tables and bias-free head around the decoder."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.embed_tokens = nn.Embedding(c["vocab_size"], c["hidden_size"])
        self.speech_embedding = nn.Embedding(head_size(c), c["llm_input_size"])
        self.llm = Decoder(c)
        self.llm_decoder = Linear(c["llm_output_size"], head_size(c))

    def plan(self, text, prompt_speech=np.zeros(0, np.int64)) -> tuple[list, list]:
        """(src, ids) of the inference prompt [sos, text, task, prompt_speech]."""
        s = self.c["speech_token_size"]
        text, prompt_speech = [int(t) for t in text], [int(t) for t in prompt_speech]
        return [SPEECH] + [TEXT] * len(text) + [SPEECH] * (1 + len(prompt_speech)), [s] + text + [s + 2] + prompt_speech

    def logits(self, src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Logits (L, head) after every position of one sequence."""
        text = f32(self.embed_tokens.weight)[ids.clamp(0, self.c["vocab_size"] - 1)]
        speech = f32(self.speech_embedding.weight)[ids.clamp(0, head_size(self.c) - 1)]
        x = torch.where((src == TEXT)[:, None], text, speech)
        return self.llm_decoder(self.llm(x))

    @torch.no_grad()
    def served_logits(self, text, prompt_speech, served) -> torch.Tensor:
        """Logits (n, head) that predict each of the n served tokens, given
        the prompt and the served tokens before it (teacher-forced)."""
        src, ids = self.plan(text, prompt_speech)
        served = [int(t) for t in served]
        dev = self.embed_tokens.weight.device
        src = torch.tensor(src + [SPEECH] * (len(served) - 1), device=dev)
        ids = torch.tensor(ids + served[:-1], device=dev)
        return self.logits(src, ids)[len(src) - len(served):]
