"""The CosyVoice speech-token LM on the Qwen2 decoder, float32, one row at a
time over the whole sequence (no KV cache, no padding, no batching).

The sequence is the inference prompt [sos, text, task, prompt speech]
followed by the served speech tokens: text ids go through the Qwen text
table, special and speech ids through the speech table (CosyVoice3), or sos
and task through the 2-row `llm_embedding` table (CosyVoice2). The decoder
is pre-norm RMSNorm blocks with grouped-query attention under NeoX rotary
embeddings at positions 0..L-1 and a SiLU-gated MLP; the head maps the last
norm's output to the speech vocabulary (with a bias in CosyVoice2).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

TEXT, SPEECH, SPECIAL = 0, 1, 2


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * self.weight


class Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.qh, self.kvh, self.hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        self.qkv_proj = nn.Linear(c["hidden_size"], (self.qh + 2 * self.kvh) * self.hd, bias=True)
        self.o_proj = nn.Linear(self.qh * self.hd, c["hidden_size"], bias=False)

    def forward(self, x, cos, sin):
        l = x.shape[0]
        q, k, v = self.qkv_proj(x).split([self.qh * self.hd, self.kvh * self.hd, self.kvh * self.hd], dim=-1)
        q = rope(q.reshape(l, self.qh, self.hd), cos, sin).transpose(0, 1)  # (QH, L, hd)
        k = rope(k.reshape(l, self.kvh, self.hd), cos, sin).transpose(0, 1)
        v = v.reshape(l, self.kvh, self.hd).transpose(0, 1)
        g = self.qh // self.kvh
        k, v = k.repeat_interleave(g, dim=0), v.repeat_interleave(g, dim=0)
        scores = q @ k.transpose(1, 2) / math.sqrt(self.hd)
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        return self.o_proj((probs @ v).transpose(0, 1).reshape(l, self.qh * self.hd))


class MLP(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.gate_up_proj = nn.Linear(c["hidden_size"], 2 * c["intermediate_size"], bias=False)
        self.down_proj = nn.Linear(c["intermediate_size"], c["hidden_size"], bias=False)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


class Block(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.input_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.self_attn = Attention(c)
        self.post_attention_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.mlp = MLP(c)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class Decoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layers = nn.ModuleList([Block(c) for _ in range(c["num_hidden_layers"])])
        self.norm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.hd, self.theta = c["head_dim"], c["rope_theta"]

    def forward(self, x):
        pos = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)
        inv = 1.0 / (self.theta ** (torch.arange(0, self.hd, 2, dtype=torch.float32, device=x.device) / self.hd))
        ang = pos[:, None] * inv[None, :]
        ang = torch.cat([ang, ang], dim=-1)
        cos, sin = torch.cos(ang), torch.sin(ang)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)


def rope(x, cos, sin):
    """NeoX half rotation: x (L, H, hd), cos / sin (L, hd)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rotated * sin[:, None]


def head_size(c: dict) -> int:
    return c["speech_token_size"] + c["extra_tokens"]


class SpeechLM(nn.Module):
    """`version` 3: CosyVoice3LM's tables and a bias-free head; 2: the
    CosyVoice2 LM's 2-row special table and a head with a bias."""

    def __init__(self, c: dict, version: int = 3):
        super().__init__()
        self.c, self.version = c, version
        self.embed_tokens = nn.Embedding(c["vocab_size"], c["hidden_size"])
        self.speech_embedding = nn.Embedding(head_size(c), c["llm_input_size"])
        if version == 2:
            self.llm_embedding = nn.Embedding(2, c["llm_input_size"])
        self.llm = Decoder(c)
        self.llm_decoder = nn.Linear(c["llm_output_size"], head_size(c), bias=version == 2)

    def plan(self, text: np.ndarray, prompt_speech: np.ndarray = np.zeros(0, np.int64)) -> tuple[list, list]:
        """(src, ids) of the inference prompt [sos, text, task, prompt_speech]."""
        s = self.c["speech_token_size"]
        text, prompt_speech = [int(t) for t in text], [int(t) for t in prompt_speech]
        if self.version == 2:  # sos and task are rows 0 and 1 of the special table
            return ([SPECIAL] + [TEXT] * len(text) + [SPECIAL] + [SPEECH] * len(prompt_speech),
                    [0] + text + [1] + prompt_speech)
        return ([SPEECH] + [TEXT] * len(text) + [SPEECH] + [SPEECH] * len(prompt_speech),
                [s] + text + [s + 2] + prompt_speech)

    @torch.no_grad()
    def served_logits(self, text, prompt_speech, served) -> torch.Tensor:
        """Logits (n, head) that predict each of the n served tokens, given
        the prompt and the served tokens before it."""
        src, ids = self.plan(text, prompt_speech)
        served = [int(t) for t in served]
        src = torch.tensor(src + [SPEECH] * (len(served) - 1))
        ids = torch.tensor(ids + served[:-1])
        dev = self.embed_tokens.weight.device
        src, ids = src.to(dev), ids.to(dev)
        x = torch.where((src == TEXT)[:, None], self.embed_tokens(ids.clamp(0, self.c["vocab_size"] - 1)),
                        self.speech_embedding(ids.clamp(0, head_size(self.c) - 1)))
        if self.version == 2:
            x = torch.where((src == SPECIAL)[:, None], self.llm_embedding(ids.clamp(0, 1)), x)
        h = self.llm(x)
        return self.llm_decoder(h[len(src) - len(served):])
