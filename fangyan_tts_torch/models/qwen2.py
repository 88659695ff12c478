"""Qwen2-style decoder backbone (fangyan_tts_tpu/models/qwen2.py).

Parameters follow the JAX tree with the layer axis unstacked:
`layers.{i}.self_attn.qkv_proj` (fused q/k/v with bias), `.o_proj`,
`.mlp.gate_up_proj` (fused gate/up), `.mlp.down_proj`, the two RMSNorms,
and the final `norm`. Linear weights are torch's (out, in).

The stacked KV cache is a dict {'k', 'v': (L, B, S, KV, hd), 'index': (B,)
int32 next write slot}. A prompt prefill (T > 1) writes slots
[index, index + T) and attends over the whole buffer in plain PyTorch, as
the JAX package leaves it to XLA; a single-step decode goes through
ops/decode_attention.decode_attention, which writes the new row in place.
Every matmul casts its weight to the activation dtype, as the JAX QDense
does, so a float32 model decodes in the cache's bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import QwenConfig, reject_unported
from ..ops.decode_attention import decode_attention


def qdense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """The JAX QDense: x @ W in x's dtype, then the bias in the result's."""
    y = F.linear(x, lin.weight.to(x.dtype))
    if lin.bias is not None:
        y = y + lin.bias.to(y.dtype)
    return y


def flax_dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype | None = None) -> torch.Tensor:
    """flax nn.Dense: input, kernel and bias promoted to one dtype (or cast
    to `dtype`), then x @ W + b."""
    if dtype is None:
        dtype = torch.promote_types(x.dtype, lin.weight.dtype)
        if lin.bias is not None:
            dtype = torch.promote_types(dtype, lin.bias.dtype)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    if lin.bias is not None:
        y = y + lin.bias.to(dtype)
    return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        var = (x * x).mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps)
        return (x * self.weight).to(dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float, dtype=torch.float32):
    """positions (B, T) -> cos, sin (B, T, head_dim); NeoX half rotation."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv_freq[None, None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, hd); cos/sin (B, T, hd)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.nq, self.nkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
        self.qkv_proj = nn.Linear(cfg.hidden_size, self.nq + 2 * self.nkv, bias=True)
        self.o_proj = nn.Linear(self.nq, cfg.hidden_size, bias=False)

    def forward(self, x, cos, sin, attn_bias, layer: int, cache: dict):
        c = self.cfg
        b, t, _ = x.shape
        hd, qh, kvh = c.head_dim, c.num_attention_heads, c.num_key_value_heads
        qkv = qdense(x, self.qkv_proj)
        q, k, v = torch.split(qkv, [self.nq, self.nkv, self.nkv], dim=-1)
        q = apply_rope(q.reshape(b, t, qh, hd), cos, sin)
        k = apply_rope(k.reshape(b, t, kvh, hd), cos, sin)
        v = v.reshape(b, t, kvh, hd)

        if t == 1:
            ck = cache["k"]
            out = decode_attention(
                q[:, 0].to(ck.dtype).contiguous(), k[:, 0].to(ck.dtype).contiguous(),
                v[:, 0].to(ck.dtype).contiguous(), ck, cache["v"], cache["index"],
                attn_bias[:, 0, :].float().contiguous(), layer,
            )
            return qdense(out.to(x.dtype).reshape(b, 1, self.nq), self.o_proj)

        # prefill: every row writes the same slots [index, index + t)
        i0 = int(cache["index"][0])
        cache["k"][layer, :, i0 : i0 + t] = k.to(cache["k"].dtype)
        cache["v"][layer, :, i0 : i0 + t] = v.to(cache["v"].dtype)
        k, v = cache["k"][layer].to(x.dtype), cache["v"][layer].to(x.dtype)

        groups = qh // kvh
        tk = k.shape[1]
        qg = q.reshape(b, t, kvh, groups, hd)
        scores = torch.einsum("btkgh,bskh->bkgts", qg, k) / math.sqrt(hd)
        scores = scores.float() + attn_bias[:, None, None, :, :tk]
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkgts,bskh->btkgh", probs, v).reshape(b, t, self.nq)
        return qdense(out, self.o_proj)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.gate_up_proj = nn.Linear(cfg.hidden_size, 2 * cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x):
        gate, up = qdense(x, self.gate_up_proj).chunk(2, dim=-1)
        return qdense(F.silu(gate) * up, self.down_proj)


class Qwen2Block(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Qwen2Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = Qwen2MLP(cfg)

    def forward(self, x, cos, sin, attn_bias, layer: int, cache: dict):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_bias, layer, cache)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2Model(nn.Module):
    """The decoder stack on input embeddings (the speech LM mixes text,
    speech and special embeddings upstream)."""

    def __init__(self, cfg: QwenConfig):
        super().__init__()
        reject_unported(cfg)
        self.cfg = cfg
        self.layers = nn.ModuleList([Qwen2Block(cfg) for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds, positions, attn_bias, cache: dict):
        """inputs_embeds (B, T, D); positions (B, T); attn_bias (B, T, S)
        additive float32. Updates `cache` in place (index advances by T)."""
        c = self.cfg
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta, dtype=inputs_embeds.dtype)
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, attn_bias, i, cache)
        cache["index"] += inputs_embeds.shape[1]
        return self.norm(x)


def init_cache(cfg: QwenConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed stacked KV cache; every row's next write slot is 0."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
