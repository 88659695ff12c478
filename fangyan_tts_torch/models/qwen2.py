"""Qwen2-style decoder backbone (fangyan_tts_tpu/models/qwen2.py).

Parameters follow the JAX tree with the layer axis unstacked:
`layers.{i}.self_attn.qkv_proj` (fused q/k/v with bias), `.o_proj`,
`.mlp.gate_up_proj` (fused gate/up), `.mlp.down_proj`, the two RMSNorms,
and the final `norm`. Linear weights are torch's (out, in); under
`quant_int8` (and `quant_int4_mlp`) the dense layers are QLinear, in the
JAX package's quantized names and (in, out) layout.

The stacked KV cache is a dict {'k', 'v': (L, B, S, KV, hd), 'index': (B,)
int32 next write slot}. A prompt prefill (T > 1) writes slots
[index, index + T) and attends over the whole buffer in plain PyTorch, as
the JAX package leaves it to XLA; a single-step decode goes through
ops/decode_attention.decode_attention, which writes the new row in place.
With cache=None (the training forward) the same dense attention runs over
the call's own keys and nothing is written; there `QwenConfig.remat`
recomputes each block in the backward pass ("full") or keeps its matmul
outputs and recomputes the rest ("dots"), as the JAX package's nn.remat
does. Decode and prefill ignore remat.
Every matmul casts its weight to the activation dtype, as the JAX QDense
does, so a float32 model decodes in the cache's bfloat16.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..config import QwenConfig, reject_unported
from ..ops.decode_attention import decode_attention
from ..ops.int4_matmul import int4_matmul
from ..ops.quant import int8_dot


class QLinear(nn.Module):
    """The JAX QDense's quantized parameters in its own names and (in, out)
    layout: `kernel_q` (in, out) int8 (bits=8) or `kernel_q4` (in//2, out)
    int8 nibble pairs (bits=4), `scale` (out,) float32 per output channel,
    and an optional `bias`. Made by ops/quant.quantize_*_state."""

    def __init__(self, d_in: int, d_out: int, bias: bool, bits: int):
        super().__init__()
        self.bits = bits
        if bits == 4:
            self.register_buffer("kernel_q4", torch.zeros((d_in // 2, d_out), dtype=torch.int8))
        else:
            self.register_buffer("kernel_q", torch.zeros((d_in, d_out), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(d_out))
        self.register_buffer("bias", torch.zeros(d_out) if bias else None)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # load_state_dict checks shapes only: refuse float weights here, which
        # would otherwise run through int8_dot / int4_matmul as if quantized
        for name, dtype in (("kernel_q4" if self.bits == 4 else "kernel_q", torch.int8), ("scale", torch.float32)):
            t = state_dict.get(prefix + name)
            if t is not None and t.dtype != dtype:
                raise ValueError(f"QLinear {prefix}{name} must be {dtype} (from ops/quant.quantize_*_state), "
                                 f"got {t.dtype}")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def dense(d_in: int, d_out: int, bias: bool, bits: int = 0) -> nn.Module:
    """A QDense's parameters: nn.Linear (bits 0) or QLinear (int8 / int4)."""
    return QLinear(d_in, d_out, bias, bits) if bits else nn.Linear(d_in, d_out, bias=bias)


def qdense(x: torch.Tensor, lin: nn.Module) -> torch.Tensor:
    """The JAX QDense: x @ W in x's dtype (int8: ops/quant.int8_dot; int4:
    the ops/int4_matmul kernel), then the bias in the result's."""
    if isinstance(lin, QLinear):
        y = int4_matmul(x, lin.kernel_q4, lin.scale) if lin.bits == 4 else int8_dot(x, lin.kernel_q, lin.scale)
    else:
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


def dense_attention(q, k, v, attn_bias, dtype: torch.dtype) -> torch.Tensor:
    """The JAX Qwen2Attention's dense GQA attention: q (B, T, QH, hd), k, v
    (B, S, KV, hd), attn_bias (B, T, >= S) additive float32. Scores in
    `dtype` divided by sqrt(hd), then the bias and the softmax in float32,
    the probabilities cast back to `dtype`. Returns (B, T, QH * hd)."""
    b, t, qh, hd = q.shape
    kvh, tk = k.shape[2], k.shape[1]
    qg = q.reshape(b, t, kvh, qh // kvh, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k) / math.sqrt(hd)
    scores = scores.float() + attn_bias[:, None, None, :, :tk]
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bkgts,bskh->btkgh", probs, v).reshape(b, t, qh * hd)


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.nq, self.nkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
        bits = 8 if cfg.quant_int8 else 0
        self.qkv_proj = dense(cfg.hidden_size, self.nq + 2 * self.nkv, True, bits)
        self.o_proj = dense(self.nq, cfg.hidden_size, False, bits)

    def forward(self, x, cos, sin, attn_bias, layer: int, cache: dict | None = None):
        c = self.cfg
        b, t, _ = x.shape
        hd, qh, kvh = c.head_dim, c.num_attention_heads, c.num_key_value_heads
        qkv = qdense(x, self.qkv_proj)
        q, k, v = torch.split(qkv, [self.nq, self.nkv, self.nkv], dim=-1)
        q = apply_rope(q.reshape(b, t, qh, hd), cos, sin)
        k = apply_rope(k.reshape(b, t, kvh, hd), cos, sin)
        v = v.reshape(b, t, kvh, hd)

        if cache is None:  # the training forward: the call's own keys, no cache write
            return qdense(dense_attention(q, k, v, attn_bias, x.dtype), self.o_proj)
        if t == 1:
            # v[:, 0] stays a view of the qkv buffer (a batch stride): the kernel reads it as it is
            ck = cache["k"]
            out = decode_attention(
                q[:, 0].to(ck.dtype), k[:, 0].to(ck.dtype), v[:, 0].to(ck.dtype), ck, cache["v"], cache["index"],
                attn_bias[:, 0, :].float().contiguous(), layer,
            )
            return qdense(out.to(x.dtype).reshape(b, 1, self.nq), self.o_proj)

        # prefill: every row writes the same slots [index, index + t)
        i0 = int(cache["index"][0])
        cache["k"][layer, :, i0 : i0 + t] = k.to(cache["k"].dtype)
        cache["v"][layer, :, i0 : i0 + t] = v.to(cache["v"].dtype)
        k, v = cache["k"][layer].to(x.dtype), cache["v"][layer].to(x.dtype)
        return qdense(dense_attention(q, k, v, attn_bias, x.dtype), self.o_proj)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        bits = (4 if cfg.quant_int4_mlp else 8) if cfg.quant_int8 else 0
        self.gate_up_proj = dense(cfg.hidden_size, 2 * cfg.intermediate_size, False, bits)
        self.down_proj = dense(cfg.intermediate_size, cfg.hidden_size, False, bits)

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

    def forward(self, x, cos, sin, attn_bias, layer: int, cache: dict | None = None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_bias, layer, cache)
        return x + self.mlp(self.post_attention_layernorm(x))


# remat "dots" keeps what jax.checkpoint_policies.dots_saveable keeps: the
# outputs of the matrix products
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


class Qwen2Model(nn.Module):
    """The decoder stack on input embeddings (the speech LM mixes text,
    speech and special embeddings upstream)."""

    def __init__(self, cfg: QwenConfig):
        super().__init__()
        reject_unported(cfg)
        if cfg.remat not in ("", "full", "dots"):
            raise ValueError(f"QwenConfig.remat must be '', 'full' or 'dots', got {cfg.remat!r}")
        self.cfg = cfg
        self.layers = nn.ModuleList([Qwen2Block(cfg) for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds, positions, attn_bias, cache: dict | None = None):
        """inputs_embeds (B, T, D); positions (B, T); attn_bias (B, T, S)
        additive float32. With a cache, updates it in place (index advances
        by T); without one (training), attends over the T inputs themselves
        (S = T) and remats each block when `cfg.remat` is set and autograd
        records."""
        c = self.cfg
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta, dtype=inputs_embeds.dtype)
        x = inputs_embeds
        remat = cache is None and c.remat and torch.is_grad_enabled()
        policy = {"context_fn": functools.partial(create_selective_checkpoint_contexts, _dots_saveable)} \
            if c.remat == "dots" else {}
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(layer, x, cos, sin, attn_bias, i, None, use_reentrant=False, **policy)
            else:
                x = layer(x, cos, sin, attn_bias, i, cache)
        if cache is not None:
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


def causal_attn_bias(t: int, device=None) -> torch.Tensor:
    """(1, T, T) additive float32 causal bias: 0 where key <= query, -1e10
    elsewhere."""
    pos = torch.arange(t, dtype=torch.int32, device=device)
    return torch.where(pos[None, :] <= pos[:, None], 0.0, -1e10).to(torch.float32)[None]


def prefill_attn_bias(t: int, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, T) causal + right-padding bias of a variable-length batch:
    keys at or past a row's length are masked (-1e10 added)."""
    pos = torch.arange(t, dtype=torch.int32, device=lengths.device)[None, :]
    pad = torch.where(pos < lengths[:, None], 0.0, -1e10).to(torch.float32)
    return causal_attn_bias(t, lengths.device) + pad[:, None, :]
