"""The 1-D U-Net CFM estimator of the CosyVoice1/2 flows
(fangyan_tts_tpu/models/unet_decoder.py, `ConditionalDecoder`).

[x, mu, spks, cond] packed on channels; down / mid / up levels of a
ResnetBlock1D and BasicTransformerBlocks, stride-2 down and transposed-conv
up convolutions between non-final levels, skip connections, a final block.
The causal variant (v2) uses left-padded convolutions and LayerNorm, and
with `streaming` a chunk-causal attention mask (`_bias`); the non-causal
one (v1) symmetric convolutions and a GroupNorm whose statistics count only
valid frames, so that padded buckets give the unpadded result.

The attention of `BasicTransformerBlock` is plain PyTorch, as it is an
einsum in the JAX package (no Pallas kernel there). Mid levels are a
`nn.ModuleList` (the JAX package's nn.scan stack `mid`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convs import causal_conv1d_left, conv1d, conv_transpose1d
from ..ops.masks import chunk_attn_mask
from .dit import ConvParams, tconv_params
from .qwen2 import flax_dense
from .s3tokenizer import LayerNorm


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """t (B,) -> (B, dim) float32 [sin, cos]."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class MaskedGroupNorm(nn.Module):
    """GroupNorm whose statistics count only the valid time positions."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, h, mask):  # (B, T, C); mask (B, T, 1)
        b, l, c = h.shape
        g = self.groups
        m = mask.reshape(b, l, 1, 1).to(h.dtype)
        hg = h.reshape(b, l, g, c // g) * m
        cnt = torch.clamp(m.sum(dim=1, keepdim=True) * (c // g), min=1.0)
        mean = hg.sum(dim=(1, 3), keepdim=True) / cnt
        var = (((hg - mean) * m) ** 2).sum(dim=(1, 3), keepdim=True) / cnt
        out = (hg - mean) / torch.sqrt(var + self.eps)
        return out.reshape(b, l, c) * self.scale.to(h.dtype) + self.bias.to(h.dtype)


class Block1D(nn.Module):
    """Conv k3 + GroupNorm(8) + Mish, or (causal) a left-padded conv +
    LayerNorm + Mish; masked in and out."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8, causal: bool = False):
        super().__init__()
        self.causal = causal
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, 3))
        self.bias = nn.Parameter(torch.zeros(dim_out))
        self.norm = LayerNorm(dim_out) if causal else MaskedGroupNorm(groups, dim_out)

    def forward(self, x, mask):
        h = x * mask
        k, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if self.causal:
            h = self.norm(causal_conv1d_left(h, k, b))
        else:
            h = self.norm(conv1d(h, k, b, padding=1), mask)
        return mish(h) * mask


class ResnetBlock1D(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, time_dim: int, causal: bool = False):
        super().__init__()
        self.block1 = Block1D(dim_in, dim_out, causal=causal)
        self.mlp = nn.Linear(time_dim, dim_out)
        self.block2 = Block1D(dim_out, dim_out, causal=causal)
        self.res = ConvParams(dim_in, dim_out, 1)

    def forward(self, x, mask, t_emb):
        h = self.block1(x, mask)
        h = h + flax_dense(mish(t_emb), self.mlp, x.dtype)[:, None, :]
        h = self.block2(h, mask)
        return h + conv1d(x * mask, self.res.weight.to(x.dtype), self.res.bias.to(x.dtype))


class BasicTransformerBlock(nn.Module):
    """LayerNorm -> self-attention (additive float32 bias), LayerNorm ->
    GELU feed-forward, both residual."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.norm1 = LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.norm3 = LayerNorm(dim)
        self.ff_in = nn.Linear(dim, dim * 4)
        self.ff_out = nn.Linear(dim * 4, dim)

    def forward(self, x, attn_bias):  # x (B, T, C); attn_bias (B, T, T) float32
        b, t, _ = x.shape
        dt = x.dtype
        h = self.norm1(x)
        q = flax_dense(h, self.to_q, dt).reshape(b, t, self.heads, self.head_dim)
        k = flax_dense(h, self.to_k, dt).reshape(b, t, self.heads, self.head_dim)
        v = flax_dense(h, self.to_v, dt).reshape(b, t, self.heads, self.head_dim)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.head_dim)
        probs = torch.softmax(scores.float() + attn_bias[:, None], dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, -1)
        x = x + flax_dense(o, self.to_out, dt)
        h = self.norm3(x)
        h = F.gelu(flax_dense(h, self.ff_in, x.dtype))
        return x + flax_dense(h, self.ff_out, x.dtype)


class _Level(nn.Module):
    """A resnet block and n transformer blocks (one down / mid / up level)."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int, n_blocks: int, heads: int, head_dim: int,
                 causal: bool = False):
        super().__init__()
        self.n_blocks = n_blocks
        self.resnet = ResnetBlock1D(dim_in, dim_out, time_dim, causal=causal)
        for j in range(n_blocks):
            setattr(self, f"tb_{j}", BasicTransformerBlock(dim_out, heads, head_dim))

    def forward(self, x, mask, t_emb, attn_bias):
        x = self.resnet(x, mask, t_emb)
        for j in range(self.n_blocks):
            x = getattr(self, f"tb_{j}")(x, attn_bias)
        return x


class _MidLevel(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()
        self.level = _Level(*args, **kwargs)


class ConditionalDecoder(nn.Module):
    """forward(x, mu, t, spks, cond, lengths, streaming) -> velocity
    (B, T, out), channels-last."""

    def __init__(self, in_channels: int = 320, out_channels: int = 80, channels: Sequence[int] = (256,),
                 n_blocks: int = 4, num_mid_blocks: int = 12, num_heads: int = 8, attention_head_dim: int = 64,
                 causal: bool = False, static_chunk_size: int = 50):
        super().__init__()
        self.in_channels, self.channels = in_channels, tuple(channels)
        self.causal, self.static_chunk_size = causal, static_chunk_size
        ch = self.channels
        ted = ch[0] * 4
        lvl = dict(n_blocks=n_blocks, heads=num_heads, head_dim=attention_head_dim, causal=causal)
        self.time_mlp_1 = nn.Linear(in_channels, ted)
        self.time_mlp_2 = nn.Linear(ted, ted)
        prev = in_channels
        for i, c in enumerate(ch):
            setattr(self, f"down_{i}", _Level(prev, c, ted, **lvl))
            setattr(self, f"down_conv_{i}", ConvParams(c, c, 3))
            prev = c
        self.mid = nn.ModuleList([_MidLevel(ch[-1], ch[-1], ted, **lvl) for _ in range(num_mid_blocks)])
        for i, c in enumerate(reversed(ch)):
            setattr(self, f"up_{i}", _Level(prev + c, c, ted, **lvl))
            if i == len(ch) - 1:
                setattr(self, f"up_conv_{i}", ConvParams(c, c, 3))
            else:
                setattr(self, f"up_tconv_{i}", tconv_params(c, c, 4))
            prev = c
        self.final_block = Block1D(ch[0], ch[0], causal=causal)
        self.final_proj = ConvParams(ch[0], out_channels, 1)

    def _bias(self, lengths, t: int, streaming: bool) -> torch.Tensor:
        """(B, t, t) float32: 0 where a key may be attended, -1e10 where not
        (key padding, and chunk causality for the causal streaming form)."""
        chunk = self.static_chunk_size if (streaming and self.causal) else 0
        m = chunk_attn_mask(lengths, t, chunk)
        return torch.where(m, 0.0, -1e10).to(torch.float32)

    def _conv(self, h, mask, p: nn.Module):
        k, b = p.weight.to(h.dtype), p.bias.to(h.dtype)
        return causal_conv1d_left(h * mask, k, b) if self.causal else conv1d(h * mask, k, b, padding=1)

    def forward(self, x, mu, t, spks, cond, lengths, streaming: bool = False):
        """x / mu / cond (B, T, 80); t (B,); spks (B, 80); lengths (B,)."""
        b, tt, _ = x.shape
        dt = x.dtype
        t_emb = sinusoidal_pos_emb(t, self.in_channels).to(dt)
        t_emb = flax_dense(F.silu(flax_dense(t_emb, self.time_mlp_1, dt)), self.time_mlp_2, dt)
        h = torch.cat([x, mu, spks[:, None, :].expand(b, tt, spks.shape[-1]).to(dt), cond], dim=-1)

        ch = self.channels
        lens = lengths
        cur_t = tt
        hiddens, lens_stack = [], []
        dev = x.device
        for i in range(len(ch)):
            mask = (torch.arange(cur_t, device=dev)[None, :] < lens[:, None])[..., None].to(dt)
            h = getattr(self, f"down_{i}")(h, mask, t_emb, self._bias(lens, cur_t, streaming))
            hiddens.append(h)
            lens_stack.append(lens)
            p = getattr(self, f"down_conv_{i}")
            if i == len(ch) - 1:
                h = self._conv(h, mask, p)
            else:  # a real stride-2 downsample
                h = conv1d(h * mask, p.weight.to(h.dtype), p.bias.to(h.dtype), stride=2, padding=1)
                lens = (lens + 1) // 2
                cur_t = h.shape[1]

        mask = (torch.arange(cur_t, device=dev)[None, :] < lens[:, None])[..., None].to(dt)
        bias = self._bias(lens, cur_t, streaming)
        for m in self.mid:
            h = m.level(h, mask, t_emb, bias)

        for i in range(len(ch)):
            skip = hiddens.pop()
            lens = lens_stack.pop()
            h = torch.cat([h[:, : skip.shape[1]], skip], dim=-1)
            cur_t = h.shape[1]
            mask = (torch.arange(cur_t, device=dev)[None, :] < lens[:, None])[..., None].to(dt)
            h = getattr(self, f"up_{i}")(h, mask, t_emb, self._bias(lens, cur_t, streaming))
            if i == len(ch) - 1:
                h = self._conv(h, mask, getattr(self, f"up_conv_{i}"))
            else:  # transposed-conv x2 upsample
                p = getattr(self, f"up_tconv_{i}")
                h = conv_transpose1d(h * mask, p.weight.to(h.dtype), p.bias.to(h.dtype), stride=2, padding=1)

        mask = (torch.arange(h.shape[1], device=dev)[None, :] < lens[:, None])[..., None].to(dt)
        h = self.final_block(h, mask)
        out = conv1d(h * mask, self.final_proj.weight.to(h.dtype), self.final_proj.bias.to(h.dtype))
        return out * mask
