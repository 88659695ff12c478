"""Conformer / Transformer encoder stacks of the CosyVoice1/2 families
(fangyan_tts_tpu/models/conformer.py).

- `RelPositionAttention`: Transformer-XL relative attention with the
  u / v biases and the espnet rel-shift; with `kv_cache` the streaming
  chunk form over a fixed-size rolling cache.
- `ConformerEncoderLayer` (optional macaron FFN and convolution module),
  `LinearEmbed` (the linear input layer, with the legacy ReLU of the v1 LM),
  `UpsampleConformerEncoder` (the v2 flow encoder: embed, lookahead,
  blocks, x2 upsampling, blocks) and `ConformerEncoder` (the v1 LM text
  encoder, the v1 LM stack and the v1 flow encoder) with its streaming
  `init_chunk_state` / `forward_chunk`.

Layers are per-layer `nn.ModuleList`s (the JAX package's nn.scan stacks
`encoders` / `up_encoders` unstacked by models/from_jax.py). Tensors are
channels-last, and every dense layer computes in the dtype the JAX module
names (`dtype=x.dtype`), so mixed-dtype promotion follows flax.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convs import conv1d
from ..ops.masks import chunk_attn_mask
from .dit import ConvParams
from .qwen2 import flax_dense
from .s3tokenizer import LayerNorm


@functools.lru_cache(maxsize=None)
def espnet_rel_pos_table(max_len: int, d_model: int) -> np.ndarray:
    """(1, 2*max_len-1, d) float32: the positive positions flipped, then the
    negative ones from -1 on (distances max_len-1 .. -(max_len-1))."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pos = np.zeros((max_len, d_model))
    neg = np.zeros((max_len, d_model))
    pos[:, 0::2] = np.sin(position * div)
    pos[:, 1::2] = np.cos(position * div)
    neg[:, 0::2] = np.sin(-position * div)
    neg[:, 1::2] = np.cos(-position * div)
    pe = np.concatenate([pos[::-1], neg[1:]], axis=0)[None]
    return pe.astype(np.float32)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T1, 2*T1-1) -> (B, H, T1, T1)."""
    b, h, t1, n = x.shape
    x_padded = torch.cat([x.new_zeros((b, h, t1, 1)), x], dim=-1).reshape(b, h, n + 1, t1)
    return x_padded[:, :, 1:].reshape(b, h, t1, n)[:, :, :, : n // 2 + 1]


class RelPositionAttention(nn.Module):
    def __init__(self, heads: int, dim: int, key_bias: bool = True):
        super().__init__()
        self.heads, self.dim = heads, dim
        dk = dim // heads
        self.linear_q = nn.Linear(dim, dim)
        self.linear_k = nn.Linear(dim, dim, bias=key_bias)
        self.linear_v = nn.Linear(dim, dim)
        self.linear_pos = nn.Linear(dim, dim, bias=False)
        self.linear_out = nn.Linear(dim, dim)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, dk))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor, attn_mask: torch.Tensor, kv_cache=None):
        """x (B, T, D); pos_emb (1, 2T-1, D), or with kv_cache ((B, Tc, H, dk)
        keys and values) the distances K-1 .. -(C-1) of the chunk; attn_mask
        (B, T, K) bool. Returns out, or (out, new cache) with kv_cache."""
        h, dk = self.heads, self.dim // self.heads
        b, t, _ = x.shape
        dt = x.dtype
        q = flax_dense(x, self.linear_q, dt).reshape(b, t, h, dk)
        k = flax_dense(x, self.linear_k, dt).reshape(b, t, h, dk)
        v = flax_dense(x, self.linear_v, dt).reshape(b, t, h, dk)
        p = flax_dense(pos_emb, self.linear_pos, dt).reshape(1, -1, h, dk)
        new_cache = None
        if kv_cache is not None:
            kc, vc = kv_cache
            k = torch.cat([kc.to(dt), k], dim=1)
            v = torch.cat([vc.to(dt), v], dim=1)
            new_cache = (k[:, -kc.shape[1]:], v[:, -vc.shape[1]:])
        ac = torch.einsum("bthd,bshd->bhts", q + self.pos_bias_u.to(dt), k)
        bd = torch.einsum("bthd,shd->bhts", q + self.pos_bias_v.to(dt), p[0])
        if kv_cache is not None:
            # row r of p is distance K-1-r; query t at key s is distance Tc+t-s: row (C-1)-t+s
            kk = k.shape[1]
            idx = (t - 1 - torch.arange(t, device=x.device))[:, None] + torch.arange(kk, device=x.device)[None, :]
            bd = torch.gather(bd, -1, idx[None, None].expand(b, h, t, kk))
        elif bd.shape != ac.shape:
            bd = rel_shift(bd)
        scores = (ac + bd) / math.sqrt(dk)
        mask = attn_mask[:, None]
        scores = torch.where(mask, scores.float(), torch.full_like(scores, -1e10, dtype=torch.float32))
        probs = torch.softmax(scores, dim=-1).to(dt)
        probs = torch.where(mask, probs, torch.zeros_like(probs))
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, self.dim)
        out = flax_dense(out, self.linear_out, dt)
        return out if kv_cache is None else (out, new_cache)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, activation: str = "swish"):
        super().__init__()
        self.activation = activation
        self.w_1 = nn.Linear(dim, hidden)
        self.w_2 = nn.Linear(hidden, dim)

    def forward(self, x):
        h = flax_dense(x, self.w_1, x.dtype)
        h = F.relu(h) if self.activation == "relu" else h * torch.sigmoid(h)
        return flax_dense(h, self.w_2, h.dtype)


class AffineParams(nn.Module):
    """A per-channel scale and bias that the JAX package keeps as flat
    `<name>_scale` / `<name>_bias` leaves (an inference BatchNorm, the
    regulator's GroupNorm affines); models/from_jax.py maps them here."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class ConvolutionModule(nn.Module):
    """Pointwise conv x2 + GLU, depthwise conv, LayerNorm (or an inference
    BatchNorm affine), swish, pointwise conv. `causal` left-pads the raw
    input (kernel-1 frames); with `cache` ((B, kernel-1, D) raw input) the
    streaming form."""

    def __init__(self, dim: int, kernel: int = 15, causal: bool = False, norm: str = "layer_norm"):
        super().__init__()
        self.dim, self.kernel, self.causal, self.norm_type = dim, kernel, causal, norm
        self.pw1 = ConvParams(dim, 2 * dim, 1)
        self.dw = ConvParams(dim, dim, kernel, groups=dim)
        if norm == "layer_norm":
            self.norm = LayerNorm(dim)
        else:
            self.bn = AffineParams(dim)
        self.pw2 = ConvParams(dim, dim, 1)

    def forward(self, x, pad_mask, cache=None):
        """x (B, T, D); pad_mask (B, T), 1 where valid."""
        x = x * pad_mask[..., None]
        new_cache = None
        if cache is not None:
            if not self.causal:
                raise ValueError("the convolution module's streaming cache needs causal convolutions")
            x = torch.cat([cache.to(x.dtype), x], dim=1)
            new_cache = x[:, -(self.kernel - 1):]
        elif self.causal:
            x = F.pad(x, (0, 0, self.kernel - 1, 0))
        h = conv1d(x, self.pw1.weight.to(x.dtype), self.pw1.bias.to(x.dtype))
        a, g = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(g)
        pad = (0, 0) if (cache is not None or self.causal) else ((self.kernel - 1) // 2, (self.kernel - 1) // 2)
        h = conv1d(h, self.dw.weight.to(x.dtype), self.dw.bias.to(x.dtype), padding=pad, groups=self.dim)
        if self.norm_type == "layer_norm":
            h = self.norm(h)
        else:
            h = h * self.bn.scale + self.bn.bias
        h = h * torch.sigmoid(h)
        h = conv1d(h, self.pw2.weight.to(x.dtype), self.pw2.bias.to(x.dtype))
        h = h * pad_mask[..., None]
        return h if cache is None else (h, new_cache)


class ConformerEncoderLayer(nn.Module):
    """Pre-norm conformer / transformer layer."""

    def __init__(self, dim: int, heads: int, ffn_hidden: int, macaron: bool = False, use_cnn: bool = False,
                 cnn_kernel: int = 15, cnn_causal: bool = False, cnn_norm: str = "layer_norm", key_bias: bool = True,
                 ffn_act: str = "swish"):
        super().__init__()
        self.macaron, self.use_cnn, self.cnn_causal = macaron, use_cnn, cnn_causal
        if macaron:
            self.norm_ff_macaron = LayerNorm(dim, eps=1e-12)
            self.ff_macaron = PositionwiseFeedForward(dim, ffn_hidden, ffn_act)
        self.norm_mha = LayerNorm(dim, eps=1e-12)
        self.self_attn = RelPositionAttention(heads, dim, key_bias)
        if use_cnn:
            self.norm_conv = LayerNorm(dim, eps=1e-12)
            self.conv_module = ConvolutionModule(dim, cnn_kernel, cnn_causal, cnn_norm)
            self.norm_final = LayerNorm(dim, eps=1e-12)
        self.norm_ff = LayerNorm(dim, eps=1e-12)
        self.ff = PositionwiseFeedForward(dim, ffn_hidden, ffn_act)

    def forward(self, x, pos_emb, attn_mask, pad_mask, caches=None):
        """caches None (the full forward), or this layer's streaming caches
        (att_k, att_v, cnn): then returns (x, new caches)."""
        if self.macaron:
            x = x + 0.5 * self.ff_macaron(self.norm_ff_macaron(x))
        h = self.norm_mha(x)
        if caches is None:
            x = x + self.self_attn(h, pos_emb, attn_mask)
        else:
            att_k, att_v, cnn_c = caches
            h_att, (nk, nv) = self.self_attn(h, pos_emb, attn_mask, kv_cache=(att_k, att_v))
            x = x + h_att
            ncnn = cnn_c
        if self.use_cnn:
            h = self.norm_conv(x)
            if caches is not None and self.cnn_causal:
                h_conv, ncnn = self.conv_module(h, pad_mask, cache=cnn_c)
                x = x + h_conv
            else:  # a non-causal conv pads each chunk symmetrically and keeps no cache
                x = x + self.conv_module(h, pad_mask)
        h = self.norm_ff(x)
        x = x + (0.5 if self.macaron else 1.0) * self.ff(h)
        if self.use_cnn:
            x = self.norm_final(x)
        return x if caches is None else (x, (nk, nv, ncnn))


class LinearEmbed(nn.Module):
    """Linear -> LayerNorm(1e-5) (-> ReLU with legacy_relu) -> x * sqrt(d),
    and the rel-pos table slice of the sequence."""

    def __init__(self, input_dim: int, dim: int, legacy_relu: bool = False):
        super().__init__()
        self.dim, self.legacy_relu = dim, legacy_relu
        self.linear = nn.Linear(input_dim, dim)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.norm(flax_dense(x, self.linear, x.dtype))
        if self.legacy_relu:
            x = F.relu(x)
        t = x.shape[1]
        table = espnet_rel_pos_table(max(t, 1), self.dim)
        center = table.shape[1] // 2
        pos = torch.from_numpy(table[:, center - (t - 1): center + t]).to(x.device, x.dtype)
        return x * math.sqrt(self.dim), pos


class UpsampleConformerEncoder(nn.Module):
    """The CosyVoice2 flow token encoder: embed, pre-lookahead layer,
    num_blocks layers, nearest x2 upsampling with a left-padded k=2s+1
    conv, re-embed, num_up_blocks layers, after_norm."""

    def __init__(self, dim: int = 512, heads: int = 8, ffn_hidden: int = 2048, num_blocks: int = 6,
                 num_up_blocks: int = 4, pre_lookahead_len: int = 3, static_chunk_size: int = 25, up_stride: int = 2):
        super().__init__()
        from .flow import PreLookaheadLayer

        self.static_chunk_size, self.up_stride = static_chunk_size, up_stride
        self.embed = LinearEmbed(dim, dim)
        self.pre_lookahead_layer = PreLookaheadLayer(dim, dim, pre_lookahead_len)
        self.encoders = nn.ModuleList([ConformerEncoderLayer(dim, heads, ffn_hidden) for _ in range(num_blocks)])
        self.up_conv = ConvParams(dim, dim, 2 * up_stride + 1)
        self.up_embed = LinearEmbed(dim, dim)
        self.up_encoders = nn.ModuleList([ConformerEncoderLayer(dim, heads, ffn_hidden) for _ in range(num_up_blocks)])
        self.after_norm = LayerNorm(dim, eps=1e-5)

    def forward(self, xs, xs_lens, context=None, streaming: bool = False):
        """xs (B, T, D) token embeddings -> (ys (B, 2T, D), out lens)."""
        t = xs.shape[1]
        x, pos = self.embed(xs)
        ctx = self.embed(context)[0] if context is not None and context.shape[1] > 0 else None
        attn_mask = chunk_attn_mask(xs_lens, t, self.static_chunk_size if streaming else 0)
        pad_mask = (torch.arange(t, device=xs.device)[None, :] < xs_lens[:, None]).to(x.dtype)
        x = self.pre_lookahead_layer(x, ctx)
        for layer in self.encoders:
            x = layer(x, pos, attn_mask, pad_mask)

        s = self.up_stride
        xu = torch.repeat_interleave(x, s, dim=1)
        xu = conv1d(xu, self.up_conv.weight.to(x.dtype), self.up_conv.bias.to(x.dtype), padding=(2 * s, 0))
        up_lens = xs_lens * s
        t2 = xu.shape[1]
        xu, pos2 = self.up_embed(xu)
        attn_mask2 = chunk_attn_mask(up_lens, t2, self.static_chunk_size * s if streaming else 0)
        pad_mask2 = (torch.arange(t2, device=xs.device)[None, :] < up_lens[:, None]).to(x.dtype)
        for layer in self.up_encoders:
            xu = layer(xu, pos2, attn_mask2, pad_mask2)
        return self.after_norm(xu), up_lens


class ConformerEncoder(nn.Module):
    """Conformer / transformer encoder. `forward_chunk` is the streaming
    att / cnn cache path over fixed-size rolling caches; the caller tracks
    how many cache frames are real (n_valid)."""

    def __init__(self, dim: int = 512, heads: int = 8, ffn_hidden: int = 2048, num_blocks: int = 6,
                 macaron: bool = True, use_cnn: bool = True, cnn_kernel: int = 15, input_dim: int | None = None,
                 ffn_act: str = "swish", legacy_embed: bool = False, cnn_causal: bool = False,
                 cnn_norm: str = "layer_norm"):
        super().__init__()
        self.dim, self.heads, self.num_blocks, self.cnn_kernel = dim, heads, num_blocks, cnn_kernel
        self.embed = LinearEmbed(dim if input_dim is None else input_dim, dim, legacy_relu=legacy_embed)
        self.encoders = nn.ModuleList([
            ConformerEncoderLayer(dim, heads, ffn_hidden, macaron=macaron, use_cnn=use_cnn, cnn_kernel=cnn_kernel,
                                  cnn_causal=cnn_causal, cnn_norm=cnn_norm, ffn_act=ffn_act)
            for _ in range(num_blocks)])
        self.after_norm = LayerNorm(dim, eps=1e-5)

    def forward(self, xs, xs_lens, streaming: bool = False, static_chunk_size: int = 0):
        t = xs.shape[1]
        x, pos = self.embed(xs)
        attn_mask = chunk_attn_mask(xs_lens, t, static_chunk_size if streaming else 0)
        pad_mask = (torch.arange(t, device=xs.device)[None, :] < xs_lens[:, None]).to(x.dtype)
        for layer in self.encoders:
            x = layer(x, pos, attn_mask, pad_mask)
        return self.after_norm(x), xs_lens

    def init_chunk_state(self, batch: int, cache_t: int, dtype=torch.float32, device=None):
        """Zeroed streaming caches: att_k, att_v (L, B, cache_t, H, dk) and
        cnn (L, B, kernel-1, D)."""
        dk = self.dim // self.heads
        l = self.num_blocks
        return (torch.zeros((l, batch, cache_t, self.heads, dk), dtype=dtype, device=device),
                torch.zeros((l, batch, cache_t, self.heads, dk), dtype=dtype, device=device),
                torch.zeros((l, batch, max(self.cnn_kernel - 1, 1), self.dim), dtype=dtype, device=device))

    def forward_chunk(self, xs, att_k, att_v, cnn_c, n_valid: int):
        """One streaming chunk xs (B, C, D_in); n_valid: the real frames of
        the att cache. Returns (ys (B, C, D), new att_k, att_v, cnn)."""
        b, c_len, _ = xs.shape
        tc = att_k.shape[2]
        kk = tc + c_len
        x, _ = self.embed(xs)
        pos = torch.from_numpy(espnet_rel_pos_table(kk, self.dim)[:, : kk + c_len - 1]).to(x.device, x.dtype)
        valid_from = tc - min(int(n_valid), tc)
        attn_mask = (torch.arange(kk, device=x.device)[None, None, :] >= valid_from).expand(b, c_len, kk)
        pad_mask = torch.ones((b, c_len), dtype=x.dtype, device=x.device)
        nk, nv, nc = [], [], []
        for i, layer in enumerate(self.encoders):
            x, (k, v, c) = layer(x, pos, attn_mask, pad_mask, caches=(att_k[i], att_v[i], cnn_c[i]))
            nk.append(k)
            nv.append(v)
            nc.append(c)
        return self.after_norm(x), torch.stack(nk), torch.stack(nv), torch.stack(nc)
