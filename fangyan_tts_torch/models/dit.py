"""Flow-matching DiT estimator (fangyan_tts_tpu/models/dit.py).

Tensors are channels-last (B, L, C) as in the JAX module. Block parameters
follow the JAX tree with the layer axis unstacked: `blocks.{i}.attn.to_qkv`
(fused q/k/v), `.attn.to_out`, `.attn_norm_linear` (AdaLN-Zero), `.ff_0`,
`.ff_2`. Attention goes through ops/flash_attention.chunk_flash_attention
with the CFG-doubled `mel_len` and the chunk size, not a bias.

Kept on purpose from the reference: the rotary embedding is applied to the
whole q/k projection before the head split with rot_dim = dim_head, so only
the first `dim_head` channels (head 0) are rotated, with interleaved pairs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import DiTConfig, reject_unported
from ..ops.convs import conv1d
from ..ops.flash_attention import chunk_flash_attention
from .qwen2 import flax_dense, qdense


class ConvParams(nn.Module):
    """Weight (Cout, Cin/groups, K) and bias of a convolution applied
    through ops/convs."""

    def __init__(self, cin: int, cout: int, k: int, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k))
        self.bias = nn.Parameter(torch.zeros(cout))


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """flax LayerNorm without scale or bias: float32 statistics
    (E[x^2] - E[x]^2, clamped at 0), result in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def sinus_position_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """t (B,) -> (B, dim) float32 [sin, cos]."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, freq_embed_dim: int = 256):
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        self.mlp_0 = nn.Linear(freq_embed_dim, dim)
        self.mlp_2 = nn.Linear(dim, dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = sinus_position_embedding(t, self.freq_embed_dim).to(t.dtype)
        h = F.silu(flax_dense(h, self.mlp_0, t.dtype))
        return flax_dense(h, self.mlp_2, t.dtype)


class CausalConvPositionEmbedding(nn.Module):
    """Two left-padded grouped convolutions, each followed by Mish."""

    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16):
        super().__init__()
        self.kernel_size, self.groups = kernel_size, groups
        self.conv1 = ConvParams(dim, dim, kernel_size, groups)
        self.conv2 = ConvParams(dim, dim, kernel_size, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.kernel_size - 1
        for conv in (self.conv1, self.conv2):
            x = conv1d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=(pad, 0), groups=self.groups)
            x = x * torch.tanh(F.softplus(x))  # mish
        return x


def _rotary_freqs(seq_len: int, dim_head: int, theta: float = 10000.0) -> np.ndarray:
    """x_transformers rotary frequencies (L, dim_head), computed in float64
    and interleaved ((n r), r=2)."""
    inv = 1.0 / (theta ** (np.arange(0, dim_head, 2, dtype=np.float64) / dim_head))
    f = np.arange(seq_len, dtype=np.float64)[:, None] * inv[None, :]
    return np.repeat(f, 2, axis=-1).astype(np.float32)


def _apply_rotary_pre_split(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, L, inner): rotate only the first rot_dim channels, pairing
    channels (2i, 2i+1)."""
    rot_dim = cos.shape[-1]
    t, unrot = x[..., :rot_dim], x[..., rot_dim:]
    t2 = t.reshape(*t.shape[:-1], rot_dim // 2, 2)
    rotated = torch.stack([-t2[..., 1], t2[..., 0]], dim=-1).reshape(t.shape)
    return torch.cat([t * cos + rotated * sin, unrot], dim=-1)


class DiTAttention(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        inner = cfg.heads * cfg.dim_head
        self.to_qkv = nn.Linear(cfg.dim, 3 * inner)
        self.to_out = nn.Linear(inner, cfg.dim)

    def forward(self, x, mel_len, chunk: int, cos, sin):
        c = self.cfg
        b, l, _ = x.shape
        q, k, v = qdense(x, self.to_qkv).chunk(3, dim=-1)
        q = _apply_rotary_pre_split(q, cos, sin)
        k = _apply_rotary_pre_split(k, cos, sin)

        def heads(t):  # (B, L, inner) -> (B, H, L, D)
            return t.reshape(b, l, c.heads, c.dim_head).transpose(1, 2).contiguous()

        out = chunk_flash_attention(heads(q), heads(k), heads(v), mel_len, chunk)
        return qdense(out.transpose(1, 2).reshape(b, l, c.heads * c.dim_head), self.to_out)


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.attn_norm_linear = nn.Linear(cfg.dim, 6 * cfg.dim)
        self.attn = DiTAttention(cfg)
        self.ff_0 = nn.Linear(cfg.dim, cfg.dim * cfg.ff_mult)
        self.ff_2 = nn.Linear(cfg.dim * cfg.ff_mult, cfg.dim)

    def forward(self, x, mod, mel_len, chunk: int, cos, sin):
        """mod: this block's AdaLN-Zero modulation (B, 6*dim), from
        precompute_mods."""
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        norm = layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        x = x + gate_msa[:, None] * self.attn(norm, mel_len, chunk, cos, sin)
        ff_norm = layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        h = qdense(F.gelu(qdense(ff_norm, self.ff_0), approximate="tanh"), self.ff_2)
        return x + gate_mlp[:, None] * h


@torch.no_grad()
def precompute_mods(dit: "DiT", t_all: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """AdaLN-Zero modulations for every (timestep, block) in one pass.
    t_all (T, B) -> (T, depth, B, 6*dim); the same math as the JAX
    DiTBlock's in-block modulation, without re-reading the modulation
    weights at every Euler step."""
    T, B = t_all.shape
    s = F.silu(dit.time_embed(t_all.reshape(-1).to(dtype))).reshape(T, B, dit.cfg.dim)
    return torch.stack([qdense(s, blk.attn_norm_linear) for blk in dit.blocks], dim=1)


class DiT(nn.Module):
    """Velocity estimator on (B, L, mel) tensors."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        reject_unported(cfg)
        self.cfg = cfg
        self.time_embed = TimestepEmbedding(cfg.dim, cfg.freq_embed_dim)
        self.input_proj = nn.Linear(cfg.mel_dim * 2 + cfg.mu_dim + cfg.spk_dim, cfg.dim)
        self.conv_pos_embed = CausalConvPositionEmbedding(cfg.dim, cfg.conv_pos_kernel, cfg.conv_pos_groups)
        self.blocks = nn.ModuleList([DiTBlock(cfg) for _ in range(cfg.depth)])
        self.norm_out_linear = nn.Linear(cfg.dim, cfg.dim * 2)
        self.proj_out = nn.Linear(cfg.dim, cfg.mel_dim)

    def forward(self, x, mu, t, spks, cond, mel_len, chunk: int, mods):
        """x, mu, cond (B, L, mel); t (B,); spks (B, spk_dim); mel_len (B,)
        int32 valid frames (keys past it are masked); chunk: 0 for full
        attention, else chunk-causal; mods (depth, B, 6*dim) from
        precompute_mods."""
        c = self.cfg
        b, l, _ = x.shape
        t_emb = self.time_embed(t.to(x.dtype))
        spks_b = spks[:, None, :].expand(b, l, spks.shape[-1]).to(x.dtype)
        h = flax_dense(torch.cat([x, cond, mu, spks_b], dim=-1), self.input_proj, x.dtype)
        h = self.conv_pos_embed(h) + h

        freqs = torch.from_numpy(_rotary_freqs(l, c.dim_head)).to(x.device)
        cos, sin = torch.cos(freqs).to(x.dtype), torch.sin(freqs).to(x.dtype)
        for i, blk in enumerate(self.blocks):
            h = blk(h, mods[i], mel_len, chunk, cos, sin)

        scale, shift = flax_dense(F.silu(t_emb), self.norm_out_linear, x.dtype).chunk(2, dim=-1)
        h = layer_norm(h) * (1 + scale)[:, None] + shift[:, None]
        return flax_dense(h, self.proj_out, x.dtype)
