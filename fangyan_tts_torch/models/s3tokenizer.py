"""S3 supervised speech tokenizer with an FSQ head
(fangyan_tts_tpu/models/s3tokenizer.py).

Whisper 128-bin log-mel at 100 Hz -> 25 Hz codes in [0, 3^8):
- two k=3 convolutions, both stride 2, each followed by exact GELU; the
  input of each is masked to its valid frames and the lengths become
  (len + 1) // 2 twice;
- pre-LN transformer blocks (LayerNorm eps 1e-6) whose attention adds an
  FSMN memory: a depthwise convolution over the masked value stream, plus
  that stream, re-masked, added to the attention output before `out`;
  q and k are each scaled by hd^-0.25, padded keys get a -1e10 bias and
  the softmax runs in float32; no positional embedding;
- FSQ: project to 8 dims in float32, tanh * 0.999, round, + 1, base 3.

The attention is plain PyTorch, as the JAX package's is an einsum. Tensors
are channels-last (B, T, C); parameter names follow the JAX tree through
models/from_jax.py (`blocks_{i}.q`, `.fsmn.weight`, `.attn_ln.scale`, ...).
Every product runs in the input's dtype, with the weights cast to it; FSQ
runs in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convs import conv1d
from .dit import ConvParams
from .qwen2 import flax_dense

FSQ_SCALE = 0.9990000128746033  # float32(0.999), the public FSQCodebook constant


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (scale and bias): float32 statistics
    (E[x^2] - E[x]^2, clamped at 0); the result is float32, the promotion of
    the input with the float32 parameters."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.eps) * self.scale.float()) + self.bias.float()
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))


class FSMNAttentionBlock(nn.Module):
    """Pre-LN transformer block with an FSMN memory on the value stream."""

    def __init__(self, dim: int, heads: int, fsmn_kernel: int = 31):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.attn_ln = LayerNorm(dim)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim, bias=False)
        self.v = nn.Linear(dim, dim)
        self.fsmn = nn.Module()
        self.fsmn.weight = nn.Parameter(torch.empty(dim, 1, fsmn_kernel))
        self.out = nn.Linear(dim, dim)
        self.mlp_ln = LayerNorm(dim)
        self.mlp_0 = nn.Linear(dim, 4 * dim)
        self.mlp_2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, pad_bias: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        """pad_bias (B, T) float32, 0 valid / -1e10 pad; pad_mask (B, T, 1) bool."""
        dt, d = x.dtype, self.dim
        h = self.attn_ln(x)
        q, k, v = (flax_dense(h, lin, dt) for lin in (self.q, self.k, self.v))

        fk = self.fsmn.weight
        left = (fk.shape[-1] - 1) // 2
        right = fk.shape[-1] - 1 - left
        m = pad_mask.to(dt)
        vm = v * m
        mem = (conv1d(vm, fk.to(dt), None, padding=(left, right), groups=d) + vm) * m

        b, t, _ = x.shape
        hd = d // self.heads
        scale = hd**-0.25
        qh = (q * scale).reshape(b, t, self.heads, hd)
        kh = (k * scale).reshape(b, t, self.heads, hd)
        vh = v.reshape(b, t, self.heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) + pad_bias[:, None, None, :]
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, t, d)
        x = x + flax_dense(o + mem, self.out, dt)

        h = flax_dense(self.mlp_ln(x), self.mlp_0, dt)
        return x + flax_dense(F.gelu(h), self.mlp_2, dt)


class FSQ(nn.Module):
    """Finite scalar quantization head: project down (float32), tanh * 0.999,
    round to {-1, 0, 1}, + 1, base-3 positional code."""

    def __init__(self, dim: int, num_dims: int = 8, levels: int = 3):
        super().__init__()
        self.levels = levels
        self.project_down = nn.Linear(dim, num_dims)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T, D) -> (codes (B, T) int32, the bounded pre-round values)."""
        h = flax_dense(x.float(), self.project_down, torch.float32)
        bounded = torch.tanh(h) * FSQ_SCALE
        q = torch.round(bounded) + 1.0  # {0, 1, 2}
        basis = torch.from_numpy((self.levels ** np.arange(h.shape[-1])).astype(np.int32)).to(x.device)
        codes = (q.to(torch.int32) * basis[None, None, :]).sum(dim=-1)
        return codes.to(torch.int32), bounded


class S3TokenizerV3(nn.Module):
    """128-mel 100 Hz -> 25 Hz codes in [0, 6561)."""

    def __init__(self, dim: int = 1280, heads: int = 20, layers: int = 6, n_mels: int = 128, fsmn_kernel: int = 31):
        super().__init__()
        self.layers = layers
        self.conv1 = ConvParams(n_mels, dim, 3)
        self.conv2 = ConvParams(dim, dim, 3)
        for i in range(layers):
            setattr(self, f"blocks_{i}", FSMNAttentionBlock(dim, heads, fsmn_kernel))
        self.fsq = FSQ(dim)

    def encode(self, mel: torch.Tensor, mel_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """mel (B, n_mels, T), mel_len (B,) -> (the encoder output (B, T//4, dim)
        before FSQ, the code lengths (B,) int32)."""
        x = mel.transpose(1, 2)  # (B, T, n_mels)
        dt, dev = x.dtype, x.device
        mel_len = mel_len.to(dev, torch.int64)

        def valid(n: int, lens: torch.Tensor) -> torch.Tensor:
            return (torch.arange(n, device=dev)[None, :] < lens[:, None])[..., None]

        for conv, lens in ((self.conv1, mel_len), (self.conv2, (mel_len + 1) // 2)):
            x = x * valid(x.shape[1], lens).to(dt)
            x = F.gelu(conv1d(x, conv.weight.to(dt), conv.bias.to(dt), stride=2, padding=1))
        len25 = ((mel_len + 1) // 2 + 1) // 2
        pad_mask = valid(x.shape[1], len25)
        pad_bias = torch.where(pad_mask[..., 0], 0.0, -1e10).to(torch.float32)
        for i in range(self.layers):
            x = getattr(self, f"blocks_{i}")(x, pad_bias, pad_mask)
        return x, len25.to(torch.int32)

    def forward(self, mel: torch.Tensor, mel_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """mel (B, n_mels, T) whisper log-mel, mel_len (B,) valid frames ->
        (codes (B, T//4) int32, code lengths (B,) int32)."""
        x, code_len = self.encode(mel, mel_len)
        return self.fsq(x)[0], code_len
