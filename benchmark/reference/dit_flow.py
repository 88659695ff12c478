"""CosyVoice3's token-to-mel flow, float32, one utterance at a time:
`CausalMaskedDiffWithDiT` (token embedding, the pre-lookahead convolutions,
x2 nearest upsampling, the prompt-mel condition, the x-vector projection)
and its DiT velocity estimator under the 10-step cosine Euler solve with
classifier-free guidance, from the fixed noise torch.randn([1, 80, 15000])
of the CPU generator seeded with 0.

The DiT follows the published design: a sinusoidal time embedding and MLP,
the input projection of [x, cond, mu, spk], two causal grouped position
convolutions with Mish, AdaLN-Zero blocks of multi-head attention and a
tanh-GELU MLP, and the final AdaLN and projection. As in CosyVoice3's code,
the rotary embedding is applied to the q / k projection before the head
split with rot_dim = dim_head, so only the first head's channels rotate,
in interleaved pairs. Attention is full over the utterance, or with
`chunk` > 0 chunk-causal (a frame sees every frame before the end of its
own chunk).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, groups: int = 1):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, left: int = 0, right: int = 0):
        """x (L, C) channels-last, zero padded on each side."""
        y = F.conv1d(F.pad(x.t()[None], (left, right)), self.weight, self.bias, groups=self.groups)
        return y[0].t()


def layer_norm(x, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * torch.rsqrt(var + eps)


class TimeEmbedding(nn.Module):
    def __init__(self, dim: int, freq_dim: int):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp_0 = nn.Linear(freq_dim, dim)
        self.mlp_2 = nn.Linear(dim, dim)

    def forward(self, t: float):
        half = self.freq_dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=self.mlp_0.weight.device)
                          * -(math.log(10000.0) / (half - 1)))
        ang = 1000.0 * t * freqs
        return self.mlp_2(F.silu(self.mlp_0(torch.cat([torch.sin(ang), torch.cos(ang)]))))


class PosConv(nn.Module):
    def __init__(self, dim: int, k: int, groups: int):
        super().__init__()
        self.conv1 = Conv(dim, dim, k, groups)
        self.conv2 = Conv(dim, dim, k, groups)

    def forward(self, x):
        for conv in (self.conv1, self.conv2):
            x = conv(x, left=conv.weight.shape[-1] - 1)
            x = x * torch.tanh(F.softplus(x))
        return x


class Attn(nn.Module):
    def __init__(self, d: dict):
        super().__init__()
        inner = d["heads"] * d["dim_head"]
        self.heads, self.dh = d["heads"], d["dim_head"]
        self.to_qkv = nn.Linear(d["dim"], 3 * inner)
        self.to_out = nn.Linear(inner, d["dim"])

    def forward(self, x, cos, sin, mask):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k = rotate_head0(q, cos, sin), rotate_head0(k, cos, sin)
        l = x.shape[0]
        q, k, v = (t.reshape(l, self.heads, self.dh).transpose(0, 1) for t in (q, k, v))
        scores = (q @ k.transpose(1, 2) / math.sqrt(self.dh)).masked_fill(~mask, float("-inf"))
        out = torch.softmax(scores, dim=-1) @ v
        return self.to_out(out.transpose(0, 1).reshape(l, self.heads * self.dh))


def rotate_head0(x, cos, sin):
    r = cos.shape[-1]
    t = x[:, :r]
    pairs = t.reshape(-1, r // 2, 2)
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(t.shape)
    return torch.cat([t * cos + rotated * sin, x[:, r:]], dim=-1)


class DiTBlock(nn.Module):
    def __init__(self, d: dict):
        super().__init__()
        self.attn_norm_linear = nn.Linear(d["dim"], 6 * d["dim"])
        self.attn = Attn(d)
        self.ff_0 = nn.Linear(d["dim"], d["dim"] * d["ff_mult"])
        self.ff_2 = nn.Linear(d["dim"] * d["ff_mult"], d["dim"])

    def forward(self, x, s, cos, sin, mask):
        shift_a, scale_a, gate_a, shift_f, scale_f, gate_f = self.attn_norm_linear(s).chunk(6)
        x = x + gate_a * self.attn(layer_norm(x) * (1 + scale_a) + shift_a, cos, sin, mask)
        h = self.ff_2(F.gelu(self.ff_0(layer_norm(x) * (1 + scale_f) + shift_f), approximate="tanh"))
        return x + gate_f * h


class DiT(nn.Module):
    def __init__(self, d: dict):
        super().__init__()
        self.d = d
        self.time_embed = TimeEmbedding(d["dim"], d["freq_embed_dim"])
        self.input_proj = nn.Linear(d["mel_dim"] * 2 + d["mu_dim"] + d["spk_dim"], d["dim"])
        self.conv_pos_embed = PosConv(d["dim"], d["conv_pos_kernel"], d["conv_pos_groups"])
        self.blocks = nn.ModuleList([DiTBlock(d) for _ in range(d["depth"])])
        self.norm_out_linear = nn.Linear(d["dim"], 2 * d["dim"])
        self.proj_out = nn.Linear(d["dim"], d["mel_dim"])

    def forward(self, x, mu, t: float, spk, cond, mask):
        """x, mu, cond (L, mel); spk (mel,); mask (L, L) bool, True where a
        query may see a key."""
        l = x.shape[0]
        t_emb = self.time_embed(t)
        h = self.input_proj(torch.cat([x, cond, mu, spk[None].expand(l, -1)], dim=-1))
        h = self.conv_pos_embed(h) + h
        dh = self.d["dim_head"]
        inv = 1.0 / (10000.0 ** (np.arange(0, dh, 2, dtype=np.float64) / dh))
        freqs = np.repeat(np.arange(l, dtype=np.float64)[:, None] * inv[None, :], 2, axis=-1).astype(np.float32)
        freqs = torch.from_numpy(freqs).to(x.device)
        cos, sin = torch.cos(freqs), torch.sin(freqs)
        s = F.silu(t_emb)
        for blk in self.blocks:
            h = blk(h, s, cos, sin, mask)
        scale, shift = self.norm_out_linear(s).chunk(2)
        return self.proj_out(layer_norm(h) * (1 + scale) + shift)


class PreLookahead(nn.Module):
    def __init__(self, cin: int, ch: int, la: int):
        super().__init__()
        self.la = la
        self.conv1 = Conv(cin, ch, la + 1)
        self.conv2 = Conv(ch, cin, 3)

    def forward(self, x):
        h = F.leaky_relu(self.conv1(x, right=self.la), 0.01)
        return self.conv2(h, left=2) + x


@functools.lru_cache(maxsize=1)
def fixed_noise() -> torch.Tensor:
    """(15000, 80): torch.randn([1, 80, 15000]) from the CPU generator seeded with 0, channels-last."""
    g = torch.Generator(device="cpu").manual_seed(0)
    return torch.randn([1, 80, 15000], generator=g)[0].t().contiguous()


def chunk_mask(l: int, chunk: int, device) -> torch.Tensor:
    """(L, L) bool: every key (chunk 0), or keys before the end of the query's chunk."""
    if not chunk:
        return torch.ones(l, l, dtype=torch.bool, device=device)
    pos = torch.arange(l, device=device)
    return pos[None, :] < ((pos // chunk + 1) * chunk)[:, None]


class Flow(nn.Module):
    """`f` holds the flow's sizes with the DiT's under f["dit"]."""

    def __init__(self, f: dict):
        super().__init__()
        self.f = f
        self.input_embedding = nn.Embedding(f["vocab_size"], f["input_size"])
        self.spk_embed_affine_layer = nn.Linear(f["spk_embed_dim"], f["output_size"])
        self.pre_lookahead_layer = PreLookahead(f["input_size"], f["pre_lookahead_channels"], f["pre_lookahead_len"])
        self.estimator = DiT(f["dit"])

    @torch.no_grad()
    def mel(self, tokens, prompt_feat, embedding, chunk: int = 0) -> torch.Tensor:
        """tokens (Lt,) prompt then target speech tokens; prompt_feat (Lp, 80);
        embedding (192,). Returns the mel (Lt * ratio, 80), prompt frames first."""
        f = self.f
        dev = self.input_embedding.weight.device
        tokens = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        emb = torch.as_tensor(np.asarray(embedding, np.float32), device=dev)
        spk = self.spk_embed_affine_layer(emb / emb.norm().clamp_min(1e-12))
        mu = self.pre_lookahead_layer(self.input_embedding(tokens)).repeat_interleave(f["token_mel_ratio"], dim=0)
        l = mu.shape[0]
        pf = torch.as_tensor(np.asarray(prompt_feat, np.float32), device=dev)
        cond = torch.zeros_like(mu)
        cond[: pf.shape[0]] = pf[:l]
        mask = chunk_mask(l, chunk, dev)
        rate = f["inference_cfg_rate"]
        n = f["n_timesteps"]
        ts = 1.0 - np.cos(np.linspace(0.0, 1.0, n + 1) * 0.5 * np.pi)
        x = fixed_noise()[:l].to(dev)
        zero_mu, zero_spk = torch.zeros_like(mu), torch.zeros_like(spk)
        for i in range(n):
            t = float(np.float32(ts[i]))
            v_c = self.estimator(x, mu, t, spk, cond, mask)
            v_u = self.estimator(x, zero_mu, t, zero_spk, zero_mu, mask)
            x = x + float(np.float32(ts[i + 1]) - np.float32(ts[i])) * ((1.0 + rate) * v_c - rate * v_u)
        return x
