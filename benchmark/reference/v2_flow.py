"""CosyVoice2's token-to-mel flow, float32, one utterance at a time:
`CausalMaskedDiffWithXvec` (token embedding, the upsampling conformer
encoder with its 3-token lookahead, the projection to the mel, the x-vector
projection) and its causal 1-D U-Net estimator under the 10-step cosine
Euler solve with classifier-free guidance, from the fixed noise
torch.randn([1, 80, 15000]) of the CPU generator seeded with 0.

The encoder follows the published design: a linear embedding with a
LayerNorm and the espnet relative-position table, the pre-lookahead
convolutions, pre-norm Transformer-XL relative-attention layers with a
swish feed-forward, nearest x2 upsampling with a causal convolution, a
second embedding and stack, and a final LayerNorm; `streaming` gives every
attention the chunk-causal mask (25 tokens, 50 frames). The U-Net is one
level of a causal ResNet block (convolution, LayerNorm, Mish) and four
Transformer blocks, twelve such mid levels, the skip-joined up level, a
final block and projection.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .dit_flow import fixed_noise


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class Conv(nn.Module):
    """A convolution's weight (Cout, Cin, K) and bias on channels-last (L, C)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, left: int = 0, right: int = 0):
        return F.conv1d(F.pad(x.t()[None], (left, right)), self.weight, self.bias)[0].t()


def mish(x):
    return x * torch.tanh(F.softplus(x))


def chunk_mask(l: int, valid: int, chunk: int, device) -> torch.Tensor:
    """(L, L) bool: keys below `valid`, and with chunk > 0 before the end of the query's chunk."""
    pos = torch.arange(l, device=device)
    m = (pos < valid)[None, :].expand(l, l)
    if chunk:
        m = m & (pos[None, :] < ((pos // chunk + 1) * chunk)[:, None])
    return m


def rel_pos_table(t: int, d: int) -> np.ndarray:
    """(2T-1, d): distances T-1 .. -(T-1), [sin, cos] interleaved."""
    position = np.arange(t, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pos, neg = np.zeros((t, d)), np.zeros((t, d))
    pos[:, 0::2], pos[:, 1::2] = np.sin(position * div), np.cos(position * div)
    neg[:, 0::2], neg[:, 1::2] = np.sin(-position * div), np.cos(-position * div)
    return np.concatenate([pos[::-1], neg[1:]], axis=0).astype(np.float32)


class RelAttention(nn.Module):
    def __init__(self, heads: int, dim: int):
        super().__init__()
        self.h, self.dk = heads, dim // heads
        self.linear_q, self.linear_k, self.linear_v = nn.Linear(dim, dim), nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.linear_pos = nn.Linear(dim, dim, bias=False)
        self.linear_out = nn.Linear(dim, dim)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, self.dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, self.dk))

    def forward(self, x, pos, mask):
        t = x.shape[0]
        q = self.linear_q(x).reshape(t, self.h, self.dk)
        k = self.linear_k(x).reshape(t, self.h, self.dk)
        v = self.linear_v(x).reshape(t, self.h, self.dk)
        p = self.linear_pos(pos).reshape(2 * t - 1, self.h, self.dk)
        ac = torch.einsum("thd,shd->hts", q + self.pos_bias_u, k)
        bd_all = torch.einsum("thd,rhd->htr", q + self.pos_bias_v, p)  # row r of p is distance T-1-r
        # query i at key j is distance i-j: row (T-1) - i + j
        idx = (t - 1 - torch.arange(t, device=x.device))[:, None] + torch.arange(t, device=x.device)[None, :]
        bd = torch.gather(bd_all, 2, idx[None].expand(self.h, t, t))
        scores = ((ac + bd) / math.sqrt(self.dk)).masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1).nan_to_num(0.0)
        return self.linear_out(torch.einsum("hts,shd->thd", probs, v).reshape(t, self.h * self.dk))


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn: int):
        super().__init__()
        self.norm_mha = LayerNorm(dim, 1e-12)
        self.self_attn = RelAttention(heads, dim)
        self.norm_ff = LayerNorm(dim, 1e-12)
        self.ff = nn.Module()
        self.ff.w_1, self.ff.w_2 = nn.Linear(dim, ffn), nn.Linear(ffn, dim)

    def forward(self, x, pos, mask):
        x = x + self.self_attn(self.norm_mha(x), pos, mask)
        h = self.ff.w_1(self.norm_ff(x))
        return x + self.ff.w_2(h * torch.sigmoid(h))


class Embed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.linear = nn.Linear(dim, dim)
        self.norm = LayerNorm(dim, 1e-5)

    def forward(self, x):
        pos = torch.from_numpy(rel_pos_table(x.shape[0], self.dim)).to(x.device)
        return self.norm(self.linear(x)) * math.sqrt(self.dim), pos


class UpEncoder(nn.Module):
    def __init__(self, f: dict):
        super().__init__()
        d, la = f["input_size"], f["pre_lookahead_len"]
        self.chunk = f["static_chunk_size"]
        self.embed = Embed(d)
        self.pre_lookahead_layer = nn.Module()
        self.pre_lookahead_layer.conv1, self.pre_lookahead_layer.conv2 = Conv(d, d, la + 1), Conv(d, d, 3)
        self.la = la
        self.encoders = nn.ModuleList([EncoderLayer(d, f["enc_heads"], f["enc_ffn"]) for _ in range(f["enc_blocks"])])
        self.up_conv = Conv(d, d, 5)
        self.up_embed = Embed(d)
        self.up_encoders = nn.ModuleList([EncoderLayer(d, f["enc_heads"], f["enc_ffn"])
                                          for _ in range(f["enc_up_blocks"])])
        self.after_norm = LayerNorm(d, 1e-5)

    def forward(self, xs, valid: int, streaming: bool):
        """xs (T, D) embeddings, the last T - valid of them lookahead only -> (2T, D)."""
        t = xs.shape[0]
        x, pos = self.embed(xs)
        mask = chunk_mask(t, valid, self.chunk if streaming else 0, x.device)
        pl = self.pre_lookahead_layer
        h = F.leaky_relu(pl.conv1(x, right=self.la), 0.01)
        x = pl.conv2(h, left=2) + x
        for layer in self.encoders:
            x = layer(x, pos, mask)
        xu = self.up_conv(x.repeat_interleave(2, dim=0), left=4)
        xu, pos2 = self.up_embed(xu)
        mask2 = chunk_mask(2 * t, 2 * valid, 2 * self.chunk if streaming else 0, x.device)
        for layer in self.up_encoders:
            xu = layer(xu, pos2, mask2)
        return self.after_norm(xu)


class Block1D(nn.Module):
    """Causal convolution k3, LayerNorm, Mish."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.norm = LayerNorm(cout, 1e-6)

    def forward(self, x):
        return mish(self.norm(F.conv1d(F.pad(x.t()[None], (2, 0)), self.weight, self.bias)[0].t()))


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, tdim: int):
        super().__init__()
        self.block1, self.block2 = Block1D(cin, cout), Block1D(cout, cout)
        self.mlp = nn.Linear(tdim, cout)
        self.res = Conv(cin, cout, 1)

    def forward(self, x, t_emb):
        h = self.block1(x) + self.mlp(mish(t_emb))
        return self.block2(h) + self.res(x)


class TBlock(nn.Module):
    def __init__(self, dim: int, heads: int, hd: int):
        super().__init__()
        self.heads, self.hd = heads, hd
        self.norm1, self.norm3 = LayerNorm(dim, 1e-6), LayerNorm(dim, 1e-6)
        inner = heads * hd
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.ff_in, self.ff_out = nn.Linear(dim, 4 * dim), nn.Linear(4 * dim, dim)

    def forward(self, x, mask):
        t = x.shape[0]
        h = self.norm1(x)
        q, k, v = (lin(h).reshape(t, self.heads, self.hd).transpose(0, 1) for lin in (self.to_q, self.to_k, self.to_v))
        probs = torch.softmax((q @ k.transpose(1, 2) / math.sqrt(self.hd)).masked_fill(~mask, float("-inf")), dim=-1)
        x = x + self.to_out((probs @ v).transpose(0, 1).reshape(t, -1))
        return x + self.ff_out(F.gelu(self.ff_in(self.norm3(x))))


class Level(nn.Module):
    def __init__(self, cin: int, cout: int, tdim: int, u: dict):
        super().__init__()
        self.n = u["n_blocks"]
        self.resnet = ResBlock(cin, cout, tdim)
        for j in range(self.n):
            setattr(self, f"tb_{j}", TBlock(cout, u["num_heads"], u["attention_head_dim"]))

    def forward(self, x, t_emb, mask):
        x = self.resnet(x, t_emb)
        for j in range(self.n):
            x = getattr(self, f"tb_{j}")(x, mask)
        return x


class UNet(nn.Module):
    """The causal U-Net of one level (`decoder_channels` of one width)."""

    def __init__(self, u: dict, mel: int):
        super().__init__()
        (ch,) = u["decoder_channels"]
        tdim = 4 * ch
        self.in_ch = u["in_channels"]
        self.time_mlp_1, self.time_mlp_2 = nn.Linear(self.in_ch, tdim), nn.Linear(tdim, tdim)
        self.down_0 = Level(self.in_ch, ch, tdim, u)
        self.down_conv_0 = Conv(ch, ch, 3)
        self.mid = nn.ModuleList()
        for _ in range(u["num_mid_blocks"]):
            m = nn.Module()
            m.level = Level(ch, ch, tdim, u)
            self.mid.append(m)
        self.up_0 = Level(2 * ch, ch, tdim, u)
        self.up_conv_0 = Conv(ch, ch, 3)
        self.final_block = Block1D(ch, ch)
        self.final_proj = Conv(ch, mel, 1)

    def forward(self, x, mu, t: float, spk, cond, mask):
        half = self.in_ch // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device) * -(math.log(10000.0) / (half - 1)))
        ang = 1000.0 * t * freqs
        t_emb = self.time_mlp_2(F.silu(self.time_mlp_1(torch.cat([torch.sin(ang), torch.cos(ang)]))))
        h = torch.cat([x, mu, spk[None].expand(x.shape[0], -1), cond], dim=-1)
        skip = self.down_0(h, t_emb, mask)
        h = self.down_conv_0(skip, left=2)
        for m in self.mid:
            h = m.level(h, t_emb, mask)
        h = self.up_0(torch.cat([h, skip], dim=-1), t_emb, mask)
        h = self.final_block(self.up_conv_0(h, left=2))
        return self.final_proj(h)


class FlowV2(nn.Module):
    """`f` holds the flow's sizes (encoder and U-Net)."""

    def __init__(self, f: dict):
        super().__init__()
        self.f = f
        self.input_embedding = nn.Embedding(f["vocab_size"], f["input_size"])
        self.spk_embed_affine_layer = nn.Linear(f["spk_embed_dim"], f["output_size"])
        self.encoder = UpEncoder(f)
        self.encoder_proj = nn.Linear(f["input_size"], f["output_size"])
        self.estimator = UNet(f, f["output_size"])

    @torch.no_grad()
    def mel(self, tokens, prompt_feat, embedding, streaming: bool, finalize: bool) -> torch.Tensor:
        """tokens (Lt,) prompt then target tokens, the last pre_lookahead_len
        of them lookahead only unless `finalize`; returns the mel of the
        others ((Lt - lookahead) * 2, 80), prompt frames first."""
        f = self.f
        dev = self.input_embedding.weight.device
        tokens = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        emb = torch.as_tensor(np.asarray(embedding, np.float32), device=dev)
        spk = self.spk_embed_affine_layer(emb / emb.norm().clamp_min(1e-12))
        valid = len(tokens) - (0 if finalize else f["pre_lookahead_len"])
        h = self.encoder(self.input_embedding(tokens), valid, streaming)
        l = 2 * valid
        mu = self.encoder_proj(h)[:l]
        pf = torch.as_tensor(np.asarray(prompt_feat, np.float32), device=dev)
        cond = torch.zeros_like(mu)
        cond[: pf.shape[0]] = pf[:l]
        mask = chunk_mask(l, l, 2 * f["static_chunk_size"] if streaming else 0, dev)
        rate, n = f["inference_cfg_rate"], f["n_timesteps"]
        ts = 1.0 - np.cos(np.linspace(0.0, 1.0, n + 1) * 0.5 * np.pi)
        x = fixed_noise()[:l].to(dev)
        zeros, zero_spk = torch.zeros_like(mu), torch.zeros_like(spk)
        for i in range(n):
            t = float(np.float32(ts[i]))
            v_c = self.estimator(x, mu, t, spk, cond, mask)
            v_u = self.estimator(x, zeros, t, zero_spk, zeros, mask)
            x = x + float(np.float32(ts[i + 1]) - np.float32(ts[i])) * ((1.0 + rate) * v_c - rate * v_u)
        return x
