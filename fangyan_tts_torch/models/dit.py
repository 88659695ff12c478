"""Flow-matching DiT estimator (fangyan_tts_tpu/models/dit.py).

Tensors are channels-last (B, L, C) as in the JAX module. Block parameters
follow the JAX tree with the layer axis unstacked: `blocks.{i}.attn.to_qkv`
(fused q/k/v), `.attn.to_out`, `.attn_norm_linear` (AdaLN-Zero), `.ff_0`,
`.ff_2`; under `quant_int8` these five are int8 QLinear (models/qwen2.py).
Attention goes through ops/flash_attention.chunk_flash_attention
with the CFG-doubled `mel_len` and the chunk size, not a bias. The training
forward (`DiT.forward(..., dense=True)`, which models/flow.py's
`CausalMaskedDiffWithDiT.forward` selects) takes the JAX DiT's own dense
attention instead (chunk_flash_attention_plain: the same math, with
autograd), because the kernel has no backward; it also computes the AdaLN
modulation from t in the pass (mods=None), with gradients.

`DiTChunk` is the KV-cached streaming estimator: one hop of new frames
through the same blocks, against per-layer K/V caches that it only reads.
Its attention is plain PyTorch (two products and one float32 softmax over
[cache ++ new]), as the JAX package leaves it to XLA. It holds the same
state_dict as `DiT`; `DiTChunk.of(dit)` shares a DiT's tensors.

Kept on purpose from the reference: the rotary embedding is applied to the
whole q/k projection before the head split with rot_dim = dim_head, so only
the first `dim_head` channels (head 0) are rotated, with interleaved pairs.
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import DiTConfig
from ..ops.adaln import adaln
from ..ops.convs import conv1d
from ..ops.flash_attention import chunk_flash_attention, chunk_flash_attention_plain
from .qwen2 import QLinear, dense, flax_dense, qdense


def _block_dense(cfg: DiTConfig, d_in: int, d_out: int) -> nn.Module:
    """A block's dense layer with bias: nn.Linear, or int8 QLinear under
    `quant_int8` (the JAX package's _block_dense)."""
    return dense(d_in, d_out, True, 8 if cfg.quant_int8 else 0)


class ConvParams(nn.Module):
    """Weight (Cout, Cin/groups, K) and bias of a convolution applied
    through ops/convs."""

    def __init__(self, cin: int, cout: int, k: int, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k))
        self.bias = nn.Parameter(torch.zeros(cout))


def tconv_params(cin: int, cout: int, k: int) -> nn.Module:
    """A transposed convolution's weight (Cin, Cout, K) and bias (Cout,),
    held by a bare module (the JAX package's `<name>_kernel` / `_bias`
    leaves; models/from_jax.py maps both ways)."""
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty(cin, cout, k))
    m.bias = nn.Parameter(torch.zeros(cout))
    return m


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

    def forward(self, x: torch.Tensor, tails: tuple[torch.Tensor, torch.Tensor] | None = None):
        """tails: the two convolutions' carried left context ((B, K-1, D)
        each) of a streaming hop; with them, returns (x, new_tail1,
        new_tail2) instead of padding zeros on the left."""
        pad = self.kernel_size - 1
        new_tails = []
        for i, conv in enumerate((self.conv1, self.conv2)):
            w, b = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
            if tails is None:
                x = conv1d(x, w, b, padding=(pad, 0), groups=self.groups)
            else:
                xin = torch.cat([tails[i].to(x.dtype), x], dim=1)
                new_tails.append(xin[:, -pad:])
                x = conv1d(xin, w, b, groups=self.groups)
            x = x * torch.tanh(F.softplus(x))  # mish
        return x if tails is None else (x, *new_tails)


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
        self.to_qkv = _block_dense(cfg, cfg.dim, 3 * inner)
        self.to_out = _block_dense(cfg, inner, cfg.dim)
        self.rotary = True  # head 0 is rotated; under tensor parallelism only its rank holds it

    def rotate(self, q, k, cos, sin):
        if not self.rotary:
            return q, k
        return _apply_rotary_pre_split(q, cos, sin), _apply_rotary_pre_split(k, cos, sin)

    def forward(self, x, mel_len, chunk: int, cos, sin, dense: bool = False):
        """dense: the JAX DiT's dense attention in plain PyTorch (the
        training route, differentiable) in place of the flash kernel."""
        c = self.cfg
        b, l, _ = x.shape
        q, k, v = qdense(x, self.to_qkv).chunk(3, dim=-1)
        q, k = self.rotate(q, k, cos, sin)

        def heads(t):  # (B, L, inner) -> (B, H, L, D) view, no copy (v stays inside the qkv buffer)
            return t.reshape(b, l, c.heads, c.dim_head).transpose(1, 2)

        # on the card the kernel's output is a (B, H, L, D) view of (B, L, H, D) memory: the reshape is free
        attend = chunk_flash_attention_plain if dense else chunk_flash_attention
        out = attend(heads(q), heads(k), heads(v), mel_len, chunk)
        return qdense(out.transpose(1, 2).reshape(b, l, c.heads * c.dim_head), self.to_out)


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.attn_norm_linear = _block_dense(cfg, cfg.dim, 6 * cfg.dim)
        self.attn = DiTAttention(cfg)
        self.ff_0 = _block_dense(cfg, cfg.dim, cfg.dim * cfg.ff_mult)
        self.ff_2 = _block_dense(cfg, cfg.dim * cfg.ff_mult, cfg.dim)

    def forward(self, x, mod, mel_len, chunk: int, cos, sin, dense: bool = False, res=None):
        """mod: this block's AdaLN-Zero modulation (B, 6*dim), from
        precompute_mods; dense: see DiTAttention; res: the previous block's
        closing residual (h, gate) not yet added to x, which this block's
        first norm adds (ops/adaln). Returns (x, (h, gate_mlp)): this
        block's own closing residual x + gate_mlp * h is left to the next
        norm in the same way."""
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        x, norm = adaln(x, scale_msa, shift_msa, *(res or ()))
        x, ff_norm = adaln(x, scale_mlp, shift_mlp, self.attn(norm, mel_len, chunk, cos, sin, dense), gate_msa)
        return x, (self.mlp(ff_norm), gate_mlp)

    def mlp(self, ff_norm):
        return qdense(F.gelu(qdense(ff_norm, self.ff_0), approximate="tanh"), self.ff_2)


def precompute_mods(dit: "DiT", t_all: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """AdaLN-Zero modulations for every (timestep, block) in one pass.
    t_all (T, B) -> (T, depth, B, 6*dim); the same math as the JAX
    DiTBlock's in-block modulation, without re-reading the modulation
    weights at every Euler step. Autograd records it when grad is enabled
    (the training forward); the Euler solves call it under no_grad."""
    T, B = t_all.shape
    s = F.silu(dit.time_embed(t_all.reshape(-1).to(dtype))).reshape(T, B, dit.cfg.dim)

    def mod(lin: nn.Module) -> torch.Tensor:
        if isinstance(lin, QLinear):  # int8 (JAX dit.py:350-356): product and scale both in dtype
            return torch.matmul(s, lin.kernel_q.to(dtype)) * lin.scale.to(dtype) + lin.bias.to(dtype)
        return qdense(s, lin)

    return torch.stack([mod(blk.attn_norm_linear) for blk in dit.blocks], dim=1)


def _embed(dit: "DiT", x, mu, t, spks, cond):
    """The time embedding and the input projection of a DiT call."""
    b, l, _ = x.shape
    t_emb = dit.time_embed(t.to(x.dtype))
    spks_b = spks[:, None, :].expand(b, l, spks.shape[-1]).to(x.dtype)
    return t_emb, flax_dense(torch.cat([x, cond, mu, spks_b], dim=-1), dit.input_proj, x.dtype)


def _final(dit: "DiT", h, t_emb, dtype, res):
    """AdaLayerNormZero_Final (adding the last block's closing residual
    `res`) and the output projection."""
    scale, shift = flax_dense(F.silu(t_emb), dit.norm_out_linear, dtype).chunk(2, dim=-1)
    _, h = adaln(h, scale, shift, *res)
    return flax_dense(h, dit.proj_out, dtype)


class DiT(nn.Module):
    """Velocity estimator on (B, L, mel) tensors."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.time_embed = TimestepEmbedding(cfg.dim, cfg.freq_embed_dim)
        self.input_proj = nn.Linear(cfg.mel_dim * 2 + cfg.mu_dim + cfg.spk_dim, cfg.dim)
        self.conv_pos_embed = CausalConvPositionEmbedding(cfg.dim, cfg.conv_pos_kernel, cfg.conv_pos_groups)
        self.blocks = nn.ModuleList([DiTBlock(cfg) for _ in range(cfg.depth)])
        self.norm_out_linear = nn.Linear(cfg.dim, cfg.dim * 2)
        self.proj_out = nn.Linear(cfg.dim, cfg.mel_dim)

    def forward(self, x, mu, t, spks, cond, mel_len, chunk: int, mods=None, dense: bool = False):
        """x, mu, cond (B, L, mel); t (B,); spks (B, spk_dim); mel_len (B,)
        int32 valid frames (keys past it are masked); chunk: 0 for full
        attention, else chunk-causal; mods (depth, B, 6*dim) from
        precompute_mods, or None to compute them from t here (the JAX
        DiTBlock's in-block modulation); dense: the differentiable dense
        attention route of training (DiTAttention) instead of the kernel."""
        t_emb, h = _embed(self, x, mu, t, spks, cond)
        h = self.conv_pos_embed(h) + h
        if mods is None:
            mods = precompute_mods(self, t[None], x.dtype)[0]

        freqs = torch.from_numpy(_rotary_freqs(x.shape[1], self.cfg.dim_head)).to(x.device)
        cos, sin = torch.cos(freqs).to(x.dtype), torch.sin(freqs).to(x.dtype)
        res = None
        for i, blk in enumerate(self.blocks):
            h, res = blk(h, mods[i], mel_len, chunk, cos, sin, dense, res)
        return _final(self, h, t_emb, x.dtype, res)


class DiTAttentionChunk(DiTAttention):
    """KV-cached attention over a hop's Lq new frames: one float32 softmax
    over [the cached slots ++ the hop's own frames], with the cache read
    only. Returns the output and the hop's post-rotary K and V, which the
    caller appends once a hop (models/flow.cfm_solve_chunk)."""

    def forward(self, x, k_cache, v_cache, cos, sin, bias_cache, bias_new):
        """x (B, Lq, dim); k_cache, v_cache (B, heads, C, dh), head-major;
        cos, sin (B, Lq, rot) at absolute positions; bias_cache (B, Lq, C)
        and bias_new (B, Lq, Lq) additive float32 (ops/masks.chunk_split_bias).
        Returns (out, k_new, v_new), k_new and v_new (B, heads, Lq, dh)."""
        c = self.cfg
        b, lq, _ = x.shape
        q, k, v = qdense(x, self.to_qkv).chunk(3, dim=-1)
        q, k = self.rotate(q, k, cos, sin)
        heads = lambda t: t.reshape(b, lq, c.heads, c.dim_head).transpose(1, 2)
        qh, kh, vh = heads(q), heads(k), heads(v)
        scale = math.sqrt(c.dim_head)
        sc = torch.matmul(qh, k_cache.to(x.dtype).transpose(-1, -2)) / scale
        sn = torch.matmul(qh, kh.transpose(-1, -2)) / scale
        cap = k_cache.shape[2]
        scores = torch.cat([sc.float() + bias_cache[:, None], sn.float() + bias_new[:, None]], dim=-1)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(probs[..., :cap], v_cache.to(x.dtype)) + torch.matmul(probs[..., cap:], vh)
        out = out.transpose(1, 2).reshape(b, lq, c.heads * c.dim_head)
        return qdense(out, self.to_out), kh, vh


class DiTBlockChunk(DiTBlock):
    """DiTBlock on a hop's new frames against this layer's read-only K/V."""

    def __init__(self, cfg: DiTConfig):
        super().__init__(cfg)
        self.attn = DiTAttentionChunk(cfg)

    def forward(self, x, mod, k_cache, v_cache, cos, sin, bias_cache, bias_new, res=None):
        """res and the returned (x, (h, gate_mlp)) as DiTBlock's; then the
        hop's k_new, v_new."""
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        x, norm = adaln(x, scale_msa, shift_msa, *(res or ()))
        out, k_new, v_new = self.attn(norm, k_cache, v_cache, cos, sin, bias_cache, bias_new)
        x, ff_norm = adaln(x, scale_mlp, shift_mlp, out, gate_msa)
        return x, (self.mlp(ff_norm), gate_mlp), k_new, v_new


class DiTChunk(DiT):
    """KV-cached streaming velocity estimator: one hop of new frames through
    the whole DiT, reading per-layer K/V caches and the causal position
    convolutions' tails. Exact against the full chunk-masked DiT because
    hops lie on the static chunk grid: a solved frame never attends a later
    one, so its K/V are final when first computed."""

    def __init__(self, cfg: DiTConfig):
        super().__init__(cfg)
        self.blocks = nn.ModuleList([DiTBlockChunk(cfg) for _ in range(cfg.depth)])

    @classmethod
    def of(cls, dit: DiT) -> "DiTChunk":
        """A DiTChunk on `dit`'s own tensors (shared, not copied); on a
        sharded DiT's parts, sharded as it is (parallel/sharding.py)."""
        mesh = getattr(dit, "tp_mesh", None)
        with torch.device("meta"):
            out = cls(dit.cfg if mesh is None else replace(dit.cfg, heads=dit.cfg.heads * mesh.tp))
        if mesh is not None:
            from ..parallel.sharding import shard_module

            shard_module(out, mesh)
        out.load_state_dict(dit.state_dict(), strict=True, assign=True)
        return out.requires_grad_(False).eval()

    def forward(self, x, mu, t, spks, cond, cache: dict, lens, bias_cache, bias_new, mods):
        """x, mu, cond (B, Lq, mel) the hop's new frames; t (B,); spks (B,
        spk_dim); cache {'k', 'v': (depth, B, heads, C, dh), 'tail1',
        'tail2': (B, K-1, dim)}, read only; lens (B,) frames already cached
        (the rotary offset); bias_cache (B, Lq, C), bias_new (B, Lq, Lq);
        mods (depth, B, 6*dim). Returns (velocity, {'k', 'v': (depth, B,
        heads, Lq, dh) new rows, 'tail1', 'tail2': the updated tails})."""
        c = self.cfg
        lq = x.shape[1]
        t_emb, h = _embed(self, x, mu, t, spks, cond)
        conv, tail1, tail2 = self.conv_pos_embed(h, tails=(cache["tail1"], cache["tail2"]))
        h = conv + h

        # rotary at absolute positions (interleaved pairs, the first dim_head channels only)
        inv = 1.0 / (10000.0 ** (torch.arange(0, c.dim_head, 2, dtype=torch.float32, device=x.device) / c.dim_head))
        pos = lens[:, None].float() + torch.arange(lq, dtype=torch.float32, device=x.device)[None, :]
        f = torch.repeat_interleave(pos[:, :, None] * inv[None, None, :], 2, dim=-1)
        cos, sin = torch.cos(f).to(x.dtype), torch.sin(f).to(x.dtype)
        ks, vs, res = [], [], None
        for i, blk in enumerate(self.blocks):
            h, res, k_new, v_new = blk(h, mods[i], cache["k"][i], cache["v"][i], cos, sin, bias_cache, bias_new, res)
            ks.append(k_new)
            vs.append(v_new)
        out = _final(self, h, t_emb, x.dtype, res)
        return out, {"k": torch.stack(ks), "v": torch.stack(vs), "tail1": tail1, "tail2": tail2}
