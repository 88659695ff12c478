"""Token-to-mel conditional flow matching, CosyVoice3 `CausalMaskedDiffWithDiT`
(fangyan_tts_tpu/models/flow.py), offline inference.

The classifier-free-guidance pair rides the batch: every DiT call sees 2B
rows, and the flash-attention kernel gets the doubled `mel_len`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import FlowConfig
from ..ops.convs import conv1d, upsample_nearest
from .dit import DiT, ConvParams, precompute_mods
from .qwen2 import flax_dense


@functools.lru_cache(maxsize=1)
def fixed_cfm_noise(mel_dim: int = 80, max_len: int = 15000) -> np.ndarray:
    """The reference's fixed noise: torch.randn([1, mel_dim, max_len]) after
    seeding the CPU generator with 0. Drawn on the CPU from a local
    generator (the global seed is left alone), returned channels-last
    (1, max_len, mel_dim)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    noise = torch.randn([1, mel_dim, max_len], generator=g)
    return noise.numpy().transpose(0, 2, 1).copy()


class PreLookaheadLayer(nn.Module):
    """conv1 (k = pre_lookahead_len + 1, right zero pad), leaky_relu,
    conv2 (k = 3, left pad 2), residual."""

    def __init__(self, in_channels: int = 80, channels: int = 1024, pre_lookahead_len: int = 3):
        super().__init__()
        self.pre_lookahead_len = pre_lookahead_len
        self.conv1 = ConvParams(in_channels, channels, pre_lookahead_len + 1)
        self.conv2 = ConvParams(channels, in_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = conv1d(x, self.conv1.weight.to(dt), self.conv1.bias.to(dt), padding=(0, self.pre_lookahead_len))
        h = F.leaky_relu(h, negative_slope=0.01)
        h = conv1d(h, self.conv2.weight.to(dt), self.conv2.bias.to(dt), padding=(2, 0))
        return h + x


def cosine_t_span(n_timesteps: int) -> np.ndarray:
    """1 - cos(linspace(0, 1, n+1) * pi/2), float32."""
    t = np.linspace(0.0, 1.0, n_timesteps + 1)
    return (1.0 - np.cos(t * 0.5 * np.pi)).astype(np.float32)


class CausalMaskedDiffWithDiT(nn.Module):
    def __init__(self, cfg: FlowConfig):
        super().__init__()
        self.cfg = cfg
        self.input_embedding = nn.Embedding(cfg.vocab_size, cfg.input_size)
        self.spk_embed_affine_layer = nn.Linear(cfg.spk_embed_dim, cfg.output_size)
        self.pre_lookahead_layer = PreLookaheadLayer(cfg.input_size, cfg.pre_lookahead_channels, cfg.pre_lookahead_len)
        self.estimator = DiT(cfg.dit)

    def prepare_inference(self, token, token_len, prompt_feat, prompt_feat_len, embedding):
        """Offline (finalize) preprocessing. token (B, Lt) prompt + target
        speech tokens; prompt_feat (B, Lp_mel, mel); embedding (B, 192).
        Returns (mu (B, L, mel), spks (B, mel), conds (B, L, mel),
        mel_len (B,) int32)."""
        c = self.cfg
        emb = embedding / torch.linalg.vector_norm(embedding, dim=1, keepdim=True).clamp_min(1e-12)
        spks = flax_dense(emb, self.spk_embed_affine_layer)

        l = token.shape[1]
        valid = torch.arange(l, device=token.device)[None, :] < token_len[:, None]
        token_emb = self.input_embedding(token.clamp(0, c.vocab_size - 1))
        token_emb = token_emb * valid[..., None].to(token_emb.dtype)
        h = upsample_nearest(self.pre_lookahead_layer(token_emb), c.token_mel_ratio)

        l_mel = h.shape[1]
        mel_len = valid.to(torch.int32).sum(dim=1, dtype=torch.int32) * c.token_mel_ratio
        pf = prompt_feat.to(h.dtype)
        if pf.shape[1] < l_mel:
            pf = F.pad(pf, (0, 0, 0, l_mel - pf.shape[1]))
        else:
            pf = pf[:, :l_mel]
        pos = torch.arange(l_mel, device=h.device)[None, :, None]
        conds = torch.where(pos < prompt_feat_len[:, None, None], pf, torch.zeros((), dtype=pf.dtype, device=pf.device))
        return h, spks, conds, mel_len


@torch.no_grad()
def cfm_solve(cfg: FlowConfig, dit: DiT, z, mu, spks, conds, mel_len) -> torch.Tensor:
    """Offline CFG Euler solve over the cosine time span, the CFG pair
    batched (2B), full (chunk 0) attention over the valid frames.
    z, mu, conds (B, L, mel); spks (B, mel); mel_len (B,) int32."""
    b = z.shape[0]
    mu2 = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks2 = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond2 = torch.cat([conds, torch.zeros_like(conds)], dim=0)
    mel_len2 = torch.cat([mel_len, mel_len], dim=0).to(torch.int32).contiguous()
    rate = cfg.inference_cfg_rate

    t_span = torch.from_numpy(cosine_t_span(cfg.n_timesteps)).to(device=z.device, dtype=z.dtype)
    ts, dts = t_span[:-1], t_span[1:] - t_span[:-1]
    all_mods = precompute_mods(dit, ts[:, None].expand(ts.shape[0], 2 * b), z.dtype)

    x = z
    for i in range(cfg.n_timesteps):
        x2 = torch.cat([x, x], dim=0)
        t2 = ts[i].expand(2 * b)
        v = dit(x2, mu2, t2, spks2, cond2, mel_len2, 0, all_mods[i])
        dphi = (1.0 + rate) * v[:b] - rate * v[b:]
        x = x + dts[i] * dphi
    return x
