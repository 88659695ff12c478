"""The CosyVoice1/2 flows: tokens -> mel through a conformer encoder and a
U-Net CFM (fangyan_tts_tpu/models/flow_xvec.py, the inference half).

- `CausalMaskedDiffWithXvec` (v2): token embedding, the
  `UpsampleConformerEncoder` (x2 to the mel rate, 3-token lookahead), a
  projection to 80, and `xvec_flow_inference`: the cosine-scheduled Euler
  CFG solve (`unet_cfg_solve`) of the causal U-Net from the fixed CFM noise.
- `MaskedDiffWithXvec` (v1): token embedding, `ConformerEncoder`, the
  projection, `InterpolateRegulator` (50 Hz tokens -> the 22.05 kHz / 256
  mel rate, prompt and generated spans interpolated separately, the first
  and last 20 generated tokens pinned to 34 frames each), and
  `xvec_flow_inference_v1` with the z / mu flow cache that pins the noise
  and the encoder output over the prompt and the 34-frame chunk overlap.

Both flows' `forward` is the training loss (`cfm_train_loss`, the
conditional flow matching loss on the U-Net with autograd; v2 with its
`streaming` chunk mask, v1 through `InterpolateRegulator.forward`). Torch
cannot reproduce `jax.random`, so the loss takes its five draws as an
argument (models/flow.flow_train_draws makes them). The v1 inference draws
its noise from a `torch.Generator` (the JAX package's PRNG key); `noise`
overrides it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convs import conv1d
from .conformer import AffineParams, ConformerEncoder, UpsampleConformerEncoder
from .dit import ConvParams
from .flow import cosine_t_span, fixed_cfm_noise
from .qwen2 import flax_dense
from .unet_decoder import ConditionalDecoder, mish


TRAINING_CFG_RATE = 0.2  # the share of rows that lose mu, spks and the condition


def cfm_train_loss(estimator: ConditionalDecoder, sigma_min: float, mu, spks, feat, feat_len, draws: dict,
                   streaming: bool = False) -> torch.Tensor:
    """The conditional flow matching loss of the x-vector flows: half the
    rows (draws["use_cond"]) keep a random prefix of up to 0.3 of their mel
    as the condition; the target is the straight path from the noise z to
    feat at time t; rows whose draws["cfg"] is at or under TRAINING_CFG_RATE
    lose mu, spks and the condition. mu (B, >= L_mel, 80) is cut to feat's
    L_mel; the squared error over the valid frames is divided by their count
    times the mel dim."""
    b, l_mel, d = feat.shape
    mu = mu[:, :l_mel]
    pos = torch.arange(l_mel, device=feat.device)[None, :]
    mask = (pos < feat_len[:, None])[..., None].to(feat.dtype)
    cond_len = (draws["cond_len"] * 0.3 * feat_len.float()).to(torch.int32)
    conds = feat * ((pos < cond_len[:, None]) & draws["use_cond"][:, None])[..., None].to(feat.dtype)
    t, z = draws["t"].reshape(b), draws["z"]
    y = (1 - (1 - sigma_min) * t[:, None, None]) * z + t[:, None, None] * feat
    u = feat - (1 - sigma_min) * z
    keep = (draws["cfg"] > TRAINING_CFG_RATE).to(feat.dtype)
    pred = estimator(y, mu * keep[:, None, None], t, spks * keep[:, None], conds * keep[:, None, None], feat_len,
                     streaming=streaming)
    return (((pred - u) * mask) ** 2).sum() / (mask.sum() * d)


def _l2_normalize(embedding: torch.Tensor) -> torch.Tensor:
    return embedding / torch.clamp(torch.linalg.norm(embedding, dim=1, keepdim=True), min=1e-12)


def _interp_gather(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of x (B, L, C) at fractional source coordinates
    src (M,) -> (B, M, C)."""
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=x.shape[1] - 1)
    w = (src - lo.to(src.dtype))[None, :, None].to(x.dtype)
    return x[:, lo] * (1 - w) + x[:, hi] * w


def _interp_src(j: torch.Tensor, src_len, out_len) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False)'s source coordinate
    (j + 0.5) * L / M - 0.5, clamped to [0, L-1]; float32."""
    sl = torch.as_tensor(src_len, dtype=torch.float32, device=j.device)
    ol = torch.clamp(torch.as_tensor(out_len, dtype=torch.float32, device=j.device), min=1.0)
    return torch.clamp((j + 0.5) * (sl / ol) - 0.5, min=0.0, max=float(torch.clamp(sl - 1.0, min=0.0)))


class InterpolateRegulator(nn.Module):
    """Linear interpolation to the mel rate, then [conv k3, GroupNorm,
    Mish] x num_blocks and a k1 conv."""

    def __init__(self, channels: int = 80, num_blocks: int = 4, groups: int = 1):
        super().__init__()
        self.num_blocks, self.groups = num_blocks, groups
        for i in range(num_blocks):
            setattr(self, f"conv_{i}", ConvParams(channels, channels, 3))
            setattr(self, f"norm_{i}", AffineParams(channels))
        self.out = ConvParams(channels, channels, 1)

    def _group_norm(self, h, norm: AffineParams, mask, eps: float = 1e-5):
        """GroupNorm over (C / groups, T); with mask (B, L, 1) the statistics
        count only valid positions."""
        b, l, c = h.shape
        g = self.groups
        hg = h.reshape(b, l, g, c // g)
        if mask is None:
            mean = hg.mean(dim=(1, 3), keepdim=True)
            var = ((hg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        else:
            m = mask.reshape(b, l, 1, 1).to(h.dtype)
            cnt = torch.clamp(m.sum(dim=1, keepdim=True) * (c // g), min=1.0)
            mean = (hg * m).sum(dim=(1, 3), keepdim=True) / cnt
            var = (((hg - mean) * m) ** 2).sum(dim=(1, 3), keepdim=True) / cnt
        out = (hg - mean) / torch.sqrt(var + eps)
        return out.reshape(b, l, c) * norm.scale.to(h.dtype) + norm.bias.to(h.dtype)

    def _conv_stack(self, h, valid_len=None):
        mask = None
        if valid_len is not None:
            mask = (torch.arange(h.shape[1], device=h.device)[None, :] < valid_len[:, None]).to(h.dtype)[..., None]
        for i in range(self.num_blocks):
            if mask is not None:
                h = h * mask
            conv = getattr(self, f"conv_{i}")
            h = conv1d(h, conv.weight.to(h.dtype), conv.bias.to(h.dtype), padding=1)
            h = mish(self._group_norm(h, getattr(self, f"norm_{i}"), mask))
        if mask is not None:
            h = h * mask
        h = conv1d(h, self.out.weight.to(h.dtype), self.out.bias.to(h.dtype))
        return h * mask if mask is not None else h

    def forward(self, x, target_len: int):
        """The training path: x (B, Lt, C) -> (B, target_len, C), GroupNorm
        over the whole padded length."""
        j = torch.arange(target_len, dtype=torch.float32, device=x.device)
        return self._conv_stack(_interp_gather(x, _interp_src(j, x.shape[1], target_len)))

    def inference(self, h, token_len1: int, token_len2: int, mel_len1: int, mel_len2: int, out_len: int):
        """h (B, L_pad, C): encoded prompt ++ generated ++ pad. The prompt
        (token_len1 tokens -> mel_len1 frames) and the generated span
        (token_len2 -> mel_len2) interpolate separately; past 40 generated
        tokens the first and last 20 pin to 34 frames each. Returns
        (B, out_len, C), GroupNorm statistics over the valid frames."""
        j = torch.arange(out_len, dtype=torch.float32, device=h.device)
        tl1 = float(token_len1)
        tl2 = torch.tensor(float(token_len2), dtype=torch.float32, device=h.device)
        ml2 = torch.tensor(float(mel_len2), dtype=torch.float32, device=h.device)
        src1 = _interp_src(j, tl1, float(max(mel_len1, 1)))
        j2 = j - mel_len1
        head = _interp_src(j2, 20.0, 34.0)
        jt = j2 - (ml2 - 34.0)
        tail = (tl2 - 20.0) + _interp_src(jt, 20.0, 34.0)
        jm = j2 - 34.0
        mid = 20.0 + torch.clamp((jm + 0.5) * ((tl2 - 40.0) / torch.clamp(ml2 - 68.0, min=1.0)) - 0.5,
                                 min=0.0, max=float(max(token_len2 - 41.0, 0.0)))
        split = torch.where(j2 < 34.0, head, torch.where(jt >= 0.0, tail, mid))
        plain = _interp_src(j2, tl2, ml2)
        src2 = tl1 + (split if token_len2 > 40 else plain)
        src = torch.where(j < mel_len1, src1, src2)
        valid = torch.full((h.shape[0],), mel_len1 + mel_len2, dtype=torch.int32, device=h.device)
        return self._conv_stack(_interp_gather(h, src), valid_len=valid)


class CausalMaskedDiffWithXvec(nn.Module):
    """The CosyVoice2 flow; the defaults are CosyVoice2-0.5B's."""

    def __init__(self, vocab_size: int = 6561, input_size: int = 512, output_size: int = 80, spk_embed_dim: int = 192,
                 token_mel_ratio: int = 2, pre_lookahead_len: int = 3, static_chunk_size: int = 25,
                 n_timesteps: int = 10, inference_cfg_rate: float = 0.7, sigma_min: float = 1e-6,
                 decoder_channels: tuple = (256,), num_mid_blocks: int = 12, n_blocks: int = 4, num_heads: int = 8,
                 attention_head_dim: int = 64, enc_heads: int = 8, enc_ffn: int = 2048, enc_blocks: int = 6,
                 enc_up_blocks: int = 4):
        super().__init__()
        self.vocab_size, self.output_size = vocab_size, output_size
        self.token_mel_ratio, self.pre_lookahead_len = token_mel_ratio, pre_lookahead_len
        self.static_chunk_size, self.n_timesteps = static_chunk_size, n_timesteps
        self.inference_cfg_rate, self.sigma_min = inference_cfg_rate, sigma_min
        self.input_embedding = nn.Embedding(vocab_size, input_size)
        self.spk_embed_affine_layer = nn.Linear(spk_embed_dim, output_size)
        self.encoder = UpsampleConformerEncoder(
            dim=input_size, heads=enc_heads, ffn_hidden=enc_ffn, num_blocks=enc_blocks, num_up_blocks=enc_up_blocks,
            pre_lookahead_len=pre_lookahead_len, static_chunk_size=static_chunk_size)
        self.encoder_proj = nn.Linear(input_size, output_size)
        self.estimator = ConditionalDecoder(
            in_channels=320, out_channels=output_size, channels=decoder_channels, n_blocks=n_blocks,
            num_mid_blocks=num_mid_blocks, num_heads=num_heads, attention_head_dim=attention_head_dim, causal=True,
            static_chunk_size=static_chunk_size * token_mel_ratio)

    def prepare_inference(self, token, token_len, prompt_feat, prompt_feat_len, embedding, finalize: bool = True,
                          streaming: bool = False):
        """token (B, L) prompt ++ target tokens ++ pad. finalize=False: the
        last pre_lookahead_len valid tokens are context only (they stay in
        place and the encoder's length excludes them). Returns (mu, spks,
        conds, mel lengths)."""
        spks = flax_dense(_l2_normalize(embedding), self.spk_embed_affine_layer)
        l = token.shape[1]
        valid = torch.arange(l, device=token.device)[None, :] < token_len[:, None]
        h = self.input_embedding(token.clamp(0, self.vocab_size - 1)) * valid[..., None].float()
        enc_len = token_len if finalize else token_len - self.pre_lookahead_len
        h, out_lens = self.encoder(h, enc_len, streaming=streaming)
        mu = flax_dense(h, self.encoder_proj)
        l_mel = mu.shape[1]
        pf = prompt_feat.to(mu.dtype)
        pf = F.pad(pf, (0, 0, 0, l_mel - pf.shape[1])) if pf.shape[1] < l_mel else pf[:, :l_mel]
        pos = torch.arange(l_mel, device=mu.device)[None, :, None]
        conds = torch.where(pos < prompt_feat_len[:, None, None], pf, torch.zeros_like(pf))
        return mu, spks, conds, out_lens

    def forward(self, token, token_len, feat, feat_len, embedding, draws: dict,
                streaming: bool = False) -> tuple[torch.Tensor, dict]:
        """Training loss: token (B, Lt), token_len (B,), feat (B, L_mel, 80)
        target mel, feat_len (B,), embedding (B, 192), draws from
        models/flow.flow_train_draws; `streaming` runs the encoder and the
        U-Net under their chunk masks. Returns (loss, {})."""
        mu, spks, _, _ = self.prepare_inference(token, token_len, feat, feat_len, embedding, streaming=streaming)
        return cfm_train_loss(self.estimator, self.sigma_min, mu, spks, feat, feat_len, draws, streaming), {}


class MaskedDiffWithXvec(nn.Module):
    """The CosyVoice1 flow; the defaults are CosyVoice-300M's."""

    def __init__(self, vocab_size: int = 4096, input_size: int = 512, output_size: int = 80, spk_embed_dim: int = 192,
                 input_frame_rate: int = 50, n_timesteps: int = 10, inference_cfg_rate: float = 0.7,
                 sigma_min: float = 1e-6, decoder_channels: tuple = (256, 256), num_mid_blocks: int = 12,
                 n_blocks: int = 4, num_heads: int = 8, attention_head_dim: int = 64, enc_heads: int = 8,
                 enc_ffn: int = 2048, enc_blocks: int = 6, mel_rate: float = 50.0):
        super().__init__()
        self.vocab_size, self.output_size = vocab_size, output_size
        self.input_frame_rate, self.n_timesteps = input_frame_rate, n_timesteps
        self.inference_cfg_rate, self.sigma_min = inference_cfg_rate, sigma_min
        self.input_embedding = nn.Embedding(vocab_size, input_size)
        self.spk_embed_affine_layer = nn.Linear(spk_embed_dim, output_size)
        self.encoder = ConformerEncoder(dim=input_size, heads=enc_heads, ffn_hidden=enc_ffn, num_blocks=enc_blocks,
                                        macaron=False, use_cnn=False)
        self.encoder_proj = nn.Linear(input_size, output_size)
        self.length_regulator = InterpolateRegulator(output_size)
        self.estimator = ConditionalDecoder(
            in_channels=320, out_channels=output_size, channels=decoder_channels, n_blocks=n_blocks,
            num_mid_blocks=num_mid_blocks, num_heads=num_heads, attention_head_dim=attention_head_dim, causal=False)

    def encode_inference(self, token, token_len1: int, token_len2: int, prompt_feat, embedding, mel_len2: int,
                         out_len: int):
        """token (B, L_pad): token_len1 prompt tokens, token_len2 generated,
        pad; prompt_feat (B, mel_len1, 80) of the prompt's exact length.
        Returns (mu (B, out_len, 80), spks, conds, lens = mel_len1 + mel_len2)."""
        spks = flax_dense(_l2_normalize(embedding), self.spk_embed_affine_layer)
        b, l = token.shape
        dev = token.device
        mel_len1 = prompt_feat.shape[1]
        total_len = torch.full((b,), token_len1 + token_len2, dtype=torch.int32, device=dev)
        valid = torch.arange(l, device=dev)[None, :] < total_len[:, None]
        h = self.input_embedding(token.clamp(0, self.vocab_size - 1)) * valid[..., None].float()
        h, _ = self.encoder(h, total_len)
        h = flax_dense(h, self.encoder_proj)
        mu = self.length_regulator.inference(h, token_len1, token_len2, mel_len1, mel_len2, out_len)
        pf = F.pad(prompt_feat.to(mu.dtype), (0, 0, 0, max(out_len - mel_len1, 0)))[:, :out_len]
        pos = torch.arange(out_len, device=dev)[None, :, None]
        conds = torch.where(pos < mel_len1, pf, torch.zeros_like(pf))
        lens = torch.full((b,), mel_len1 + mel_len2, dtype=torch.int32, device=dev)
        return mu, spks, conds, lens

    def forward(self, token, token_len, feat, feat_len, embedding, draws: dict) -> tuple[torch.Tensor, dict]:
        """Training loss: the encoded tokens projected to 80 and interpolated
        to feat's length (InterpolateRegulator.forward), then the U-Net's
        flow matching loss (cfm_train_loss) with the draws of
        models/flow.flow_train_draws. Returns (loss, {})."""
        spks = flax_dense(_l2_normalize(embedding), self.spk_embed_affine_layer)
        valid = torch.arange(token.shape[1], device=token.device)[None, :] < token_len[:, None]
        h = self.input_embedding(token.clamp(0, self.vocab_size - 1)) * valid[..., None].float()
        h, _ = self.encoder(h, token_len)
        mu = self.length_regulator(flax_dense(h, self.encoder_proj), feat.shape[1])
        return cfm_train_loss(self.estimator, self.sigma_min, mu, spks, feat, feat_len, draws), {}


def unet_cfg_solve(dec: ConditionalDecoder, z, mu, spks, conds, lens, n_timesteps: int, cfg_rate: float,
                   streaming: bool = False) -> torch.Tensor:
    """Euler solve with classifier-free guidance over a doubled batch whose
    second half has zeroed mu / spks / cond, on the cosine t schedule."""
    b = z.shape[0]
    t_span = torch.from_numpy(cosine_t_span(n_timesteps)).to(z.device, z.dtype)
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spks2 = torch.cat([spks, torch.zeros_like(spks)])
    cond2 = torch.cat([conds, torch.zeros_like(conds)])
    lens2 = torch.cat([lens, lens])
    x = z
    for i in range(n_timesteps):
        t, dt = t_span[i], t_span[i + 1] - t_span[i]
        v = dec(torch.cat([x, x]), mu2, t.expand(2 * b), spks2, cond2, lens2, streaming=streaming)
        dphi = (1.0 + cfg_rate) * v[:b] - cfg_rate * v[b:]
        x = x + dt * dphi
    return x


@torch.no_grad()
def xvec_flow_inference(model: CausalMaskedDiffWithXvec, token, token_len, prompt_feat, prompt_feat_len, embedding,
                        streaming: bool = False, finalize: bool = True, noise: torch.Tensor | None = None):
    """The v2 flow: prepare_inference, then the CFG Euler solve from the
    fixed CFM noise (or `noise` (1, >= L_mel, 80)). Returns mel (B, L_mel, 80)."""
    mu, spks, conds, out_lens = model.prepare_inference(token, token_len, prompt_feat, prompt_feat_len, embedding,
                                                        finalize=finalize, streaming=streaming)
    b, l_mel, d = mu.shape
    if noise is None:
        noise = torch.from_numpy(fixed_cfm_noise()[:, :l_mel]).to(mu.device)
    z = noise[:, :l_mel].expand(b, l_mel, d).to(mu.dtype)
    return unet_cfg_solve(model.estimator, z, mu, spks, conds, out_lens, model.n_timesteps,
                          model.inference_cfg_rate, streaming=streaming)


def init_v1_flow_cache(mel_len1: int, mel_dim: int = 80, overlap: int = 34, device=None) -> torch.Tensor:
    """An empty v1 flow cache (1, mel_len1 + 34, 80, 2)."""
    return torch.zeros((1, mel_len1 + overlap, mel_dim, 2), dtype=torch.float32, device=device)


@torch.no_grad()
def xvec_flow_inference_v1(model: MaskedDiffWithXvec, token, token_len1: int, token_len2: int, prompt_feat, embedding,
                           mel_len2: int, generator: torch.Generator | None = None,
                           cache: torch.Tensor | None = None, out_len: int | None = None,
                           noise: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The v1 flow with the z / mu cache. token (B, L_pad) prompt ++
    generated ++ pad; prompt_feat (B, mel_len1, 80); mel_len2 =
    int(token_len2 / 50 * 22050 / 256). The noise z (B, out_len, 80) is
    drawn from `generator` unless `noise` is given. With `cache` (B,
    mel_len1 + 34, 80, 2) the first mel_len1 + 34 frames of z and mu are the
    cached ones. Returns (mel (B, out_len, 80), the new cache: the prompt
    frames and the last 34 valid frames of z and mu)."""
    mel_len1 = prompt_feat.shape[1]
    if out_len is None:
        out_len = token.shape[1] * 2
    mu, spks, conds, lens = model.encode_inference(token, token_len1, token_len2, prompt_feat, embedding, mel_len2,
                                                   out_len)
    b = mu.shape[0]
    if noise is not None:
        z = noise[:, :out_len].to(mu.device, mu.dtype)
    else:
        z = torch.randn((b, out_len, model.output_size), generator=generator, device=mu.device,
                        dtype=torch.float32).to(mu.dtype)
    if cache is not None:
        z = torch.cat([cache[..., 0].to(z.dtype), z[:, mel_len1 + 34:]], dim=1)
        mu = torch.cat([cache[..., 1].to(mu.dtype), mu[:, mel_len1 + 34:]], dim=1)
    tail = max(mel_len1 + mel_len2 - 34, 0)
    new_cache = torch.stack([torch.cat([z[:, :mel_len1], z[:, tail: tail + 34]], dim=1),
                             torch.cat([mu[:, :mel_len1], mu[:, tail: tail + 34]], dim=1)], dim=-1)
    mel = unet_cfg_solve(model.estimator, z, mu, spks, conds, lens, model.n_timesteps, model.inference_cfg_rate)
    return mel, new_cache
