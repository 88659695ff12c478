"""Token-to-mel conditional flow matching, CosyVoice3 `CausalMaskedDiffWithDiT`
(fangyan_tts_tpu/models/flow.py): the training loss (`forward`), offline
inference, the streaming shapes of `prepare_inference` (finalize=False) and
the chunk-masked solve (`cfm_solve(streaming=True)`), and the KV-cached
streaming hop (`prepare_chunk`, `empty_kv_cache`, `cfm_solve_chunk`).

The classifier-free-guidance pair rides the batch: every DiT call sees 2B
rows, and the flash-attention kernel gets the doubled `mel_len`. The
training loss runs the DiT on its dense attention route, which has a
backward. Torch cannot reproduce `jax.random`, so the loss takes its five
random draws as an argument (`flow_train_draws` makes them from a
torch.Generator, with the JAX package's distributions).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import FlowConfig
from ..ops.convs import conv1d, upsample_nearest
from ..ops.masks import chunk_split_bias
from ..utils.profiling import span
from .dit import DiT, DiTChunk, ConvParams, precompute_mods
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
    conv2 (k = 3, left pad 2), residual.

    `context` (B, n, C): the lookahead tokens of a streaming step, taken in
    place of conv1's right zeros. `chunk_left` (2) selects the KV-streaming
    hop: x is [2 frames of conv2 left context ++ the new frames ++ the
    lookahead (unless chunk_finalize, whose right context is zeros)], and
    only the new frames come out, equal to the whole sequence's there."""

    def __init__(self, in_channels: int = 80, channels: int = 1024, pre_lookahead_len: int = 3):
        super().__init__()
        self.pre_lookahead_len = pre_lookahead_len
        self.conv1 = ConvParams(in_channels, channels, pre_lookahead_len + 1)
        self.conv2 = ConvParams(channels, in_channels, 3)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None, chunk_left: int = 0,
                chunk_finalize: bool = False) -> torch.Tensor:
        dt = x.dtype
        w1, b1 = self.conv1.weight.to(dt), self.conv1.bias.to(dt)
        w2, b2 = self.conv2.weight.to(dt), self.conv2.bias.to(dt)
        la = self.pre_lookahead_len
        if chunk_left:
            assert chunk_left == 2, "conv2 (k=3) takes 2 frames of left context"
            h = F.leaky_relu(conv1d(x, w1, b1, padding=(0, la if chunk_finalize else 0)), negative_slope=0.01)
            h = conv1d(h, w2, b2)
            return h + x[:, chunk_left : chunk_left + h.shape[1]]
        if context is None:
            h = conv1d(x, w1, b1, padding=(0, la))
        else:
            h = conv1d(torch.cat([x, context], dim=1), w1, b1, padding=(0, la - context.shape[1]))
        h = F.leaky_relu(h, negative_slope=0.01)
        h = conv1d(h, w2, b2, padding=(2, 0))
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

    def prepare_inference(self, token, token_len, prompt_feat, prompt_feat_len, embedding, finalize: bool = True,
                          padded_streaming: bool = False):
        """Preprocessing. token (B, Lt) prompt + target speech tokens;
        prompt_feat (B, Lp_mel, mel); embedding (B, 192). With
        finalize=False (a streaming step) each row's last pre_lookahead_len
        positions are the lookahead context and give no frames. With
        padded_streaming as well, the rows are right-padded instead,
        [tokens ++ lookahead ++ zeros] with token_len covering the
        lookahead: the convolution runs over the whole buffer and the frames
        below token_len - lookahead equal the context-split form's (their
        receptive field never reaches the padding), so rows of different
        lengths share one batched call (infer/batch_stream.py young hops).
        Returns (mu (B, L, mel), spks (B, mel), conds (B, L, mel), mel_len
        (B,) int32)."""
        with span("flow.prepare"):
            c = self.cfg
            emb = embedding / torch.linalg.vector_norm(embedding, dim=1, keepdim=True).clamp_min(1e-12)
            spks = flax_dense(emb, self.spk_embed_affine_layer)

            l = token.shape[1]
            valid = torch.arange(l, device=token.device)[None, :] < token_len[:, None]
            token_emb = self.input_embedding(token.clamp(0, c.vocab_size - 1))
            token_emb = token_emb * valid[..., None].to(token_emb.dtype)
            if finalize:
                h = self.pre_lookahead_layer(token_emb)
            elif padded_streaming:
                h = self.pre_lookahead_layer(token_emb)
                valid = valid & (torch.arange(l, device=token.device)[None, :]
                                 < (token_len - c.pre_lookahead_len)[:, None])
            else:
                la = c.pre_lookahead_len
                h = self.pre_lookahead_layer(token_emb[:, :-la], token_emb[:, -la:])
                valid = valid[:, :-la]
            h = upsample_nearest(h, c.token_mel_ratio)

            l_mel = h.shape[1]
            mel_len = valid.to(torch.int32).sum(dim=1, dtype=torch.int32) * c.token_mel_ratio
            pf = prompt_feat.to(h.dtype)
            if pf.shape[1] < l_mel:
                pf = F.pad(pf, (0, 0, 0, l_mel - pf.shape[1]))
            else:
                pf = pf[:, :l_mel]
            pos = torch.arange(l_mel, device=h.device)[None, :, None]
            conds = torch.where(pos < prompt_feat_len[:, None, None], pf,
                                torch.zeros((), dtype=pf.dtype, device=pf.device))
            return h, spks, conds, mel_len

    def prepare_chunk(self, token_ctx: torch.Tensor, finalize: bool = False,
                      n_valid: torch.Tensor | None = None) -> torch.Tensor:
        """mu of one KV-streaming hop's new tokens. token_ctx (B, 2 + n_new
        [+ pre_lookahead_len]): 2 tokens of conv2 left context, the new
        tokens, and (unless finalize) the lookahead. n_valid (B,) zeroes the
        embeddings past 2 + n_valid (a right-padded finalize row, as
        prepare_inference's padding mask does). Returns (B, n_new * ratio,
        input_size), equal to prepare_inference's rows there."""
        c = self.cfg
        emb = self.input_embedding(token_ctx.clamp(0, c.vocab_size - 1))
        if n_valid is not None:
            keep = torch.arange(token_ctx.shape[1], device=token_ctx.device)[None, :] < (2 + n_valid)[:, None]
            emb = emb * keep[..., None].to(emb.dtype)
        h = self.pre_lookahead_layer(emb, chunk_left=2, chunk_finalize=finalize)
        return upsample_nearest(h, c.token_mel_ratio)

    def forward(self, token, token_len, feat, feat_len, embedding, draws: dict,
                streaming: bool = False, total=None) -> tuple[torch.Tensor, dict]:
        """Training loss: token (B, Lt), token_len (B,), feat (B, L_mel, mel)
        target mel, feat_len (B,), embedding (B, 192), draws from
        flow_train_draws. Half the rows (draws["use_cond"]) keep a random
        prefix of up to 0.3 of their mel as the prompt condition; the CFM
        target is the straight path from the noise z to feat at time t; rows
        whose draws["cfg"] is at or under training_cfg_rate lose mu, spks
        and the condition. The DiT runs on its dense route, full attention
        over the valid frames or, with `streaming`, the static chunk mask.
        Returns (loss, {"loss_cfm": loss}): the squared error over the valid
        frames, divided by their count times the mel dim (`total`, a
        data-parallel step's, sums that count over the data ranks:
        models/llm.label_smoothed_ce)."""
        c = self.cfg
        emb = embedding / torch.linalg.vector_norm(embedding, dim=1, keepdim=True).clamp_min(1e-12)
        spks = flax_dense(emb, self.spk_embed_affine_layer)

        valid = torch.arange(token.shape[1], device=token.device)[None, :] < token_len[:, None]
        token_emb = self.input_embedding(token.clamp(0, c.vocab_size - 1))
        h = self.pre_lookahead_layer(token_emb * valid[..., None].to(token_emb.dtype))
        b, l_mel, d = feat.shape
        h = upsample_nearest(h, c.token_mel_ratio)[:, :l_mel]
        pos = torch.arange(l_mel, device=feat.device)[None, :]
        mask = (pos < feat_len[:, None])[..., None].to(feat.dtype)

        cond_len = (draws["cond_len"] * 0.3 * feat_len.float()).to(torch.int32)
        cond_mask = (pos < cond_len[:, None]) & draws["use_cond"][:, None]
        conds = feat * cond_mask[..., None].to(feat.dtype)

        t, z = draws["t"], draws["z"]
        y = (1 - (1 - c.sigma_min) * t) * z + t * feat
        u = feat - (1 - c.sigma_min) * z
        keep = (draws["cfg"] > c.training_cfg_rate).to(feat.dtype)
        mu, spks, conds = h * keep[:, None, None], spks * keep[:, None], conds * keep[:, None, None]

        chunk = c.dit.static_chunk_size if streaming else 0
        pred = self.estimator(y, mu, t[:, 0, 0], spks, conds, feat_len.to(torch.int32), chunk, dense=True)
        frames = mask.sum() if total is None else total(mask.sum())
        loss = (((pred - u) * mask) ** 2).sum() / (frames * d)
        return loss, {"loss_cfm": loss}

    @functools.cached_property
    def estimator_chunk(self) -> DiTChunk:
        """The KV-cached streaming estimator on the estimator's own tensors."""
        return DiTChunk.of(self.estimator)


def flow_train_draws(b: int, feat_shape: tuple, device, generator: torch.Generator) -> dict:
    """The five random draws of one training loss, float32, made on `device`
    from `generator` (on that device), with the distributions of the JAX
    package's loss: "t" (b, 1, 1) and "cfg", "cond_len" (b,) uniform on
    [0, 1), "z" standard normal of feat_shape, "use_cond" (b,) Bernoulli(0.5)."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {"t": uniform(b, 1, 1), "z": torch.randn(feat_shape, generator=generator, device=device),
            "cfg": uniform(b), "use_cond": uniform(b) < 0.5, "cond_len": uniform(b)}


@torch.no_grad()
def cfm_solve(cfg: FlowConfig, dit: DiT, z, mu, spks, conds, mel_len, streaming: bool = False) -> torch.Tensor:
    """CFG Euler solve over the cosine time span, the CFG pair batched
    (2B): full attention over the valid frames, or with streaming the
    static chunk-causal mask (cfg.dit.static_chunk_size).
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
        with span("flow.euler"):
            x2 = torch.cat([x, x], dim=0)
            t2 = ts[i].expand(2 * b)
            v = dit(x2, mu2, t2, spks2, cond2, mel_len2, cfg.dit.static_chunk_size if streaming else 0, all_mods[i])
            dphi = (1.0 + rate) * v[:b] - rate * v[b:]
            x = x + dts[i] * dphi
    return x


def empty_kv_cache(cfg: FlowConfig, b: int, capacity: int, dtype=torch.bfloat16, device=None) -> dict:
    """Per-Euler-step DiT KV caches for b CFG-paired rows (b = 2 * batch):
    'k', 'v' (T, depth, b, heads, capacity, dim_head), head-major so that
    attention reads them in place, and the two causal position
    convolutions' tails 'tail1', 'tail2' (T, b, K-1, dim)."""
    d = cfg.dit
    t, pad = cfg.n_timesteps, d.conv_pos_kernel - 1
    kv = (t, d.depth, b, d.heads, capacity, d.dim_head)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "tail1": torch.zeros((t, b, pad, d.dim), dtype=dtype, device=device),
        "tail2": torch.zeros((t, b, pad, d.dim), dtype=dtype, device=device),
    }


@torch.no_grad()
def cfm_solve_chunk(cfg: FlowConfig, dit: DiTChunk, z, mu, spks, conds, cache: dict, lens: list[int],
                    q_valid: list[int]) -> torch.Tensor:
    """One streaming hop of the CFG Euler solve over only the new frames,
    against the per-timestep KV caches. z, mu, conds (B, Lq, mel); spks
    (B, mel); cache from empty_kv_cache(..., 2B, C), read during the Euler
    steps and then updated in place once: the hop's K/V rows written at
    `lens` and the tails replaced; lens: the B rows' frames already cached
    and q_valid their valid new frames (Lq except at finalize), host ints
    (the write offsets need no device read). Returns the
    hop's frames (B, Lq, mel). Exact against the full-prefix solve under
    the chunk mask: hops are chunk-aligned, so cached frames never see
    later ones."""
    b, lq, _ = z.shape
    cap = cache["k"].shape[4]
    offsets = [int(n) for n in lens] * 2  # the CFG pair's rows
    lens2 = torch.tensor(offsets, dtype=torch.int32, device=z.device)
    q_valid2 = torch.tensor([int(n) for n in q_valid] * 2, dtype=torch.int32, device=z.device)
    bias_c2, bias_n2 = chunk_split_bias(lens2, q_valid2, lq, cap, cfg.dit.static_chunk_size)
    mu2 = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks2 = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond2 = torch.cat([conds, torch.zeros_like(conds)], dim=0)
    rate = cfg.inference_cfg_rate

    t_span = torch.from_numpy(cosine_t_span(cfg.n_timesteps)).to(device=z.device, dtype=z.dtype)
    ts, dts = t_span[:-1], t_span[1:] - t_span[:-1]
    all_mods = precompute_mods(dit, ts[:, None].expand(ts.shape[0], 2 * b), z.dtype)

    x, new = z, []
    for i in range(cfg.n_timesteps):
        cache_t = {k: v[i] for k, v in cache.items()}
        v, nk = dit(torch.cat([x, x], dim=0), mu2, ts[i].expand(2 * b), spks2, cond2, cache_t, lens2, bias_c2,
                    bias_n2, all_mods[i])
        x = x + dts[i] * ((1.0 + rate) * v[:b] - rate * v[b:])
        new.append(nk)
    # the hop's rows at each row's offset: one slice write when every row shares it (B = 1)
    k_new = torch.stack([n["k"] for n in new])  # (T, depth, 2B, heads, Lq, dh)
    v_new = torch.stack([n["v"] for n in new])
    rows = [slice(None)] if len(set(offsets)) == 1 else range(2 * b)
    for r in rows:
        off = offsets[0 if isinstance(r, slice) else r]
        cache["k"][:, :, r, :, off : off + lq] = k_new[:, :, r]
        cache["v"][:, :, r, :, off : off + lq] = v_new[:, :, r]
    cache["tail1"].copy_(torch.stack([n["tail1"] for n in new]))
    cache["tail2"].copy_(torch.stack([n["tail2"] for n in new]))
    return x
