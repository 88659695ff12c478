"""CosyVoice3 AR speech-token LM on the Qwen2 backbone
(fangyan_tts_tpu/models/llm.py: CosyVoice3LM, generate_speech_tokens, the
resumable streaming decode `decode_prefill` / `decode_chunk`, and the
bistream context extension `bistream_append`).

Prompts are left-padded so every row's valid cache slots are contiguous and
the decode write slot is the same for all rows. The JAX package decodes in
one `lax.while_loop`; here the loop is a Python loop whose early exit reads
`done.all()` once per step (one device-to-host synchronisation a step).
Sampling draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from ..config import LLMConfig
from ..ops.sampling import ras_sample
from . import qwen2 as q


class CosyVoice3LM(nn.Module):
    def __init__(self, cfg: LLMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype  # compute dtype of the prompt prefill
        self.embed_tokens = nn.Embedding(cfg.qwen.vocab_size, cfg.qwen.hidden_size)
        self.speech_embedding = nn.Embedding(cfg.head_size, cfg.llm_input_size)
        self.llm = q.Qwen2Model(cfg.qwen)
        self.llm_decoder = nn.Linear(cfg.llm_output_size, cfg.head_size, bias=False)

    def embed_plan(self, src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """(B, L) src in {0: text, 1: speech/special} + ids -> (B, L, D)."""
        text_e = self.embed_tokens(ids.clamp(0, self.cfg.qwen.vocab_size - 1))
        speech_e = self.speech_embedding(ids.clamp(0, self.cfg.head_size - 1))
        return torch.where((src == 1)[..., None], speech_e, text_e).to(self.dtype)

    def decode_logits(self, h: torch.Tensor) -> torch.Tensor:
        """The bias-free head, with flax Dense's dtype promotion."""
        return q.flax_dense(h, self.llm_decoder)

    def prefill_leftpad(self, src, ids, lengths, cache: dict) -> torch.Tensor:
        """Left-padded prompt prefill into a fresh cache. Row b's tokens
        occupy slots [Tp - len_b, Tp). Returns the last hidden state (B, D);
        slot Tp-1 is always a row's last real token."""
        b, tp = ids.shape
        dev = ids.device
        x = self.embed_plan(src, ids)
        start = (tp - lengths).to(torch.int32)
        slot = torch.arange(tp, dtype=torch.int32, device=dev)[None, :]
        positions = torch.clamp(slot - start[:, None], min=0)
        causal = slot[0][None, :] <= slot[0][:, None]  # (Tp, Tp): key <= query
        key_valid = slot >= start[:, None]
        allowed = causal[None] & key_valid[:, None, :]
        max_len = cache["k"].shape[2]
        bias = torch.full((b, tp, max_len), -1e10, dtype=torch.float32, device=dev)
        bias[:, :, :tp] = torch.where(allowed, 0.0, -1e10)
        h = self.llm(x, positions, bias, cache)
        return h[:, -1]

    def decode_step(self, token, positions, start, end: int, cache: dict) -> torch.Tensor:
        """One AR step for every row. token (B,); positions (B, 1); start (B,)
        first valid slot; end: exclusive slot bound. Runs in the cache's
        dtype. Returns logits (B, V)."""
        emb = self.speech_embedding(token)[:, None, :]
        max_len = cache["k"].shape[2]
        slot = torch.arange(max_len, dtype=torch.int32, device=token.device)[None, None, :]
        bias = torch.where((slot >= start[:, None, None]) & (slot < end), 0.0, -1e10).to(torch.float32)
        h = self.llm(emb.to(cache["k"].dtype), positions, bias, cache)
        return self.decode_logits(h[:, 0])


@torch.no_grad()
def bistream_append(model: CosyVoice3LM, cache: dict | None, seq_pos: int, src: torch.Tensor, ids: torch.Tensor,
                    cache_len: int) -> tuple[dict, torch.Tensor, int]:
    """Extend the contiguous decode context of one stream by an exact plan
    segment src / ids (1, n). Returns (cache, last logits (1, V), seq_pos +
    n). cache None starts a fresh stream in a bf16 cache of cache_len
    slots. A one-token segment is a decode step (ops/decode_attention)."""
    dev = ids.device
    n = ids.shape[1]
    if cache is None:
        cache = q.init_cache(model.cfg.qwen, 1, cache_len, dtype=torch.bfloat16, device=dev)
    x = model.embed_plan(src, ids)
    positions = seq_pos + torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    # causal over the contiguous cache: query j attends the slots up to index + j
    slot = torch.arange(cache["k"].shape[2], dtype=torch.int32, device=dev)[None, None, :]
    qpos = cache["index"][:, None, None] + torch.arange(n, dtype=torch.int32, device=dev)[None, :, None]
    bias = torch.where(slot <= qpos, 0.0, -1e10).to(torch.float32)
    h = model.llm(x.to(cache["k"].dtype), positions, bias, cache)
    return cache, model.decode_logits(h[:, -1]), seq_pos + n


class DecodeResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_new) int32; positions >= num_tokens are 0
    num_tokens: torch.Tensor  # (B,) int32


@torch.no_grad()
def generate_speech_tokens(
    model: CosyVoice3LM,
    src: torch.Tensor,  # (B, Tp) left-padded plan source selector
    ids: torch.Tensor,  # (B, Tp) left-padded plan ids
    prompt_lens: torch.Tensor,  # (B,)
    min_lens: torch.Tensor,  # (B,) new tokens before a stop id is allowed
    max_lens: torch.Tensor,  # (B,) at most this many new tokens
    generator: torch.Generator | None,
    max_new_tokens: int,
    cache_len: int,
) -> DecodeResult:
    """Whole-batch AR decode: RAS sampling, stop ids (>= speech_token_size)
    suppressed while i < min_len, stop on any stop id or at max_len. The
    loop ends once every row is done (the JAX package's early exit)."""
    c = model.cfg
    dev = ids.device
    b, tp = ids.shape
    prompt_lens = prompt_lens.to(dev, torch.int32)
    min_lens = min_lens.to(dev, torch.int32)
    max_lens = max_lens.to(dev, torch.int32)

    cache = q.init_cache(c.qwen, b, cache_len, dtype=torch.bfloat16, device=dev)
    logits = model.decode_logits(model.prefill_leftpad(src, ids, prompt_lens, cache))

    stop_start = c.speech_token_size
    non_stop = torch.arange(c.head_size, device=dev)[None, :] < stop_start
    start_slots = (tp - prompt_lens).to(torch.int32)
    recent = torch.full((b, c.win_size), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    counts = torch.zeros((b,), dtype=torch.int32, device=dev)
    out = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)

    for i in range(max_new_tokens):
        if bool(done.all()):
            break
        logp = torch.log_softmax(logits.float(), dim=-1)
        allowed = non_stop | ~(i < min_lens)[:, None]
        tok = ras_sample(logp, recent, recent >= 0, allowed, generator,
                         top_p=c.top_p, top_k=c.top_k, win_size=c.win_size, tau_r=c.tau_r)
        is_stop = tok >= stop_start
        emit = ~done & ~is_stop & (i < max_lens)
        tok_clean = torch.where(emit, tok, torch.zeros_like(tok))
        counts += emit.to(torch.int32)
        recent = torch.where(emit[:, None], torch.cat([recent[:, 1:], tok_clean[:, None]], dim=1), recent)
        done = done | is_stop | (i + 1 >= max_lens)
        out[:, i] = tok_clean
        positions = (prompt_lens + i)[:, None]
        logits = model.decode_step(tok_clean, positions, start_slots, tp + i + 1, cache)
    return DecodeResult(tokens=out, num_tokens=counts)


class DecodeState(NamedTuple):
    """Resumable decode state of the streaming decode. The step count `i`
    is a host int: every step is known on the host, so it needs no fetch."""

    cache: dict
    logits: torch.Tensor  # (B, V) logits of the NEXT token
    recent: torch.Tensor  # (B, win) RAS window, -1 where empty
    done: torch.Tensor  # (B,) bool
    counts: torch.Tensor  # (B,) emitted tokens
    i: int  # decode steps so far
    prompt_lens: torch.Tensor  # (B,)
    start_slots: torch.Tensor  # (B,)
    min_lens: torch.Tensor
    max_lens: torch.Tensor


@torch.no_grad()
def decode_prefill(model: CosyVoice3LM, src, ids, prompt_lens, min_lens, max_lens, cache_len: int) -> DecodeState:
    """The prompt prefill of a streaming decode; returns its DecodeState."""
    c = model.cfg
    dev = ids.device
    b, tp = ids.shape
    prompt_lens = prompt_lens.to(dev, torch.int32)
    cache = q.init_cache(c.qwen, b, cache_len, dtype=torch.bfloat16, device=dev)
    logits = model.decode_logits(model.prefill_leftpad(src, ids, prompt_lens, cache))
    return DecodeState(
        cache=cache, logits=logits, recent=torch.full((b, c.win_size), -1, dtype=torch.int32, device=dev),
        done=torch.zeros((b,), dtype=torch.bool, device=dev), counts=torch.zeros((b,), dtype=torch.int32, device=dev),
        i=0, prompt_lens=prompt_lens, start_slots=(tp - prompt_lens).to(torch.int32),
        min_lens=min_lens.to(dev, torch.int32), max_lens=max_lens.to(dev, torch.int32),
    )


@torch.no_grad()
def decode_chunk(model: CosyVoice3LM, state: DecodeState, n_steps: int, prompt_pad: int,
                 generator: torch.Generator | None) -> tuple[DecodeState, torch.Tensor]:
    """n_steps more decode steps, each through decode_step (the
    decode-attention kernel on the card), with no device-to-host read: the
    steps run whether or not a row is done, as the JAX package's scan does.
    prompt_pad is the prefill's padded length. Returns (state, chunk
    (B, n_steps) int32, -1 where no token was emitted); the caller fetches
    the chunk with state.done in one copy."""
    c = model.cfg
    b = state.logits.shape[0]
    dev = state.logits.device
    non_stop = torch.arange(c.head_size, device=dev)[None, :] < c.speech_token_size
    logits, recent, done, counts, i = state.logits, state.recent, state.done, state.counts, state.i
    out = torch.empty((b, n_steps), dtype=torch.int32, device=dev)
    for j in range(n_steps):
        logp = torch.log_softmax(logits.float(), dim=-1)
        allowed = non_stop | ~(i < state.min_lens)[:, None]
        tok = ras_sample(logp, recent, recent >= 0, allowed, generator,
                         top_p=c.top_p, top_k=c.top_k, win_size=c.win_size, tau_r=c.tau_r)
        emit = ~done & ~(tok >= c.speech_token_size) & (i < state.max_lens)
        tok_clean = torch.where(emit, tok, torch.zeros_like(tok))
        counts = counts + emit.to(torch.int32)
        recent = torch.where(emit[:, None], torch.cat([recent[:, 1:], tok_clean[:, None]], dim=1), recent)
        done = done | (tok >= c.speech_token_size) | (i + 1 >= state.max_lens)
        out[:, j] = torch.where(emit, tok_clean, torch.full_like(tok_clean, -1))
        logits = model.decode_step(tok_clean, (state.prompt_lens + i)[:, None], state.start_slots, prompt_pad + i + 1,
                                   state.cache)
        i += 1
    return state._replace(logits=logits, recent=recent, done=done, counts=counts, i=i), out
