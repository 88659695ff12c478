"""KV-cached incremental decode of the CosyVoice1 TransformerLM
(fangyan_tts_tpu/models/llm_v1_decode.py: `V1DecodeState`,
`v1_decode_prefill`, `v1_decode_chunk`, `v1_generate_cached`).

The LM stack decodes one token a step over per-layer key / value caches
(L, 1, cache_len, H, dk), written at slot `index`. The relative-position
term of a step is (q + pos_bias_v) . P[i - s] over the cache slots s: the
rows of the espnet table for distances i .. i - cache_len + 1 (one slice of
the (2 * MAX_POS - 1)-row table), projected by each layer's linear_pos.
A chunk of steps runs with no device-to-host read: sampling, stop and
length rules stay on the device, and the caller fetches the chunk's tokens
with the done flag once. The attention is plain PyTorch (an einsum in the
JAX package, no Pallas kernel there), float32 as the v1 family runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.sampling import ras_sample
from .conformer import espnet_rel_pos_table, rel_shift
from .llm_v1 import V1_SAMPLING, TransformerLM
from .qwen2 import flax_dense

MAX_POS = 4096  # rel-pos table half-extent (v1 utterances are far shorter)


@dataclass
class V1DecodeState:
    cache_k: torch.Tensor  # (L, 1, cache_len, H, dk)
    cache_v: torch.Tensor
    index: int  # next write slot == current length
    logits: torch.Tensor  # (1, V) of the NEXT token
    recent: torch.Tensor  # (1, win) RAS window, -1 where empty
    done: torch.Tensor  # (1,) bool
    counts: torch.Tensor  # (1,) emitted tokens
    i: int  # decode steps so far
    min_len: int
    max_len: int


def _layer_qkv(layer, h, t: int, heads: int, dk: int):
    a = layer.self_attn
    q = flax_dense(h, a.linear_q, h.dtype).reshape(1, t, heads, dk)
    k = flax_dense(h, a.linear_k, h.dtype).reshape(1, t, heads, dk)
    v = flax_dense(h, a.linear_v, h.dtype).reshape(1, t, heads, dk)
    return q, k, v


def _layer_tail(layer, x, o):
    """Attention output projection, residual, norm, ReLU FFN, residual."""
    x = x + flax_dense(o, layer.self_attn.linear_out, o.dtype)
    return x + layer.ff(layer.norm_ff(x))


@torch.no_grad()
def v1_decode_prefill(model: TransformerLM, text, text_len, prompt_speech, speech_len, embedding, min_len: int,
                      max_len: int, cache_len: int, win_size: int = 10) -> V1DecodeState:
    """Run [sos, spk, text_enc, task, prompt_speech] through the LM stack once
    (token-causal, right padding masked), keep each layer's K / V, and
    return the resumable state. text (1, Lt_pad), prompt_speech (1, Ls_pad)
    right-padded; text_len, speech_len (1,)."""
    text_enc = model.encode_text(text, text_len)
    lm_input, lm_len = model.build_lm_input(text_enc, text_len, prompt_speech, speech_len, embedding)
    t = lm_input.shape[1]
    d, heads = model.llm_output_size, model.heads
    dk = d // heads
    dev = lm_input.device
    x, pos = model.llm.embed(lm_input)
    qpos = torch.arange(t, device=dev)[None, :, None]
    kpos = torch.arange(t, device=dev)[None, None, :]
    bias = torch.where((kpos <= qpos) & (kpos < lm_len[:, None, None]), 0.0, -1e10).to(torch.float32)
    ks, vs = [], []
    for layer in model.llm.encoders:
        h = layer.norm_mha(x)
        q, k, v = _layer_qkv(layer, h, t, heads, dk)
        a = layer.self_attn
        p = flax_dense(pos[0], a.linear_pos, x.dtype).reshape(-1, heads, dk)
        ac = torch.einsum("bthd,bshd->bhts", q + a.pos_bias_u, k)
        bd = rel_shift(torch.einsum("bthd,shd->bhts", q + a.pos_bias_v, p))
        scores = ((ac + bd) / math.sqrt(dk)).float() + bias[:, None]
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o = torch.einsum("bhts,bshd->bthd", probs, v).reshape(1, t, d)
        x = _layer_tail(layer, x, o)
        ks.append(k)
        vs.append(v)
    x = model.llm.after_norm(x)
    logits_all = flax_dense(x, model.llm_decoder)
    last = logits_all[:, int(lm_len[0]) - 1]

    n_layers = len(ks)
    cache_k = torch.zeros((n_layers, 1, cache_len, heads, dk), dtype=x.dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    cache_k[:, :, :t] = torch.stack(ks)
    cache_v[:, :, :t] = torch.stack(vs)
    return V1DecodeState(
        cache_k=cache_k, cache_v=cache_v, index=int(lm_len[0]), logits=last,
        recent=torch.full((1, win_size), -1, dtype=torch.int32, device=dev),
        done=torch.zeros((1,), dtype=torch.bool, device=dev), counts=torch.zeros((1,), dtype=torch.int32, device=dev),
        i=0, min_len=min_len, max_len=max_len)


def _pos_table(model: TransformerLM, device, dtype) -> torch.Tensor:
    """The (2 * MAX_POS - 1, d) rel-pos table on the device, made once per
    model, device and dtype."""
    cache = model.__dict__.setdefault("_v1_pos_table", {})
    key = (str(device), dtype)
    if key not in cache:
        cache[key] = torch.from_numpy(espnet_rel_pos_table(MAX_POS, model.llm_output_size)[0]).to(device, dtype)
    return cache[key]


@torch.no_grad()
def v1_decode_chunk(model: TransformerLM, state: V1DecodeState, n_steps: int,
                    generator: torch.Generator | None) -> tuple[V1DecodeState, torch.Tensor]:
    """n_steps more steps (they run whether or not the stream is done, as
    the JAX package's scan does). Returns (state, chunk (1, n_steps) int32,
    -1 where no token was emitted); the caches are updated in place."""
    sp = V1_SAMPLING
    d, heads = model.llm_output_size, model.heads
    dk = d // heads
    eos = model.speech_token_size
    cache_len = state.cache_k.shape[2]
    dev = state.logits.device
    table = _pos_table(model, dev, torch.float32)
    slot = torch.arange(cache_len, device=dev)
    ids = torch.arange(eos + 1, device=dev)
    logits, recent, done, counts = state.logits, state.recent, state.done, state.counts
    out = torch.empty((1, n_steps), dtype=torch.int32, device=dev)
    for j in range(n_steps):
        i = state.i + j
        logp = torch.log_softmax(logits.float(), dim=-1)
        allowed = (ids < (eos if i < state.min_len else eos + 1))[None]
        tok = ras_sample(logp, recent, recent >= 0, allowed, generator, **sp)
        emit = ~done & (tok != eos) & (i < state.max_len)
        tok_clean = torch.where(emit, tok, torch.zeros_like(tok))
        recent = torch.where(emit[:, None], torch.cat([recent[:, 1:], tok_clean[:, None]], dim=1), recent)
        done = done | (tok == eos) | (i + 1 >= state.max_len)
        counts = counts + emit.to(torch.int32)
        out[:, j] = torch.where(emit, tok_clean, torch.full_like(tok_clean, -1))

        # the step's input re-enters through the legacy embed, as the prompt's did
        # steps past the end of a stream (done, the chunk runs on) write the last
        # slot and read clamped rows, as the JAX package's dynamic slices clamp
        idx = state.index + j
        w = min(idx, cache_len - 1)
        x, _ = model.llm.embed(model.speech_embedding(tok_clean.long())[:, None, :].to(state.cache_k.dtype))
        kbias = torch.where(slot <= idx, 0.0, -1e10).to(torch.float32)
        start = min(max(MAX_POS - 1 - idx, 0), table.shape[0] - cache_len)
        rows = table[start: start + cache_len]
        for li, layer in enumerate(model.llm.encoders):
            h = layer.norm_mha(x)
            q, k, v = _layer_qkv(layer, h, 1, heads, dk)
            state.cache_k[li, :, w] = k[:, 0].to(state.cache_k.dtype)
            state.cache_v[li, :, w] = v[:, 0].to(state.cache_v.dtype)
            a = layer.self_attn
            p = flax_dense(rows.to(x.dtype), a.linear_pos, x.dtype).reshape(cache_len, heads, dk)
            ac = torch.einsum("hd,shd->hs", (q + a.pos_bias_u)[0, 0], state.cache_k[li, 0])
            bd = torch.einsum("hd,shd->hs", (q + a.pos_bias_v)[0, 0], p)
            probs = torch.softmax(((ac + bd) / math.sqrt(dk)).float() + kbias, dim=-1).to(x.dtype)
            o = torch.einsum("hs,shd->hd", probs, state.cache_v[li, 0]).reshape(1, 1, d)
            x = _layer_tail(layer, x, o)
        logits = flax_dense(model.llm.after_norm(x)[:, 0], model.llm_decoder)
    state.logits, state.recent, state.done, state.counts = logits, recent, done, counts
    state.index += n_steps
    state.i += n_steps
    return state, out


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


@torch.no_grad()
def v1_generate_cached(model: TransformerLM, text_tokens: np.ndarray, embedding: np.ndarray,
                       prompt_speech: np.ndarray = np.zeros(0, np.int32), generator: torch.Generator | None = None,
                       min_token_text_ratio: float = 2.0, max_token_text_ratio: float = 20.0, chunk_steps: int = 32,
                       prompt_text_len: int = 0):
    """The KV-cached v1 decode: yields an int32 array of the newly emitted
    speech tokens per chunk of steps. min / max lengths count the new text
    only. The text is padded to a multiple of 16, the prompt speech too,
    and the cache to a multiple of 128 that holds both the prefill and
    prompt + max_len."""
    dev = model.llm_decoder.weight.device
    lt = len(text_tokens)
    new_text = lt - prompt_text_len
    min_len, max_len = int(new_text * min_token_text_ratio), int(new_text * max_token_text_ratio)
    lt_pad = _round_up(max(lt, 1), 16)
    ls = len(prompt_speech)
    ls_pad = _round_up(max(ls, 1), 16)
    text = np.zeros((1, lt_pad), np.int32)
    text[0, :lt] = text_tokens
    speech = np.zeros((1, ls_pad), np.int32)
    speech[0, :ls] = prompt_speech
    cache_len = _round_up(max(3 + lt + ls + max(max_len, 1), 3 + lt_pad + ls_pad), 128)
    if cache_len > MAX_POS:
        raise ValueError(f"v1 decode would reach position {cache_len} > the rel-pos table's {MAX_POS} (split the input)")
    state = v1_decode_prefill(
        model, torch.from_numpy(text).to(dev), torch.tensor([lt], dtype=torch.int32, device=dev),
        torch.from_numpy(speech).to(dev), torch.tensor([ls], dtype=torch.int32, device=dev),
        torch.as_tensor(np.asarray(embedding, np.float32), device=dev).reshape(1, -1), min_len, max_len, cache_len,
        win_size=V1_SAMPLING["win_size"])
    done, emitted_total = False, 0
    while not done and emitted_total < max_len:
        state, chunk = v1_decode_chunk(model, state, chunk_steps, generator)
        packed = torch.cat([chunk[0], state.done.to(torch.int32), state.counts]).cpu().numpy()
        toks, done, emitted_total = packed[:-2], bool(packed[-2]), int(packed[-1])
        toks = toks[toks >= 0]
        if len(toks):
            yield toks.astype(np.int32)
