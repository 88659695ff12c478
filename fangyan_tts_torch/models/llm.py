"""CosyVoice3 AR speech-token LM on the Qwen2 backbone
(fangyan_tts_tpu/models/llm.py: CosyVoice3LM with its training forward and
`label_smoothed_ce`, its CosyVoice2 variant Qwen2LMV2, generate_speech_tokens,
the resumable streaming decode `decode_prefill` / `decode_chunk`, the
bistream context extension `bistream_append`, and the continuous batch
`ContState` with `decode_chunk_cont`).

Prompts are left-padded so every row's valid cache slots are contiguous and
the decode write slot is the same for all rows, except in the continuous
batch, where each row has its own write slot, step count and attention
window, and its own generator. The JAX package decodes in
one `lax.while_loop`; here the loop is a Python loop whose early exit reads
`done.all()` once per step (one device-to-host synchronisation a step).
Sampling draws from an explicit `torch.Generator`. The decode functions run
under torch.no_grad(); `CosyVoice3LM.forward` is the cache-free training
pass on right-padded plans.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from ..config import LLMConfig
from ..ops.sampling import ras_sample
from . import qwen2 as q

IGNORE_ID = -1


class CosyVoice3LM(nn.Module):
    def __init__(self, cfg: LLMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype  # compute dtype of the training forward and the prompt prefill
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

    def forward(self, src, ids, lengths, targets) -> tuple[torch.Tensor, torch.Tensor]:
        """Training forward on right-padded plans (B, L) (data/lm_plan
        pad_plans_right): the cache-free Qwen2 pass under a causal + padding
        bias, then label-smoothed CE over the targets that are not
        IGNORE_ID. Returns (loss, acc), float32 scalars."""
        c = self.cfg
        x = self.embed_plan(src, ids)
        b, t, _ = x.shape
        positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
        h = self.llm(x, positions, q.prefill_attn_bias(t, lengths))
        return label_smoothed_ce(self.decode_logits(h), targets, c.lsm_weight, c.length_normalized_loss)

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

    def decode_step(self, token, positions, start, end: int | torch.Tensor, cache: dict) -> torch.Tensor:
        """One AR step for every row. token (B,); positions (B, 1); start (B,)
        first valid slot; end: exclusive slot bound, an int or (B,) per row.
        Runs in the cache's dtype. Returns logits (B, V)."""
        emb = self.speech_embedding(token)[:, None, :]
        max_len = cache["k"].shape[2]
        slot = torch.arange(max_len, dtype=torch.int32, device=token.device)[None, None, :]
        if isinstance(end, torch.Tensor):
            end = end[:, None, None]
        bias = torch.where((slot >= start[:, None, None]) & (slot < end), 0.0, -1e10).to(torch.float32)
        h = self.llm(emb.to(cache["k"].dtype), positions, bias, cache)
        return self.decode_logits(h[:, 0])


class Qwen2LMV2(CosyVoice3LM):
    """The CosyVoice2 speech LM: CosyVoice3LM but for the special-id layout.
    sos (0) and task (1) live in a separate 2-row `llm_embedding` table,
    selected by plan src == 2 (data/lm_plan.remap_plan_v2); the head has
    speech_token_size + 3 rows and a bias; the stop ids are size + {0, 1, 2}
    (every id from speech_token_size on, as in CosyVoice3LM's decode)."""

    def __init__(self, cfg: LLMConfig, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dtype)
        self.llm_embedding = nn.Embedding(2, cfg.llm_input_size)
        self.llm_decoder = nn.Linear(cfg.llm_output_size, cfg.head_size, bias=True)

    def embed_plan(self, src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        text_e = self.embed_tokens(ids.clamp(0, self.cfg.qwen.vocab_size - 1))
        speech_e = self.speech_embedding(ids.clamp(0, self.cfg.head_size - 1))
        special_e = self.llm_embedding(ids.clamp(0, 1))
        out = torch.where((src == 1)[..., None], speech_e, text_e)
        return torch.where((src == 2)[..., None], special_e, out).to(self.dtype)


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


def label_smoothed_ce(logits: torch.Tensor, targets: torch.Tensor, smoothing: float,
                      normalize_length: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Label-smoothed NLL summed over the targets that are not IGNORE_ID, a
    float32 log-softmax, divided by their count (normalize_length) or by the
    batch size. Returns (loss, acc), acc the argmax hits over those targets."""
    v = logits.shape[-1]
    mask = targets != IGNORE_ID
    tgt = torch.where(mask, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, tgt[..., None])[..., 0]
    nll = -(1.0 - smoothing) * picked
    if smoothing > 0.0:
        nll = nll - smoothing / (v - 1) * (logp.sum(dim=-1) - picked)
    nll = torch.where(mask, nll, 0.0)
    n_valid = mask.sum().clamp(min=1)
    loss = nll.sum() / (n_valid if normalize_length else logits.shape[0])
    acc = ((logits.argmax(dim=-1) == targets) & mask).sum() / n_valid
    return loss, acc


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
    logits, recent, done, counts, i = state.logits, state.recent, state.done, state.counts, state.i
    out = torch.empty((logits.shape[0], n_steps), dtype=torch.int32, device=logits.device)
    for j in range(n_steps):
        tok, out[:, j], recent, done, counts = _sample_step(model.cfg, state, logits, recent, done, counts, i,
                                                            generator)
        logits = model.decode_step(tok, (state.prompt_lens + i)[:, None], state.start_slots, prompt_pad + i + 1,
                                   state.cache)
        i += 1
    return state._replace(logits=logits, recent=recent, done=done, counts=counts, i=i), out


def _sample_step(c: LLMConfig, state, logits, recent, done, counts, i, generator):
    """One sampling step of the streaming decodes (decode_chunk with a host
    step count i, decode_chunk_cont with a (B,) one): RAS sampling, stop ids
    suppressed while i < min_len, stop on a stop id or at max_len. Returns
    (the token fed back, 0 where none was emitted; the chunk's entry, -1
    there; recent; done; counts)."""
    non_stop = torch.arange(c.head_size, device=logits.device)[None, :] < c.speech_token_size
    logp = torch.log_softmax(logits.float(), dim=-1)
    allowed = non_stop | ~(i < state.min_lens)[:, None]
    tok = ras_sample(logp, recent, recent >= 0, allowed, generator,
                     top_p=c.top_p, top_k=c.top_k, win_size=c.win_size, tau_r=c.tau_r)
    emit = ~done & ~(tok >= c.speech_token_size) & (i < state.max_lens)
    tok_clean = torch.where(emit, tok, torch.zeros_like(tok))
    counts = counts + emit.to(torch.int32)
    recent = torch.where(emit[:, None], torch.cat([recent[:, 1:], tok_clean[:, None]], dim=1), recent)
    done = done | (tok >= c.speech_token_size) | (i + 1 >= state.max_lens)
    return tok_clean, torch.where(emit, tok_clean, torch.full_like(tok_clean, -1)), recent, done, counts


class ContState(NamedTuple):
    """Continuous-batching decode state: N rows at independent depths
    (fangyan_tts_tpu/models/llm.py ContState). Each row has its own step
    count, write slot (cache['index']), attention window and generator, so
    sessions join and leave between chunks without touching each other, and
    a row's tokens equal a solo decode_chunk run with the same generator.
    Free and finished rows are done and step masked; a free row's write
    slot runs on past the cache and the kernel clamps it to S-1. The tensors
    are updated in place (an insert is an index_copy_ along the row axis)."""

    cache: dict  # {'k', 'v': (L, N, S, KV, hd), 'index': (N,)}
    logits: torch.Tensor  # (N, V)
    recent: torch.Tensor  # (N, win)
    done: torch.Tensor  # (N,) bool; True for free and finished rows
    counts: torch.Tensor  # (N,)
    i: torch.Tensor  # (N,) int32 decode steps of each row
    generators: list  # N torch.Generators; free rows share a spare one
    prompt_lens: torch.Tensor  # (N,)
    start_slots: torch.Tensor  # (N,)
    min_lens: torch.Tensor
    max_lens: torch.Tensor


def cont_empty(example: DecodeState, n: int) -> ContState:
    """An all-done width-n ContState shaped after a DecodeState of the same
    (tp, cache_len) bucket."""
    s = example
    dev = s.logits.device

    def zeros(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        shape = list(x.shape)
        shape[axis] = n
        return torch.zeros(shape, dtype=x.dtype, device=dev)

    z = lambda: torch.zeros((n,), dtype=torch.int32, device=dev)
    spare = torch.Generator(device=dev).manual_seed(0)
    return ContState(
        cache={"k": zeros(s.cache["k"], 1), "v": zeros(s.cache["v"], 1), "index": z()},
        logits=zeros(s.logits), recent=torch.full((n, s.recent.shape[1]), -1, dtype=torch.int32, device=dev),
        done=torch.ones((n,), dtype=torch.bool, device=dev), counts=z(), i=z(), generators=[spare] * n,
        prompt_lens=z(), start_slots=z(), min_lens=z(), max_lens=z(),
    )


def _insert(big: ContState, small: DecodeState, src_rows: list, dst_rows: list, generators: list) -> ContState:
    """Rows src_rows of `small` into rows dst_rows of `big`, in place."""
    if not dst_rows:
        return big
    dev = big.logits.device
    src = torch.tensor(src_rows, dtype=torch.long, device=dev)
    dst = torch.tensor(dst_rows, dtype=torch.long, device=dev)

    def put(b: torch.Tensor, x: torch.Tensor, axis: int = 0) -> None:
        b.index_copy_(axis, dst, x.index_select(axis, src).to(b.dtype))

    put(big.cache["k"], small.cache["k"], 1)
    put(big.cache["v"], small.cache["v"], 1)
    # same tp bucket: the prefill's write index is every row's
    for b, x in ((big.cache["index"], small.cache["index"]), (big.logits, small.logits), (big.recent, small.recent),
                 (big.prompt_lens, small.prompt_lens), (big.start_slots, small.start_slots),
                 (big.min_lens, small.min_lens), (big.max_lens, small.max_lens)):
        put(b, x)
    big.done.index_fill_(0, dst, False)
    big.counts.index_fill_(0, dst, 0)
    big.i.index_fill_(0, dst, 0)
    for d, g in zip(dst_rows, generators):
        big.generators[d] = g
    return big


def cont_insert(big: ContState, small: DecodeState, slot: int, generator: torch.Generator) -> ContState:
    """Insert a one-row prefilled DecodeState into row `slot`."""
    return _insert(big, small, [0], [slot], [generator])


def cont_insert_rows(big: ContState, small: DecodeState, slots: list, generators: list) -> ContState:
    """Insert every row of a batched prefill: small row j into row slots[j],
    with generators[j] (decode_prefill's state has no generator of its own)."""
    return _insert(big, small, list(range(len(slots))), list(slots), list(generators))


def cont_insert_rows_masked(big: ContState, small: DecodeState, slots: list, generators: list) -> ContState:
    """The serving front's insert: `small` is a prefill at the full group
    width whose first k rows are real; slots[j] is the row small row j goes
    to, or -1 for a padding row, which is dropped."""
    src = [j for j, s in enumerate(slots) if s >= 0]
    return _insert(big, small, src, [slots[j] for j in src], [generators[j] for j in src])


@torch.no_grad()
def decode_chunk_cont(model: CosyVoice3LM, state: ContState, n_steps: int,
                      prompt_pad: int) -> tuple[ContState, torch.Tensor]:
    """n_steps more decode steps of every row (done and free rows step
    masked, and every step launches the decode-attention kernel for all
    rows), with no device-to-host read. Each row samples from its own
    generator, attends over its own window [start_slot, prompt_pad + i + 1)
    and writes at its own slot, so a row's tokens equal decode_chunk's at
    B = 1 with that generator. Returns (state, chunk (N, n_steps) int32, -1
    where no token was emitted)."""
    logits, recent, done, counts, i = state.logits, state.recent, state.done, state.counts, state.i
    out = torch.empty((logits.shape[0], n_steps), dtype=torch.int32, device=logits.device)
    for j in range(n_steps):
        tok, out[:, j], recent, done, counts = _sample_step(model.cfg, state, logits, recent, done, counts, i,
                                                            state.generators)
        logits = model.decode_step(tok, (state.prompt_lens + i)[:, None], state.start_slots, prompt_pad + i + 1,
                                   state.cache)
        i = i + 1
    return state._replace(logits=logits, recent=recent, done=done, counts=counts, i=i), out
