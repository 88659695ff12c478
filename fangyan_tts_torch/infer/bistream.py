"""Bistream inference: speech tokens decoded while the text still arrives
(fangyan_tts_tpu/infer/bistream.py), in the CosyVoice3 id layout or, for a
Qwen2LMV2, the CosyVoice2 one (sos / task in the 2-row llm_embedding table
as src 2, ids 0 / 1; fill = speech_token_size + 2).

The 5:15 text / speech interleave: the context starts as [sos] and the
prompt text seeds the text buffer; while prompt speech remains, every 5
buffered text tokens go in with 15 prompt speech tokens; then decoding
emits speech tokens until a `fill` token (forced every 15 emitted, or
sampled) hands control back to wait for 5 more text tokens; when the text
ends, the rest of it and the task id go in and decoding runs to a stop id.
The context grows through exact-length `bistream_append` calls, and each
emitted token is a one-token append (a decode step).
"""

from __future__ import annotations

from typing import Generator, Iterable

import numpy as np
import torch

from ..models.llm import CosyVoice3LM, Qwen2LMV2, bistream_append
from ..ops.sampling import ras_sample


@torch.inference_mode()
def inference_bistream(
    model: CosyVoice3LM,
    text_iter: Iterable[np.ndarray],  # chunks of text token ids
    prompt_text: np.ndarray,
    prompt_speech: np.ndarray,
    generator: torch.Generator | None = None,
    cache_len: int = 2048,
    max_tokens: int = 1500,
) -> Generator[int, None, None]:
    c = model.cfg
    mt, ms = c.mix_ratio  # 5, 15
    dev = model.speech_embedding.weight.device
    state: dict = {"cache": None, "seq_pos": 0, "logits": None}
    v2 = isinstance(model, Qwen2LMV2)
    sos_seg = ([2], [0]) if v2 else ([1], [c.sos])
    task_seg = ([2], [1]) if v2 else ([1], [c.task_id])
    fill_id = c.speech_token_size + 2 if v2 else c.fill

    def append(src_vals, id_vals):
        src = torch.tensor([src_vals], dtype=torch.int32, device=dev)
        ids = torch.tensor([id_vals], dtype=torch.int32, device=dev)
        state["cache"], state["logits"], state["seq_pos"] = bistream_append(
            model, state["cache"], state["seq_pos"], src, ids, cache_len)

    append(*sos_seg)
    text_cache: list[int] = np.asarray(prompt_text, np.int32).tolist()
    speech_cache: list[int] = np.asarray(prompt_speech, np.int32).tolist()
    next_fill_index = (len(speech_cache) // ms + 1) * ms - len(speech_cache)
    out_tokens: list[int] = []
    recent = np.full(c.win_size, -1, np.int32)
    non_stop = torch.arange(c.head_size, device=dev) < c.speech_token_size
    all_ids = torch.ones(c.head_size, dtype=torch.bool, device=dev)

    def sample_one(allowed: torch.Tensor) -> int:
        logp = torch.log_softmax(state["logits"].float(), dim=-1)
        rec = torch.from_numpy(recent[None]).to(dev)
        tok = ras_sample(logp, rec, rec >= 0, allowed[None], generator,
                         top_p=c.top_p, top_k=c.top_k, win_size=c.win_size, tau_r=c.tau_r)
        return int(tok[0])

    def push_recent(tok: int) -> None:
        recent[:-1] = recent[1:]
        recent[-1] = tok

    appended_any = False
    for chunk in text_iter:
        text_cache.extend(np.asarray(chunk, np.int32).tolist())
        # buffered text paired with prompt speech
        while speech_cache and len(text_cache) >= mt:
            t5, text_cache = text_cache[:mt], text_cache[mt:]
            s15, speech_cache = speech_cache[:ms], speech_cache[ms:]
            append([0] * len(t5) + [1] * len(s15), t5 + s15)
            appended_any = True
        if speech_cache:
            continue
        # a text block after a fill, or at the start of the stream
        if (out_tokens and out_tokens[-1] == fill_id) or (not out_tokens and not appended_any):
            if len(text_cache) >= mt:
                t5, text_cache = text_cache[:mt], text_cache[mt:]
                append([0] * mt, t5)
                appended_any = True
            else:
                continue
        # decode up to the next fill
        while len(out_tokens) < max_tokens:
            if next_fill_index != -1 and len(out_tokens) == next_fill_index:
                tok = fill_id
                next_fill_index += ms + 1
            else:
                tok = sample_one(non_stop)
            out_tokens.append(tok)
            if tok == fill_id:
                # never fed to the model: the next text block takes its place
                break
            yield tok
            push_recent(tok)
            append([1], [tok])

    # the rest of the text and the task id, then decode to a stop id
    for t in text_cache:
        append([0], [t])
    append(*task_seg)
    while len(out_tokens) < max_tokens:
        tok = sample_one(all_ids)
        out_tokens.append(tok)
        if tok >= c.speech_token_size:
            break
        yield tok
        push_recent(tok)
        append([1], [tok])
