"""Host-side construction of LM training sequences ("plans").

Behavioral reference: Qwen2LM.prepare_lm_input_target (llm.py:304-351) and
CosyVoice3LM.forward (llm.py:670-711). The reference interleaves *embedding*
tensors; here we build integer plans — (src, ids, targets) arrays — and let
the device do two gathers + a select (models/llm.py:embed_plan). Semantics
are identical:

- unistream: [sos, instruct, text, task, speech] with targets
  IGNORE*(1+instr+text) + speech + [eos]
- bistream (coin flip, only when speech/text ratio > mix_ratio[1]/[0]):
  text/speech interleaved 5:15 with `fill` separators; the last partial text
  chunk flushes through [task] + remaining speech + [eos].

src: 0 = text-token (Qwen embed_tokens), 1 = speech/special
(speech_embedding). sos/task/eos/fill ids live in the speech table
(llm.py:645-648).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..config import LLMConfig

IGNORE_ID = -1
TEXT, SPEECH = 0, 1


@dataclass
class Plan:
    src: np.ndarray  # (L,) int32
    ids: np.ndarray  # (L,) int32
    targets: np.ndarray  # (L,) int32


def build_plan(
    cfg: LLMConfig,
    text: Sequence[int],
    speech: Sequence[int],
    instruct: Sequence[int] = (),
    bistream: bool = False,
) -> Plan:
    text = list(text)
    speech = list(speech)
    instruct = list(instruct)
    mt, ms = cfg.mix_ratio

    src: list[int] = [SPEECH]
    ids: list[int] = [cfg.sos]
    tgt: list[int] = [IGNORE_ID]

    src += [TEXT] * len(instruct)
    ids += instruct
    tgt += [IGNORE_ID] * len(instruct)

    can_bistream = len(text) > 0 and len(speech) / max(len(text), 1) > ms / mt
    if bistream and can_bistream:
        n_chunks = math.ceil((len(text) + 1) / mt)
        for j in range(n_chunks):
            t_chunk = text[j * mt : (j + 1) * mt]
            s_chunk = speech[j * ms : (j + 1) * ms]
            if len(t_chunk) == mt:
                assert len(s_chunk) == ms, "bistream requires full speech chunk per full text chunk"
                src += [TEXT] * mt + [SPEECH] * ms
                ids += t_chunk + s_chunk
                tgt += [IGNORE_ID] * (mt - 1) + s_chunk + [cfg.fill]
            else:
                rest_s = speech[j * ms :]
                src += [TEXT] * len(t_chunk) + [SPEECH] + [SPEECH] * len(rest_s)
                ids += t_chunk + [cfg.task_id] + rest_s
                tgt += [IGNORE_ID] * len(t_chunk) + rest_s + [cfg.eos]
    else:
        src += [TEXT] * len(text) + [SPEECH] + [SPEECH] * len(speech)
        ids += text + [cfg.task_id] + speech
        tgt += [IGNORE_ID] * len(text) + speech + [cfg.eos]

    return Plan(
        src=np.asarray(src, np.int32),
        ids=np.asarray(ids, np.int32),
        targets=np.asarray(tgt, np.int32),
    )


def build_prompt_plan(
    cfg: LLMConfig,
    text: Sequence[int],
    prompt_speech: Sequence[int] = (),
) -> Plan:
    """Inference prompt: [sos, text(incl. any prompt text+instruct already
    tokenized in), task, prompt_speech] (llm.py:728-740). Targets unused."""
    text = list(text)
    prompt_speech = list(prompt_speech)
    src = [SPEECH] + [TEXT] * len(text) + [SPEECH] + [SPEECH] * len(prompt_speech)
    ids = [cfg.sos] + text + [cfg.task_id] + prompt_speech
    return Plan(
        src=np.asarray(src, np.int32),
        ids=np.asarray(ids, np.int32),
        targets=np.full((len(ids),), IGNORE_ID, np.int32),
    )


def pad_plans_right(plans: Sequence[Plan], length: int | None = None) -> dict:
    """Right-pad to a common (bucketed) length for training."""
    maxlen = max(len(p.ids) for p in plans)
    length = length or maxlen
    assert length >= maxlen
    b = len(plans)
    src = np.zeros((b, length), np.int32)
    ids = np.zeros((b, length), np.int32)
    tgt = np.full((b, length), IGNORE_ID, np.int32)
    lens = np.zeros((b,), np.int32)
    for i, p in enumerate(plans):
        n = len(p.ids)
        src[i, :n] = p.src
        ids[i, :n] = p.ids
        tgt[i, :n] = p.targets
        lens[i] = n
    return {"src": src, "ids": ids, "targets": tgt, "lengths": lens}


def pad_plans_left(plans: Sequence[Plan], length: int | None = None) -> dict:
    """Left-pad prompts for batched AR decode (models/llm.py decode path)."""
    maxlen = max(len(p.ids) for p in plans)
    length = length or maxlen
    assert length >= maxlen
    b = len(plans)
    src = np.zeros((b, length), np.int32)
    ids = np.zeros((b, length), np.int32)
    lens = np.zeros((b,), np.int32)
    for i, p in enumerate(plans):
        n = len(p.ids)
        src[i, length - n :] = p.src
        ids[i, length - n :] = p.ids
        lens[i] = n
    return {"src": src, "ids": ids, "lengths": lens}


SPECIAL = 2  # src==2 selects the 2-row llm_embedding table (v2, llm.py:283)


def remap_plan_v2(cfg: LLMConfig, plan: Plan) -> Plan:
    """Remap a v3-layout plan to the CosyVoice2 id layout (llm.py:277-294):
    sos/task move from the speech table to the 2-row llm_embedding (src=2,
    ids 0/1); target ids shift to eos = speech_token_size + 0 and
    fill = speech_token_size + 2 (v3 uses +1/+3)."""
    src = plan.src.copy()
    ids = plan.ids.copy()
    tgt = plan.targets.copy()
    is_sos = (src == SPEECH) & (ids == cfg.sos)
    is_task = (src == SPEECH) & (ids == cfg.task_id)
    src[is_sos | is_task] = SPECIAL
    ids[is_sos] = 0
    ids[is_task] = 1
    tgt[tgt == cfg.eos] = cfg.speech_token_size  # v2 eos
    tgt[tgt == cfg.fill] = cfg.speech_token_size + 2  # v2 fill
    return Plan(src=src, ids=ids, targets=tgt)
