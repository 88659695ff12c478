"""Shared constants and helpers (the port's copy of
fangyan_tts_tpu/utils/common.py, itself after cosyvoice/utils/common.py).

- `INSTRUCT_LIST`: the 26 CosyVoice3 dialect / emotion / style instruct
  presets, used by data prep and the evaluation sweeps.
- `fade_in_out`: the Hamming-window crossfade of the CosyVoice1/2 streaming
  chunk joins.
- `set_all_random_seed`: process-wide seeding (python, numpy and torch, with
  every CUDA device when there is one).
"""

from __future__ import annotations

import random

import numpy as np
import torch

INSTRUCT_LIST = [
    "You are a helpful assistant. 请用广东话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用东北话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用甘肃话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用贵州话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用河南话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用湖北话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用湖南话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用江西话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用闽南话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用宁夏话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用山西话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用陕西话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用山东话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用上海话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用四川话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用天津话表达。<|endofprompt|>",
    "You are a helpful assistant. 请用云南话表达。<|endofprompt|>",
    "You are a helpful assistant. Please say a sentence as loudly as possible.<|endofprompt|>",
    "You are a helpful assistant. Please say a sentence in a very soft voice.<|endofprompt|>",
    "You are a helpful assistant. 请用尽可能慢地语速说一句话。<|endofprompt|>",
    "You are a helpful assistant. 请用尽可能快地语速说一句话。<|endofprompt|>",
    "You are a helpful assistant. 请非常开心地说一句话。<|endofprompt|>",
    "You are a helpful assistant. 请非常伤心地说一句话。<|endofprompt|>",
    "You are a helpful assistant. 请非常生气地说一句话。<|endofprompt|>",
    "You are a helpful assistant. 我想体验一下小猪佩奇风格，可以吗？<|endofprompt|>",
    "You are a helpful assistant. 你可以尝试用机器人的方式解答吗？<|endofprompt|>",
]


def fade_in_out(fade_in: np.ndarray, fade_out: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Crossfade the head of `fade_in` with the tail of `fade_out` using the
    two halves of a (2N,) Hamming window, on the last axis."""
    n = window.shape[0] // 2
    out = np.array(fade_in, copy=True)
    out[..., :n] = fade_in[..., :n] * window[:n] + fade_out[..., -n:] * window[n:]
    return out


def set_all_random_seed(seed: int) -> None:
    """Seed python's `random`, numpy and torch (the CPU generator and, where
    CUDA is present, every device's)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)
