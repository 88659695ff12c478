"""Shared helpers of the CosyVoice1/2 runtimes (the port's copy of
fangyan_tts_tpu/utils/common.py `fade_in_out`)."""

from __future__ import annotations

import numpy as np


def fade_in_out(fade_in: np.ndarray, fade_out: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Crossfade the head of `fade_in` with the tail of `fade_out` using the
    two halves of a (2N,) Hamming window, on the last axis."""
    n = window.shape[0] // 2
    out = np.array(fade_in, copy=True)
    out[..., :n] = fade_in[..., :n] * window[:n] + fade_out[..., -n:] * window[n:]
    return out
