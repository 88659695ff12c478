"""CosyVoice2's streaming token2wav, worked out again from the served tokens
with the float32 references: hops of 25 tokens (the first one also
absorbing the prompt's padding to a hop boundary) with 3 lookahead tokens,
each re-solving the flow over the whole prefix under the chunk-causal mask
and keeping the hop's frames; the vocoder on the hop's mel after the last 8
mel frames of the previous one, its first source samples the previous
one's last, the noise read at the chunk's absolute sample offset, and the
speech of each join cross-faded over a Hamming window; the last call solves
the whole prefix with full attention and no lookahead.
"""

from __future__ import annotations

import numpy as np

from .hift import HiFT, total_upsample
from .v2_flow import FlowV2

HOP, MEL_CACHE = 25, 8


def stream_audio(flow: FlowV2, hift: HiFT, prompt_tokens, prompt_feat, embedding, tokens) -> np.ndarray:
    """The concatenated audio a stream of `tokens` yields, chunk after chunk."""
    f = flow.f
    la, r = f["pre_lookahead_len"], f["token_mel_ratio"]
    up = total_upsample(hift.h)
    n_src = MEL_CACHE * up
    window = np.hamming(2 * n_src)
    p = len(prompt_tokens)
    pad = -p % HOP
    mel1 = np.asarray(prompt_feat).shape[0]
    tokens = np.asarray(tokens, np.int64)
    cache, base, offset, out = None, 0, 0, []

    def hop_mel(toks, streaming: bool, finalize: bool) -> np.ndarray:
        mel = flow.mel(np.concatenate([prompt_tokens, toks]), prompt_feat, embedding, streaming, finalize)
        return mel[mel1 + offset * r:].cpu().numpy()

    def fade(audio: np.ndarray, prev: np.ndarray) -> np.ndarray:
        audio = audio.copy()
        audio[:n_src] = audio[:n_src] * window[:n_src] + prev[-n_src:] * window[n_src:]
        return audio

    while True:
        this_hop = HOP + pad if offset == 0 else HOP
        if len(tokens) - offset < this_hop + la:
            break
        mel = hop_mel(tokens[: offset + this_hop + la], True, False)
        src = np.zeros((0, 1), np.float32)
        if cache is not None:
            mel, src = np.concatenate([cache["mel"], mel]), cache["source"]
        audio, source = hift.audio(mel, src, base * up)
        audio, source = audio.cpu().numpy(), source.cpu().numpy()
        if cache is not None:
            audio = fade(audio, cache["speech"])
        cache = {"mel": mel[-MEL_CACHE:], "source": source[-n_src:], "speech": audio[-n_src:]}
        base += mel.shape[0] - MEL_CACHE
        out.append(audio[:-n_src])
        offset += this_hop
    mel = hop_mel(tokens, False, True)
    src = np.zeros((0, 1), np.float32)
    if cache is not None:
        mel, src = np.concatenate([cache["mel"], mel]), cache["source"]
    n = mel.shape[0]
    padded = np.pad(mel, ((0, -n % 32), (0, 0)))  # the last call pads its mel to 32 frames
    audio = hift.audio(padded, src, base * up)[0].cpu().numpy()[: n * up]
    if cache is not None:
        audio = fade(audio, cache["speech"])
    out.append(audio)
    return np.concatenate(out)
