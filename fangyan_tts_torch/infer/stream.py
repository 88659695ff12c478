"""Constant-cost streaming: the windowed flow and the windowed vocoder
(fangyan_tts_tpu/infer/stream.py: VocStream, FlowStream, Token2WavSession).

- FlowStream: the young hops (target prefix below `stream_window_tokens`)
  run KV-cached (models/flow.cfm_solve_chunk: each hop solves only its own
  frames against per-Euler-step K/V caches, equal to the full-prefix
  re-solve), or, with `flow_kv_stream = False`, the full-prefix solve
  itself. Past the window the flow runs on [prompt ++ the last W target
  tokens ++ lookahead] under the chunk mask, with the fixed CFM noise taken
  at absolute mel positions, so every frame keeps its noise row: the cost
  of a hop stays that of the window.
- VocStream: a device-resident mel tail of 3H + 8 frames and the NSF phase
  carry. Every hop pushes H = 50 mel frames; the vocoder decodes a window
  of 2H + 8 frames whose first H frames are warm-up context, the source
  phase continues across windows through `CausalHiFT.rad_delta` sums
  (mod 1), and the noise is taken at absolute sample offsets: the stream
  equals vocoding the whole mel at once, sample for sample.

Emission grid: audio frames [0, 42) after hop 1, [42, 92) after hop 2,
[92, 100) after hop 3, then 50 frames (1 s of audio) a hop, one hop
behind; the finalize step flushes the rest.

The JAX package caches one jitted program per shape on the TTS object;
here the steps are plain methods. What stays cached on the TTS object is
what a cache is for in PyTorch: the device noise buffers, made once.
Conditioning (prompt mel, x-vector) is an argument of every call and is
never kept across sessions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.flow import cfm_solve, cfm_solve_chunk, empty_kv_cache, fixed_cfm_noise
from ..models.hift import nsf_buffers

F_CAP = 128  # capacity of the finalize mel remainder (the remainder is below 104 frames)


class HostAudio:
    """A float32 audio chunk whose device-to-host copy has been started
    (into pinned memory, behind a CUDA event), so that the caller can
    dispatch the next hop before it waits for this one. np.asarray(chunk)
    waits for the copy and returns the samples."""

    __slots__ = ("_host", "_event")

    def __init__(self, audio: torch.Tensor):
        if audio.device.type == "cuda":
            self._host = torch.empty(audio.shape, dtype=audio.dtype, pin_memory=True)
            self._host.copy_(audio, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = audio, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.numpy(), dtype=dtype)

    def __len__(self) -> int:
        return self._host.shape[0]


def _nsf_noise(tts) -> torch.Tensor:
    """The vocoder's streaming noise on the device: the first
    `stream_noise_seconds` of nsf_buffers' uniform buffer, made once per
    TTS object."""
    if tts._nsf_noise_dev is None:
        c = tts.cfg.hift
        n = c.sampling_rate * c.stream_noise_seconds
        tts._nsf_noise_dev = torch.from_numpy(nsf_buffers(c.nb_harmonics + 1)[1][:, :n]).to(tts.device)
    return tts._nsf_noise_dev


def cfm_noise(tts) -> torch.Tensor:
    """fixed_cfm_noise on the device in the model dtype, made once per TTS
    object (shared with the offline path)."""
    if tts._cfm_noise is None:
        tts._cfm_noise = torch.from_numpy(fixed_cfm_noise()).to(tts.device, tts.dtype)
    return tts._cfm_noise


# ---------------------------------------------------------------------------
# vocoder stream
# ---------------------------------------------------------------------------


class VocStream:
    """Windowed streaming vocoder of one session."""

    F0L = 8  # the f0 predictor's left receptive field (4 causal k=3 convs)

    def __init__(self, tts):
        self.t = tts
        c = tts.cfg
        self.H = c.chunk_size * c.token_mel_ratio  # 50 mel frames a hop
        self.up = c.hift.total_upsample
        # lookahead: 3 (f0 right context) + conv_pre_look_right + 1 (iSTFT trim)
        self.LA = 3 + c.hift.conv_pre_look_right + 1
        self.TAIL = 3 * self.H + self.LA
        self.WIN = 2 * self.H + self.LA
        self.nh = c.hift.nb_harmonics + 1
        self.k = 0  # pushes so far
        self.tail = torch.zeros((1, self.TAIL, c.hift.in_channels), dtype=tts.dtype, device=tts.device)
        self.carry = torch.zeros((1, self.nh), dtype=torch.float32, device=tts.device)
        self.emitted = 0  # mel frames' worth of audio handed out

    def push_rows(self, variant: str, tail: torch.Tensor, mel_h: torch.Tensor, carry: torch.Tensor,
                  noise_off: int | torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One push of `variant` for B rows at the same push index (this
        session's, or a batched group's): tail (B, TAIL, 80), mel_h (B, H,
        80), carry (B, nh), noise_off an int or (B,) per row. Returns (new
        tail, audio (B, samples), new carry); touches no session state."""
        hift, H, LA, WIN, F0L, up = self.t.hift, self.H, self.LA, self.WIN, self.F0L, self.up
        tail = torch.cat([tail, mel_h], dim=1)[:, -self.TAIL :]
        if variant == "young1":  # frames [0, H): emit [0, H - LA)
            return tail, hift(tail[:, -H:], finalize=False)[0], carry
        if variant == "young2":  # frames [0, 2H): emit [H - LA, 2H - LA)
            return tail, hift(tail[:, -2 * H :], finalize=False)[0][:, (H - LA) * up :], carry
        audio = hift.stream_window(tail[:, LA : LA + WIN], carry, noise_off, _nsf_noise(self.t))
        if variant == "first":  # frames [0, 2H): emit [2H - LA, 2H)
            delta = hift.rad_delta(tail[:, LA : LA + H + 3], n_left=0)
            return tail, audio[:, (2 * H - LA) * up : 2 * H * up], torch.remainder(delta, 1.0)
        # steady: window [a, a + WIN), emit [a + H, a + 2H)
        delta = hift.rad_delta(tail[:, LA - F0L : LA + H + 3], n_left=F0L)
        return tail, audio[:, H * up : 2 * H * up], torch.remainder(carry + delta, 1.0)

    @torch.inference_mode()
    def _push(self, variant: str, mel_h: torch.Tensor, noise_off: int) -> torch.Tensor:
        self.tail, audio, self.carry = self.push_rows(variant, self.tail, mel_h, self.carry, noise_off)
        return audio

    def push_dev(self, mel_h: torch.Tensor) -> HostAudio:
        """mel_h (1, H, 80) device mel on the 50-frame grid. Returns the new
        audio chunk with its copy to the host started."""
        self.k += 1
        H, LA = self.H, self.LA
        variant = {1: "young1", 2: "young2", 3: "first"}.get(self.k, "steady")
        off = (self.k * H - 3 * H) * self.up if variant == "steady" else 0
        audio = self._push(variant, mel_h.to(self.t.dtype), off)
        self.emitted = {1: H - LA, 2: 2 * H - LA, 3: 2 * H}.get(self.k, (self.k - 1) * H)
        return HostAudio(audio.float()[0])

    @torch.inference_mode()
    def finalize_dev(self, f_pad: torch.Tensor, n_rem: int):
        """Dispatch the last vocoder window and return a () -> np.ndarray
        fetch, so that the caller can overlap its other fetches with it.
        f_pad (1, F_CAP, 80): the last n_rem un-pushed frames, zero-padded."""
        H = self.H
        if self.k >= 3:
            k_base, carry, off = 2 * H, self.carry, (self.k * H - 2 * H) * self.up
        else:
            k_base, carry, off = self.k * H, torch.zeros_like(self.carry), 0
        total = self.k * H + n_rem
        if total == 0:
            return lambda: np.zeros(0, np.float32)
        n_valid = k_base + n_rem
        f_pad = f_pad.to(self.t.dtype)
        window = torch.cat([self.tail[:, -k_base:], f_pad], dim=1) if k_base > 0 else f_pad
        audio = HostAudio(self.t.hift.finalize_window(window, n_valid, carry, off, _nsf_noise(self.t)).float()[0])
        start = self.emitted - (total - n_valid)  # emitted frames, relative to the window
        return lambda: audio.numpy()[start * self.up : n_valid * self.up]

    def finalize(self, f_pad: torch.Tensor, n_rem: int) -> np.ndarray:
        return self.finalize_dev(f_pad, n_rem)()


# ---------------------------------------------------------------------------
# flow stream
# ---------------------------------------------------------------------------


class FlowStream:
    """Streaming token -> mel with a capped window. Emits exactly H = 50 mel
    frames a hop on the vocoder's grid (the 2 * prompt_pad newest frames are
    held back one hop so that pushes stay on the grid)."""

    def __init__(self, tts, prompt_tokens: np.ndarray, prompt_feat, embedding, prompt_pad: int):
        self.t = tts
        c = tts.cfg
        dev = tts.device
        self.hop = c.chunk_size
        self.la = c.flow.pre_lookahead_len
        self.ratio = c.token_mel_ratio
        self.H = self.hop * self.ratio
        self.W = tts.stream_window_tokens
        self.pad = prompt_pad
        self.prompt_tokens = np.asarray(prompt_tokens, np.int32)
        self.P = len(self.prompt_tokens)
        self.prompt_feat = torch.as_tensor(prompt_feat, device=dev).to(tts.dtype)
        if self.prompt_feat.dim() == 2:
            self.prompt_feat = self.prompt_feat[None]
        self.P_mel = int(self.prompt_feat.shape[1])
        self.pf_len = torch.tensor([self.P_mel], dtype=torch.int32, device=dev)
        self.emb = torch.as_tensor(embedding, device=dev).float()
        if self.emb.dim() == 1:
            self.emb = self.emb[None]
        self.hops_done = 0
        # the KV-cached young phase: a hop costs its own frames, not the prefix
        self.kv = bool(getattr(tts, "flow_kv_stream", True))
        self._kv_cache = None
        self._kv_cap = 0  # allocated capacity, on a x2 ladder: a hop's cost follows it, so start small
        self._kv_spks = None
        self._kv_held = None  # (1, pad * ratio, 80) newest frames, held one hop
        self._kv_len = 0  # frames cached (the write front)

    @staticmethod
    def _kv_ladder(needed: int) -> int:
        c = 128
        while c < needed:
            c *= 2
        return c

    def _tokens_dev(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(tokens, np.int32)[None]).to(self.t.device)

    def _kv_new(self, capacity: int) -> None:
        self._kv_cap = capacity
        self._kv_cache = empty_kv_cache(self.t.cfg.flow, 2, capacity, self.t.dtype, self.t.device)

    def _kv_ensure(self, needed: int) -> None:
        """Grow the KV cache to a ladder capacity of at least `needed`: a
        larger cache, the cached slots copied into it once."""
        nc = self._kv_ladder(needed)
        if nc <= self._kv_cap:
            return
        old, cap = self._kv_cache, self._kv_cap
        self._kv_new(nc)
        for k in ("k", "v"):
            self._kv_cache[k][..., :cap, :] = old[k]
        for k in ("tail1", "tail2"):
            self._kv_cache[k] = old[k]

    @torch.inference_mode()
    def _window(self, token_win: np.ndarray, tgt_start: int, finalize: bool, n_rem: int = 0) -> torch.Tensor:
        """The flow on [prompt ++ the last W target tokens (++ lookahead)],
        noise at absolute mel positions. Returns the hop's (1, H, 80) mel,
        or at finalize the last n_rem frames left-aligned in (1, F_CAP, 80)."""
        t, W, ratio, P, P_mel = self.t, self.W, self.ratio, self.P, self.P_mel
        n_tok = P + W + (0 if finalize else self.la)
        l_mel = (P + W) * ratio
        dev = t.device
        mu, spks, conds, mel_len = t.flow.prepare_inference(
            self._tokens_dev(token_win), torch.tensor([n_tok], dtype=torch.int32, device=dev), self.prompt_feat,
            self.pf_len, self.emb, finalize=finalize)
        buf = cfm_noise(t)
        # wrapped past the noise buffer's end (as the batched path wraps, for streams over 300 s)
        start = (P_mel + tgt_start * ratio) % (buf.shape[1] - W * ratio)
        z = torch.cat([buf[:, :P_mel], buf[:, start : start + W * ratio]], dim=1).to(mu.dtype)
        mel = cfm_solve(t.cfg.flow, t.flow.estimator, z, mu, spks, conds, mel_len, streaming=True)
        if finalize:
            return F.pad(mel, (0, 0, 0, F_CAP))[:, l_mel - n_rem : l_mel - n_rem + F_CAP]
        end = l_mel - self.pad * ratio  # the held-back region is pad * ratio frames
        return mel[:, end - self.H : end]

    # ---- KV-cached young phase ------------------------------------------------

    def _kv_prefill(self, tok: torch.Tensor) -> torch.Tensor:
        """Hop 1: prompt ++ the first hop (with prompt_pad) ++ lookahead, all
        new frames of the cache. tok (1, P + hop + pad + la) on the device."""
        t, consumed = self.t, self.hop + self.pad
        lq0 = self.P_mel + consumed * self.ratio
        self._kv_new(self._kv_ladder(lq0 + self.H))
        dev = t.device
        mu, spks, conds, _ = t.flow.prepare_inference(
            tok, torch.tensor([tok.shape[1]], dtype=torch.int32, device=dev), self.prompt_feat, self.pf_len,
            self.emb, finalize=False)
        z = cfm_noise(t)[:, :lq0].to(mu.dtype)
        x = cfm_solve_chunk(t.cfg.flow, t.flow.estimator_chunk, z, mu[:, :lq0], spks, conds[:, :lq0],
                            self._kv_cache, [0], [lq0])[:, self.P_mel :]
        self._kv_spks = spks
        self._kv_len = lq0
        self._kv_held = x[:, self.H :]
        return x[:, : self.H]

    @torch.inference_mode()
    def _kv_step(self, tokens: np.ndarray, k: int, consumed: int) -> torch.Tensor:
        t = self.t
        if k == 1:
            return self._kv_prefill(self._tokens_dev(np.concatenate([self.prompt_tokens,
                                                                     tokens[: consumed + self.la]])))
        s = consumed - self.hop
        self._kv_ensure(self._kv_len + self.H)
        mu = t.flow.prepare_chunk(self._tokens_dev(tokens[s - 2 : s + self.hop + self.la]))
        z = cfm_noise(t)[:, self._kv_len : self._kv_len + self.H].to(mu.dtype)
        x = cfm_solve_chunk(t.cfg.flow, t.flow.estimator_chunk, z, mu, self._kv_spks, torch.zeros_like(z),
                            self._kv_cache, [self._kv_len], [self.H])
        self._kv_len += self.H
        hb = self.pad * self.ratio  # held-back frames
        if hb == 0:
            return x
        mel_h = torch.cat([self._kv_held, x[:, : self.H - hb]], dim=1)
        self._kv_held = x[:, self.H - hb :]
        return mel_h

    @torch.inference_mode()
    def _kv_finalize(self, tokens: np.ndarray) -> torch.Tensor:
        t = self.t
        consumed = self.hop * self.hops_done + self.pad
        n_new = len(tokens) - consumed
        ft = self.hop + self.la  # token capacity of the last, partial hop
        self._kv_ensure(self._kv_len + ft * self.ratio)
        tok_ctx = np.zeros(2 + ft, np.int32)
        tok_ctx[: 2 + n_new] = tokens[consumed - 2 :]
        mu = t.flow.prepare_chunk(self._tokens_dev(tok_ctx), finalize=True,
                                  n_valid=torch.tensor([n_new], dtype=torch.int32, device=t.device))
        z = cfm_noise(t)[:, self._kv_len : self._kv_len + ft * self.ratio].to(mu.dtype)
        q_valid = n_new * self.ratio
        x = cfm_solve_chunk(t.cfg.flow, t.flow.estimator_chunk, z, mu, self._kv_spks, torch.zeros_like(z),
                            self._kv_cache, [self._kv_len], [q_valid])
        x = x * (torch.arange(ft * self.ratio, device=t.device)[None, :, None] < q_valid).to(x.dtype)
        held = self._kv_held if self._kv_held is not None else x[:, :0]
        out = torch.cat([held.to(x.dtype), x], dim=1)
        self._kv_cache = None
        return F.pad(out, (0, 0, 0, F_CAP - out.shape[1]))

    @torch.inference_mode()
    def step_first_dev(self, tok_dev: torch.Tensor) -> torch.Tensor | None:
        """Hop 1 speculated on the raw device token chunk of the LLM (silent
        runs not yet suppressed): the same KV prefill as `step`, dispatched
        before the tokens are fetched. The caller validates the fetched
        tokens afterwards (Token2WavSession.commit_first / reset). Returns
        (1, H, 80) device mel, or None where this stream cannot speculate."""
        assert self.hops_done == 0
        consumed = self.hop + self.pad
        if not self.kv or consumed - self.W >= 0 or tok_dev.shape[0] < consumed + self.la:
            return None
        tok = tok_dev[: consumed + self.la].to(torch.int32)
        if self.P:
            tok = torch.cat([torch.from_numpy(self.prompt_tokens).to(tok.device), tok])
        mel_h = self._kv_prefill(tok[None])
        self.hops_done = 1
        return mel_h

    @torch.inference_mode()
    def step(self, tokens: np.ndarray) -> torch.Tensor:
        """One hop. tokens: every target token so far (host). Consumes the
        next hop (hop 1 also the prompt_pad) and returns (1, H, 80) device
        mel on the vocoder's grid."""
        k = self.hops_done + 1
        consumed = self.hop * k + self.pad
        s = consumed - self.W  # the window's first target token
        if s >= 0:
            self._kv_cache = None  # past the window the windowed splice takes over
            mel_h = self._window(np.concatenate([self.prompt_tokens, tokens[s : consumed + self.la]]), s, False)
        elif self.kv:
            mel_h = self._kv_step(tokens, k, consumed)
        else:
            mel = self.t.token2mel(tokens[: consumed + self.la], self.prompt_tokens, self.prompt_feat[0], self.emb[0],
                                   streaming=True, finalize=False, device_out=True)
            mel_h = mel[(k - 1) * self.H : k * self.H][None]
        self.hops_done = k
        return mel_h

    @torch.inference_mode()
    def finalize(self, tokens: np.ndarray) -> tuple[torch.Tensor, int]:
        """The last flow call, over the remaining tokens. Returns (f_pad
        (1, F_CAP, 80) on the device, n_rem) for VocStream.finalize."""
        n_t = len(tokens)
        n_rem = n_t * self.ratio - self.hops_done * self.H
        assert 0 <= n_rem < F_CAP, f"streaming remainder {n_rem} out of range"
        if n_rem == 0:
            return torch.zeros((1, F_CAP, 80), dtype=self.t.dtype, device=self.t.device), 0
        if n_t >= self.W:
            self._kv_cache = None
            win = np.concatenate([self.prompt_tokens, tokens[n_t - self.W :]])
            return self._window(win, n_t - self.W, True, n_rem), n_rem
        if self.kv and self._kv_cache is not None:
            return self._kv_finalize(tokens), n_rem
        mel = self.t.token2mel(tokens, self.prompt_tokens, self.prompt_feat[0], self.emb[0], streaming=True,
                               finalize=True, device_out=True)
        start = self.hops_done * self.H
        return F.pad(mel[None], (0, 0, 0, F_CAP))[:, start : start + F_CAP], n_rem


# ---------------------------------------------------------------------------
# session: incremental tokens in, audio chunks out
# ---------------------------------------------------------------------------


class Token2WavSession:
    """One streaming utterance: push speech-token chunks as the LM emits
    them, get audio chunks back; finish() flushes the tail."""

    def __init__(self, tts, prompt_token, prompt_feat, embedding):
        c = tts.cfg
        self.hop = c.chunk_size
        self.la = c.flow.pre_lookahead_len
        self._init_args = (tts, np.asarray(prompt_token, np.int32), prompt_feat, embedding)
        self.reset()

    def reset(self) -> None:
        """(Re)start the state machines: at construction, and to roll back a
        failed first-hop speculation. The flow noise and the vocoder's noise
        and phase are indexed absolutely, so a replay from a fresh state
        equals never having speculated."""
        tts, prompt_token, prompt_feat, embedding = self._init_args
        self.prompt_pad = -len(prompt_token) % self.hop
        self.fs = FlowStream(tts, prompt_token, prompt_feat, embedding, self.prompt_pad)
        self.vs = VocStream(tts)
        self.tokens = np.zeros(0, np.int32)
        self.token_offset = 0
        self.finished = False

    @property
    def first_hop_tokens(self) -> int:
        """Tokens the first hop consumes, lookahead included (what a
        speculation needs)."""
        return self.hop + self.prompt_pad + self.la

    def speculate_first(self, raw_dev: torch.Tensor) -> HostAudio | None:
        """Dispatch the first hop (flow KV prefill and vocoder push) on the
        raw device token chunk of the LLM, before the host has its values.
        Returns the audio chunk, or None where the session cannot
        speculate. The caller must then commit_first(the suppressed tokens),
        having checked that their first `first_hop_tokens` equal the raw
        chunk's, or reset()."""
        if self.finished or self.token_offset or len(self.tokens):
            return None
        mel_h = self.fs.step_first_dev(raw_dev)
        return None if mel_h is None else self.vs.push_dev(mel_h)

    def commit_first(self, first_tokens: np.ndarray) -> list[HostAudio]:
        """Accept a validated speculation: first_tokens is the whole first LLM
        chunk after silent-run suppression. Runs the further hops it already
        allows."""
        self.tokens = np.asarray(first_tokens, np.int32)
        self.token_offset = self.hop + self.prompt_pad
        return self._drain()

    def push_dev(self, new_tokens: np.ndarray) -> list[HostAudio]:
        """Feed newly decoded speech tokens; returns the audio chunks that
        became ready (possibly none), their copies to the host started."""
        self.tokens = np.concatenate([self.tokens, np.asarray(new_tokens, np.int32)])
        return self._drain()

    def push(self, new_tokens: np.ndarray) -> list[np.ndarray]:
        return [a.numpy() for a in self.push_dev(new_tokens)]

    def _drain(self) -> list[HostAudio]:
        out = []
        while True:
            this_hop = self.hop + self.prompt_pad if self.token_offset == 0 else self.hop
            if len(self.tokens) - self.token_offset < this_hop + self.la:
                return out
            mel_h = self.fs.step(self.tokens)
            self.token_offset += this_hop
            audio = self.vs.push_dev(mel_h)
            if len(audio):
                out.append(audio)

    def finish_dev(self):
        """Dispatch the last flow and vocoder windows; returns the fetch
        (VocStream.finalize_dev)."""
        assert not self.finished
        self.finished = True
        f_pad, n_rem = self.fs.finalize(self.tokens)
        return self.vs.finalize_dev(f_pad, n_rem)

    def finish(self) -> np.ndarray:
        return self.finish_dev()()
