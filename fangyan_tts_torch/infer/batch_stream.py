"""Batched concurrent streaming: N sessions share the token2wav calls
(fangyan_tts_tpu/infer/batch_stream.py: `BatchedStreamGroup`,
`StreamScheduler`).

- Window hops (infer/stream.FlowStream's steady phase) of all ready rows run
  as one flow call at B = N (2N rows in the DiT: the CFG pair), each row's
  CFM noise taken at its own absolute position, wrapped as the solo stream
  wraps it.
- Young hops (the full-prefix phase; the group's FlowStreams run with
  kv = False) of rows at different depths run as one call too: each row is
  [prompt ++ its tokens ++ lookahead ++ zeros], right-padded to a bucket of
  YOUNG_BUCKET tokens, through prepare_inference(padded_streaming=True), so
  rows of one call have their own valid length.
- Steady vocoder pushes run as one windowed decode at B = N with stacked
  tails, per-row phase carries and noise offsets; rows without a hop keep
  their state. Young pushes of rows at the same push index run together.
- A close cohort's flow and vocoder finalize run as one call each
  (`finish_many`).

Slots of one group share the prompt length. Rows match the solo stream of
the same session (tests/test_torch_batch_stream.py). The JAX package keeps
one jitted program per shape; here each batched stage is a method, and
`prewarm` makes the first call at each of the group's shapes before traffic.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models.flow import cfm_solve
from .stream import F_CAP, FlowStream, VocStream, _nsf_noise, cfm_noise

# young-hop bucket in target tokens: a group's young calls take a handful of
# lengths (prewarm walks them), and early hops do not pay for the whole window
YOUNG_BUCKET = 64


def _young_bucket(n: int) -> int:
    return -(-n // YOUNG_BUCKET) * YOUNG_BUCKET


def flow_shapes(cfg, window: int, n_prompt: int, width: int) -> dict:
    """Every flow call a width-`width` group of n_prompt-token prompts can
    make with a window of `window` tokens, by kind: {kind: {(rows, L)}}, rows
    the DiT's batch (the CFG pair of each stream row) and L its mel frames.
    "young": the bucketed young hops; "window": the window hops and the
    cohort finalize; and at one slot (2 rows) "slot young" (a young hop on
    its own), "slot finalize" (a young stream's last call, its tokens
    padded to 32 by CosyVoice3TTS.token2mel) and "slot window"."""
    hop, la, r = cfg.chunk_size, cfg.flow.pre_lookahead_len, cfg.token_mel_ratio
    young = range(-n_prompt % hop + hop, window, hop)  # the tokens a young hop has consumed
    rows = 2 * width
    return {"young": {(rows, (n_prompt + _young_bucket(c + la)) * r) for c in young},
            "window": {(rows, (n_prompt + window) * r)},
            "slot young": {(2, (n_prompt + c) * r) for c in young},
            "slot finalize": {(2, -(-(n_prompt + n) // 32) * 32 * r) for n in range(1, window)},
            "slot window": {(2, (n_prompt + window) * r)}}


class BatchedStreamGroup:
    """N streaming sessions with batched token2wav.

        g = BatchedStreamGroup(tts, [(prompt_tokens, prompt_feat, embedding), ...])
        g.feed(slot, tokens)            # newly decoded speech tokens
        for slot, audio in g.step():    # advance every slot with a ready hop
            ...
        tail = g.finish(slot)           # or g.finish_many(slots)
    """

    def __init__(self, tts, slots):
        self.t = tts
        self.n = len(slots)
        self.fs: list[FlowStream] = []
        self.vs: list[VocStream] = []
        self.tokens = [np.zeros(0, np.int32) for _ in slots]
        self.token_offset = [0] * self.n
        p0 = len(np.asarray(slots[0][0]))
        for ptok, pfeat, emb in slots:
            ptok = np.asarray(ptok, np.int32)
            if len(ptok) != p0:
                raise ValueError("batched slots must share the prompt length")
            self.fs.append(self._flow_stream(ptok, pfeat, emb))
            self.vs.append(VocStream(tts))
        f, v = self.fs[0], self.vs[0]
        self.P, self.P_mel, self.ratio = f.P, f.P_mel, f.ratio
        self.hop, self.la, self.pad, self.H, self.W = f.hop, f.la, f.pad, f.H, f.W
        self.LA, self.TAIL, self.WIN, self.up = v.LA, v.TAIL, v.WIN, v.up
        # the stacked steady vocoder state (a row's is valid once the slot is past push 3)
        self.tails = torch.zeros((self.n, self.TAIL, tts.cfg.hift.in_channels), dtype=tts.dtype, device=tts.device)
        self.carries = torch.zeros((self.n, v.nh), dtype=torch.float32, device=tts.device)
        self.pushes = [0] * self.n
        # the stacked conditioning of the batched flow calls
        self.pf = torch.cat([f.prompt_feat for f in self.fs])
        self.emb = torch.cat([f.emb for f in self.fs])
        self.pf_len = torch.full((self.n,), self.P_mel, dtype=torch.int32, device=tts.device)
        # host counters: flow calls (each one CFM solve, batched or one slot's) and hops (rows advanced)
        self.flow_calls = 0
        self.hops = 0

    def _flow_stream(self, ptok, pfeat, emb) -> FlowStream:
        f = FlowStream(self.t, ptok, pfeat, emb, -len(ptok) % self.t.cfg.chunk_size)
        f.kv = False  # the young hops batch through the bucketed full-prefix call
        return f

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.t.device)

    def _window_noise(self, tgt_starts: np.ndarray) -> torch.Tensor:
        """Each row's CFM noise over [prompt ++ window]: the prompt rows, then
        the window's rows at their absolute position, wrapped past the
        buffer's end as FlowStream._window wraps them."""
        buf, n_win = cfm_noise(self.t), self.W * self.ratio
        starts = (self.P_mel + tgt_starts.astype(np.int64) * self.ratio) % (buf.shape[1] - n_win)
        idx = self._dev(starts)[:, None] + torch.arange(n_win, device=buf.device)[None, :]
        return torch.cat([buf[:, : self.P_mel].expand(self.n, -1, -1), buf[0][idx]], dim=1)

    # ---- batched stages ---------------------------------------------------------

    @torch.inference_mode()
    def _flow_window(self, tok: np.ndarray, tgt_starts: np.ndarray, finalize: bool = False,
                     n_rems: np.ndarray | None = None) -> torch.Tensor:
        """The window flow for every row (FlowStream._window at B = N): tok
        (N, P + W (+ la)). Returns each row's newest hop (N, H, 80), or at
        finalize its last n_rems frames left-aligned in (N, F_CAP, 80)."""
        t = self.t
        self.flow_calls += 1
        mu, spks, conds, mel_len = t.flow.prepare_inference(
            self._dev(tok), torch.full((self.n,), tok.shape[1], dtype=torch.int32, device=t.device), self.pf,
            self.pf_len, self.emb, finalize=finalize)
        z = self._window_noise(tgt_starts).to(mu.dtype)
        mel = cfm_solve(t.cfg.flow, t.flow.estimator, z, mu, spks, conds, mel_len, streaming=True)
        l_mel = (self.P + self.W) * self.ratio
        if finalize:
            idx = self._dev((l_mel - n_rems).astype(np.int64))[:, None] + torch.arange(F_CAP, device=t.device)
            return torch.gather(F.pad(mel, (0, 0, 0, F_CAP)), 1, idx[:, :, None].expand(-1, -1, mel.shape[2]))
        end = l_mel - self.pad * self.ratio  # the held-back region is pad * ratio frames
        return mel[:, end - self.H : end]

    @torch.inference_mode()
    def _flow_young(self, tok: np.ndarray, n_tok: np.ndarray, ks: np.ndarray) -> torch.Tensor:
        """Young hops of rows at different depths in one call: tok (N, P +
        bucket) right-padded rows, n_tok their lengths (lookahead included),
        ks their hop numbers. The noise is the buffer's prefix, as the solo
        full-prefix hop takes it. Returns (N, H, 80): row i's hop ks[i]."""
        t = self.t
        self.flow_calls += 1
        # the x-vector in the model dtype, as the solo full-prefix hop (CosyVoice3TTS.token2mel) takes it
        mu, spks, conds, mel_len = t.flow.prepare_inference(
            self._dev(tok), self._dev(n_tok), self.pf, self.pf_len, self.emb.to(t.dtype), finalize=False,
            padded_streaming=True)
        l_mel = mu.shape[1]
        z = cfm_noise(t)[:, :l_mel].expand(self.n, -1, -1).to(mu.dtype)
        mel = cfm_solve(t.cfg.flow, t.flow.estimator, z, mu, spks, conds, mel_len, streaming=True)
        starts = self._dev((self.P_mel + (ks.astype(np.int64) - 1) * self.H))
        idx = starts[:, None] + torch.arange(self.H, device=t.device)[None, :]
        return torch.gather(mel, 1, idx[:, :, None].expand(-1, -1, mel.shape[2]))

    @torch.inference_mode()
    def _voc_steady(self, mels: torch.Tensor, offs: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """One steady push for every row (VocStream's "steady" at B = N);
        inactive rows keep their tail and carry. Returns (N, H * 480)."""
        tails, audio, carries = self.vs[0].push_rows("steady", self.tails, mels, self.carries, self._dev(offs))
        on = self._dev(active)
        self.tails = torch.where(on[:, None, None], tails, self.tails)
        self.carries = torch.where(on[:, None], carries, self.carries)
        return audio

    @torch.inference_mode()
    def _voc_finalize(self, f_pads: torch.Tensor, n_valids: np.ndarray, offs: np.ndarray) -> torch.Tensor:
        """The last vocoder window of every row past push 3 (VocStream.finalize
        with k_base = 2H at B = N). Returns (N, (2H + F_CAP) * 480)."""
        window = torch.cat([self.tails[:, -2 * self.H :], f_pads.to(self.t.dtype)], dim=1)
        return self.t.hift.finalize_window(window, self._dev(n_valids), self.carries, self._dev(offs),
                                           _nsf_noise(self.t))

    @torch.inference_mode()
    def prewarm(self) -> None:
        """A first call of each batched stage at each of the group's shapes
        (every young bucket, the window, the finalize pair, the vocoder's
        steady push and each young push at every batch size), so that no
        first-use cost lands inside a live hop."""
        n, la = self.n, self.la
        zeros = np.zeros(n, np.int64)
        for b in sorted({_young_bucket(c + la) for c in range(self.pad + self.hop, self.W, self.hop)}):
            self._flow_young(np.zeros((n, self.P + b), np.int32), np.full(n, la + 1, np.int32), np.ones(n, np.int32))
        self._flow_window(np.zeros((n, self.P + self.W + la), np.int32), zeros)
        f_pads = self._flow_window(np.zeros((n, self.P + self.W), np.int32), zeros, True, zeros)
        mel_c = self.t.cfg.hift.in_channels
        keep = (self.tails, self.carries)
        self._voc_steady(torch.zeros((n, self.H, mel_c), dtype=self.t.dtype, device=self.t.device), zeros,
                         np.zeros(n, bool))
        self._voc_finalize(f_pads, np.full(n, 2 * self.H), zeros)
        self.tails, self.carries = keep
        v0 = self.vs[0]
        for variant in ("young1", "young2", "first"):
            for bs in range(1, n + 1):
                v0.push_rows(variant, self.tails[:bs], torch.zeros((bs, self.H, mel_c), dtype=self.t.dtype,
                                                                   device=self.t.device), self.carries[:bs], 0)
        if self.t.device.type == "cuda":
            torch.cuda.synchronize()

    # ---- session API --------------------------------------------------------------

    def feed(self, slot: int, new_tokens: np.ndarray) -> None:
        self.tokens[slot] = np.concatenate([self.tokens[slot], np.asarray(new_tokens, np.int32)])

    def hop_ready(self, slot: int) -> bool:
        this_hop = self.hop + self.pad if self.token_offset[slot] == 0 else self.hop
        return len(self.tokens[slot]) - self.token_offset[slot] >= this_hop + self.la

    @torch.inference_mode()
    def step(self) -> list:
        """Advance every slot with a ready hop, batching the flow and vocoder
        calls. Returns [(slot, np.float32 audio chunk), ...]."""
        out = []
        window_rows = []  # (slot, window start) of the batched window flow
        young_rows = []  # (slot, consumed, hop number) of the bucketed young call
        mel_hops: dict = {}
        for i in range(self.n):
            if not self.hop_ready(i):
                continue
            f = self.fs[i]
            k = f.hops_done + 1
            consumed = self.hop * k + self.pad
            s = consumed - self.W
            if s >= 0 and self.pushes[i] >= 3:
                window_rows.append((i, s))
            elif s >= 0:  # on the window before the vocoder's push 3: the slot's own call
                mel_hops[i] = self._slot_step(i)
                self.token_offset[i] = consumed
            else:
                young_rows.append((i, consumed, k))

        if len(young_rows) == 1:  # one row: the solo full-prefix call
            i, consumed, _ = young_rows[0]
            mel_hops[i] = self._slot_step(i)
            self.token_offset[i] = consumed
        elif young_rows:
            bucket = _young_bucket(max(c + self.la for _, c, _ in young_rows))
            tok = np.zeros((self.n, self.P + bucket), np.int32)
            n_tok = np.full(self.n, self.la + 1, np.int32)  # rows without a hop: one valid frame
            ks = np.ones(self.n, np.int32)
            for i, consumed, k in young_rows:
                row = np.concatenate([self.fs[i].prompt_tokens, self.tokens[i][: consumed + self.la]])
                tok[i, : len(row)] = row
                n_tok[i], ks[i] = len(row), k
            mels = self._flow_young(tok, n_tok, ks)
            self.hops += len(young_rows)
            for i, consumed, _ in young_rows:
                self.fs[i].hops_done += 1
                self.token_offset[i] = consumed
                mel_hops[i] = mels[i : i + 1]

        if window_rows:
            tok = np.zeros((self.n, self.P + self.W + self.la), np.int32)
            starts = np.zeros(self.n, np.int64)
            for i, s in window_rows:
                tok[i] = np.concatenate([self.fs[i].prompt_tokens, self.tokens[i][s : s + self.W + self.la]])
                starts[i] = s
            mels = self._flow_window(tok, starts)
            self.hops += len(window_rows)
            for i, s in window_rows:
                self.fs[i].hops_done += 1
                self.token_offset[i] = s + self.W
                mel_hops[i] = mels[i : i + 1]

        # the vocoder: young pushes grouped by push index, then the steady rows in one call (a
        # row's push 3 moves it into the steady state, for its next hop)
        steady = [i for i in mel_hops if self.pushes[i] >= 3]
        young_by_k: dict = {}
        for i in mel_hops:
            if self.pushes[i] < 3:
                young_by_k.setdefault(self.vs[i].k + 1, []).append(i)
        for k, slots in sorted(young_by_k.items()):
            if len(slots) == 1:
                a = self._young_push(slots[0], mel_hops[slots[0]])
                if len(a):
                    out.append((slots[0], a))
                continue
            v0 = self.vs[slots[0]]
            tails, audio, carries = v0.push_rows(
                {1: "young1", 2: "young2", 3: "first"}[k], torch.cat([self.vs[i].tail for i in slots]),
                torch.cat([mel_hops[i] for i in slots]).to(self.t.dtype),
                torch.cat([self.vs[i].carry for i in slots]), 0)
            audio_np = audio.float().cpu().numpy()
            for j, i in enumerate(slots):
                v = self.vs[i]
                v.tail, v.carry, v.k = tails[j : j + 1], carries[j : j + 1], k
                v.emitted = {1: self.H - self.LA, 2: 2 * self.H - self.LA, 3: 2 * self.H}[k]
                self._moved(i)
                if audio_np[j].size:
                    out.append((i, audio_np[j]))
        if steady:
            mel_c = self.t.cfg.hift.in_channels
            mels = torch.cat([mel_hops[i].to(self.t.dtype) if i in steady else
                              torch.zeros((1, self.H, mel_c), dtype=self.t.dtype, device=self.t.device)
                              for i in range(self.n)])
            offs = np.zeros(self.n, np.int64)
            active = np.zeros(self.n, bool)
            for i in steady:
                self.pushes[i] += 1
                offs[i] = (self.pushes[i] * self.H - 3 * self.H) * self.up
                active[i] = True
            emit = self._voc_steady(mels, offs, active).float().cpu().numpy()
            out += [(i, emit[i]) for i in steady]
        return out

    def _slot_step(self, i: int) -> torch.Tensor:
        """Slot i's hop through its own FlowStream (one flow call)."""
        self.flow_calls += 1
        self.hops += 1
        return self.fs[i].step(self.tokens[i])

    def _moved(self, i: int) -> None:
        """After a young push of slot i: on push 3 its tail and carry move
        into the stacked steady state."""
        v = self.vs[i]
        self.pushes[i] = v.k
        if v.k == 3:
            self.tails[i] = v.tail[0].to(self.t.dtype)
            self.carries[i] = v.carry[0]

    def _young_push(self, i: int, mel_h: torch.Tensor) -> np.ndarray:
        a = self.vs[i].push_dev(mel_h).numpy()
        self._moved(i)
        return a

    @torch.inference_mode()
    def finish(self, slot: int) -> np.ndarray:
        """Flush one slot through its own FlowStream and VocStream."""
        f, v = self.fs[slot], self.vs[slot]
        if self.pushes[slot] > 3:  # the slot's VocStream again from the stacked state
            v.tail = self.tails[slot : slot + 1].to(v.tail.dtype)
            v.carry = self.carries[slot : slot + 1]
            v.k = self.pushes[slot]
            v.emitted = (v.k - 1) * self.H
        f_pad, n_rem = f.finalize(self.tokens[slot])
        self.flow_calls += n_rem > 0  # no remainder: no flow call
        return v.finalize(f_pad, n_rem)

    @torch.inference_mode()
    def finish_many(self, slots: list) -> dict:
        """Flush several slots. The ones past the window and the vocoder's
        push 3 share one flow finalize and one vocoder finalize call; the
        others go through finish(). Returns {slot: tail audio}."""
        out: dict = {}
        batched = []
        for i in slots:
            n_t = len(self.tokens[i])
            n_rem = n_t * self.ratio - self.fs[i].hops_done * self.H
            k = self.pushes[i]
            if n_t >= self.W and k >= 3 and k * self.H + n_rem > 0:
                batched.append((i, n_t, n_rem))
            else:
                out[i] = self.finish(i)
        if len(batched) == 1:
            out[batched[0][0]] = self.finish(batched[0][0])
            return out
        if not batched:
            return out
        tok = np.zeros((self.n, self.P + self.W), np.int32)
        starts = np.zeros(self.n, np.int64)
        n_rems = np.zeros(self.n, np.int64)
        n_valids = np.full(self.n, 2 * self.H, np.int64)
        offs = np.zeros(self.n, np.int64)
        for i, n_t, n_rem in batched:
            tok[i] = np.concatenate([self.fs[i].prompt_tokens, self.tokens[i][n_t - self.W :]])
            starts[i], n_rems[i] = n_t - self.W, n_rem
            n_valids[i] = 2 * self.H + n_rem
            offs[i] = (self.pushes[i] * self.H - 2 * self.H) * self.up
        f_pads = self._flow_window(tok, starts, True, n_rems)
        audio = self._voc_finalize(f_pads, n_valids, offs).float().cpu().numpy()
        for i, _, n_rem in batched:
            # emitted = (k - 1) H, so the window-relative start is always H
            out[i] = audio[i, self.H * self.up : (2 * self.H + n_rem) * self.up]
        return out

    @torch.inference_mode()
    def reset_slot(self, slot: int, prompt_token, prompt_feat, embedding) -> None:
        """Recycle a finished slot for a new session of the same prompt length."""
        prompt_token = np.asarray(prompt_token, np.int32)
        if len(prompt_token) != self.P:
            raise ValueError("slot recycling needs the group's prompt length")
        self.fs[slot] = self._flow_stream(prompt_token, prompt_feat, embedding)
        self.vs[slot] = VocStream(self.t)
        self.tokens[slot] = np.zeros(0, np.int32)
        self.token_offset[slot] = 0
        self.pushes[slot] = 0
        self.tails[slot] = 0.0
        self.carries[slot] = 0.0
        self.pf[slot] = self.fs[slot].prompt_feat[0]
        self.emb[slot] = self.fs[slot].emb[0]


class StreamScheduler:
    """The serving front of batched streaming: sessions are grouped by prompt
    length into BatchedStreamGroups of `width` slots; finished slots are
    recycled.

    open(prompt...) -> handle; feed(handle, tokens) -> that handle's audio
    chunks; close(handle) -> its tail. Chunks that a shared step makes for
    other handles wait in their buffers.

    A feed whose slot has a ready hop elects a leader, which waits up to
    `window_s` (or until every open session has a hop ready) for other
    threads' feeds, then runs the group's steps outside the group lock;
    followers whose hops it took wait for their audio. Closers that meet
    within one window share one finalize (finish_many). An exception in a
    step or a finalize reaches every session that waits on it. `stats`
    counts the batched steps and the rows they advanced: rows / steps is the
    mean batch (1.0 serial, `width` lockstep).
    """

    def __init__(self, tts, width: int = 4, window_s: float = 0.03, prewarm: bool = True):
        self.t = tts
        self.width = width
        self.window_s = window_s
        self.prewarm = prewarm  # the first calls of each new group's shapes, at its first open
        self.groups: dict = {}  # prompt length -> [BatchedStreamGroup]
        self.sessions: dict = {}  # handle -> (group, slot)
        self.buffers: dict = {}  # handle -> [np.ndarray]
        self.free: dict = {}  # prompt length -> [(group, slot)]
        self._seq = 0
        self._lock = threading.Lock()  # the scheduler's dicts only; never held across device work
        self.stats = {"steps": 0, "rows": 0}

    def open(self, prompt_token, prompt_feat, embedding) -> int:
        with self._lock:
            p = len(np.asarray(prompt_token))
            entry = self.free[p].pop() if self.free.get(p) else None
            if entry is None:
                g = BatchedStreamGroup(self.t, [(np.asarray(prompt_token, np.int32), prompt_feat, embedding)]
                                       * self.width)
                g.cond = threading.Condition()
                g.stepping = False  # a thread runs g.step() or a drain alone
                g.collecting = False  # a leader is inside its arrival window
                g.error = None  # the exception of the last failed step, for the sessions it failed
                g.close_pending = {}  # slot -> True: drained, waiting for a cohort finalize
                g.close_results = {}  # slot -> tail audio or exception, set by a finalize leader
                g.owners = {}
                self.groups.setdefault(p, []).append(g)
                for s in range(1, self.width):
                    self.free.setdefault(p, []).append((g, s))
                slot = 0
            else:
                g, slot = entry
            self._seq += 1
            h = self._seq
        with g.cond:
            while g.stepping:
                g.cond.wait()
            if entry is None and self.prewarm:
                g.stepping = True  # other threads' steps wait for the group's first calls
                g.cond.release()
                try:
                    g.prewarm()
                finally:
                    g.cond.acquire()
                    g.stepping = False
                    g.cond.notify_all()
            if entry is not None:
                g.reset_slot(slot, prompt_token, prompt_feat, embedding)
            g.owners[slot] = h
        with self._lock:
            self.sessions[h] = (g, slot)
            self.buffers[h] = []
        return h

    def _distribute(self, g, chunks) -> None:
        for slot, audio in chunks:
            owner = g.owners.get(slot)
            if owner is not None:
                self.buffers.setdefault(owner, []).append(audio)

    def _run_steps(self, g) -> None:
        """Batched steps until no hop is ready. The caller set g.stepping and
        does not hold g.cond: feeds keep appending tokens meanwhile (a step
        reads each slot's tokens once)."""
        all_chunks, steps, err = [], 0, None
        try:
            while True:
                chunks = g.step()
                if not chunks:
                    break
                steps += 1
                all_chunks.extend(chunks)
        except BaseException as e:
            err = e
            raise
        finally:
            with g.cond:
                with self._lock:  # stats is shared by the groups' leaders
                    self.stats["steps"] += steps
                    self.stats["rows"] += len(all_chunks)
                self._distribute(g, all_chunks)
                if err is not None:
                    g.error = err
                g.stepping = False
                g.cond.notify_all()

    def feed(self, handle: int, tokens) -> list:
        with self._lock:
            g, slot = self.sessions[handle]
        with g.cond:
            g.feed(slot, tokens)
            g.cond.notify_all()  # a collecting leader may take this hop too
            while True:
                if g.error is not None:
                    raise g.error
                if not g.hop_ready(slot):
                    break  # no hop of ours is ready (or a step took it): hand out the audio
                if g.stepping or g.collecting:
                    g.cond.wait(0.1)  # a leader will take our hop; look again
                    continue
                g.collecting = True
                if len(g.owners) > 1:
                    deadline = time.monotonic() + self.window_s
                    while sum(g.hop_ready(s) for s in g.owners) < len(g.owners):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        g.cond.wait(remaining)
                g.collecting = False
                g.stepping = True
                g.cond.release()
                try:
                    self._run_steps(g)  # clears g.stepping and notifies
                finally:
                    g.cond.acquire()
            with self._lock:
                out, self.buffers[handle] = self.buffers[handle], []
            return out

    def close(self, handle: int) -> np.ndarray:
        """End a session: its remaining audio and the finalize's tail."""
        with self._lock:
            g, slot = self.sessions.pop(handle)
        try:
            return self._close(g, slot, handle)
        finally:
            with g.cond:
                g.owners.pop(slot, None)
                g.close_pending.pop(slot, None)
                g.close_results.pop(slot, None)
                g.cond.notify_all()
            with self._lock:
                self.buffers.pop(handle, None)
                if g.error is None:  # a group whose step failed takes no new session
                    self.free.setdefault(g.P, []).append((g, slot))

    def _close(self, g, slot: int, handle: int) -> np.ndarray:
        # 1: run the steps (alone) until this slot's whole hops are taken; a finalize takes less than a hop
        if g.hop_ready(slot):
            with g.cond:
                while g.stepping or g.collecting:
                    g.cond.wait(0.1)
                g.stepping = True
            drained, err = [], None
            try:
                while g.hop_ready(slot):
                    before = g.token_offset[slot]
                    drained.extend(g.step())
                    if g.token_offset[slot] == before:
                        break
            except BaseException as e:
                err = e
                raise
            finally:
                with g.cond:
                    self._distribute(g, drained)
                    if err is not None:
                        g.error = err
                    g.stepping = False
                    g.cond.notify_all()
        # 2: closers within one arrival window share one finalize (finish_many), outside the step
        # lock: it reads only the closing slots' state, and a step leaves rows without a hop
        # untouched. A step in flight may still hold this slot's last hop, so it drains first.
        with g.cond:
            while g.stepping:
                g.cond.wait(0.1)
            g.close_pending[slot] = True
            g.cond.notify_all()
            deadline = time.monotonic() + self.window_s
            while slot not in g.close_results:
                if slot not in g.close_pending:  # another leader took this slot into its cohort
                    g.cond.wait(0.05)
                    continue
                remaining = deadline - time.monotonic()
                if len(g.owners) > len(g.close_pending) and remaining > 0:
                    g.cond.wait(remaining)  # more closers may come
                    continue
                cohort = list(g.close_pending)
                g.close_pending.clear()
                g.cond.release()
                try:
                    res = g.finish_many(cohort)
                except Exception as e:  # noqa: BLE001 - every cohort member gets the exception
                    res = {s: e for s in cohort}
                finally:
                    g.cond.acquire()
                g.close_results.update(res)
                g.cond.notify_all()
            tail = g.close_results.pop(slot)
        if isinstance(tail, Exception):
            raise tail
        with self._lock:
            pending = self.buffers.get(handle, [])
        return np.concatenate(pending + [tail]) if pending else tail
