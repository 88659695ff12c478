"""Continuous batching of the streaming LLM decode
(fangyan_tts_tpu/infer/llm_batch.py: `_Group`, `LLMScheduler`).

Sessions whose requests fall in the same (tp, cache_len) bucket share one
`models/llm.ContState` advanced by `decode_chunk_cont`: each row has its own
depth, generator and cache write slot, so sessions join and leave between
chunks and a row's tokens equal its solo decode with the same generator.

Opens that arrive within `prefill_window_s` of each other are prefilled
together at the full group width (padding rows are copies of the first and
are dropped by `cont_insert_rows_masked`), so they enter at the same chunk
boundary. The first session that needs tokens leads: it runs the shared
chunk outside the group lock and hands every row its tokens; the others
drain their buffers. A step's exception reaches every session waiting on
it. A finished, closed or abandoned stream frees its slot.

Every method that touches the group's tensors runs in inference mode, which
is thread-local: any client thread may lead a step.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..data.lm_plan import pad_plans_left
from ..models.llm import cont_empty, cont_insert_rows_masked, decode_chunk_cont, decode_prefill
# open()'s buckets are _stream_tokens' own, so both paths decode at the same shapes
from .tts import SILENT_TOKENS, silent_run_filter, stream_buckets


class _Group:
    """A width-N continuous batch for one (tp, cache_len) bucket."""

    def __init__(self, width: int, tp: int, cache_len: int):
        self.tp = tp
        self.cache_len = cache_len
        self.state = None  # ContState, made from the first prefill
        self.free = list(range(width))
        self.owners: dict[int, int] = {}  # slot -> handle
        self.buffers: dict[int, list] = {}  # handle -> [np.int32 arrays]
        self.finished: set[int] = set()  # handles whose row is done
        self.errors: dict[int, BaseException] = {}  # handle -> the exception of the step that failed it
        self.cond = threading.Condition()
        self.stepping = False
        self.pending: list[dict] = []  # open() requests waiting for a batched prefill
        self.collecting = False  # a prefill leader is inside its arrival window


class LLMScheduler:
    """The serving front of the LLM: h = open(text, ...); for tokens in
    stream(h): ... Thread-safe; sits in front of the StreamScheduler in the
    serving runtimes. `stats` counts the shared chunks ("steps") and the
    sessions they advanced ("rows"): rows / steps is the mean batch."""

    def __init__(self, tts, width: int = 4, chunk_steps: int = 32, prewarm: bool = True,
                 silent_tokens=SILENT_TOKENS, prefill_window_s: float = 0.02):
        self.t = tts
        self.width = width
        self.chunk_steps = chunk_steps
        self.prewarm = prewarm
        self.prefill_window_s = prefill_window_s
        self.silent_tokens = tuple(silent_tokens)
        self.groups: dict[tuple, _Group] = {}
        self.sessions: dict[int, _Group] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self.stats = {"steps": 0, "rows": 0}

    # -- session API --------------------------------------------------------

    def open(self, text_tokens: np.ndarray, prompt_text_tokens: np.ndarray | None = None,
             prompt_speech_tokens: np.ndarray | None = None, min_token_text_ratio: float = 2.0,
             max_token_text_ratio: float = 20.0, generator: torch.Generator | None = None) -> int:
        """Admit a request; returns its handle. `generator` (a fresh one
        from the TTS object's when None) is the row's own random stream."""
        t = self.t
        zeros = np.zeros(0, np.int32)
        prompt_text_tokens = zeros if prompt_text_tokens is None else prompt_text_tokens
        prompt_speech_tokens = zeros if prompt_speech_tokens is None else prompt_speech_tokens
        plan, tp, cache_len, min_len, max_len = stream_buckets(
            t.llm.cfg, text_tokens, prompt_text_tokens, prompt_speech_tokens, min_token_text_ratio,
            max_token_text_ratio)
        if hasattr(t, "_plan"):  # the v2 family: sos / task remapped (same length, same buckets)
            plan = t._plan(np.concatenate([prompt_text_tokens, text_tokens]).astype(np.int32),
                           np.asarray(prompt_speech_tokens, np.int32))
        generator = t.next_generator() if generator is None else generator
        with self._lock:
            g = self.groups.get((tp, cache_len))
            if g is None:
                g = self.groups[(tp, cache_len)] = _Group(self.width, tp, cache_len)
            self._seq += 1
            h = self._seq
        req = {"h": h, "plan": plan, "min": min_len, "max": max_len, "gen": generator, "slot": None, "err": None}
        with g.cond:
            g.pending.append(req)
            g.cond.notify_all()  # a collecting leader may still take this one
            try:
                while req["slot"] is None and req["err"] is None:
                    if g.collecting:
                        g.cond.wait()
                    else:
                        self._lead_prefill(g)  # enters and leaves with g.cond held
            except BaseException:
                self._release(g, h)  # the row went in and the first chunk failed: free it
                raise
        if req["err"] is not None:
            raise req["err"]
        with self._lock:
            self.sessions[h] = g
        return h

    @torch.inference_mode()
    def _lead_prefill(self, g: _Group) -> None:
        """Collect the pending opens of one arrival window, prefill them as
        one full-width batch and insert their rows. The caller holds g.cond
        (held again on return); g.collecting is False."""
        t = self.t
        g.collecting = True
        try:
            # an open on an idle scheduler waits only a short grace: enough for a burst of
            # simultaneous opens to share one prefill, without a full window of dead time at c = 1
            with self._lock:
                alone = not self.sessions
            window = min(0.005, self.prefill_window_s) if alone and len(g.pending) <= 1 else self.prefill_window_s
            deadline = time.monotonic() + window
            while len(g.pending) < len(g.free):
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                g.cond.wait(rem)
            while g.stepping or not g.free:
                g.cond.wait()
            batch = [g.pending.pop(0) for _ in range(min(len(g.pending), len(g.free)))]
            slots = [g.free.pop() for _ in batch]
            g.stepping = True  # the insert needs g.state alone
        except BaseException:
            g.collecting = False
            g.cond.notify_all()
            raise
        fresh = g.state is None
        g.cond.release()
        try:
            # always the full group width: one prefill shape per bucket, whatever the cohort
            k, n = len(batch), self.width
            plans = pad_plans_left([r["plan"] for r in batch] + [batch[0]["plan"]] * (n - k), length=g.tp)
            dev = t.device
            small = decode_prefill(
                t.llm, torch.from_numpy(plans["src"]).to(dev), torch.from_numpy(plans["ids"]).to(dev),
                torch.from_numpy(plans["lengths"]).to(dev),
                torch.tensor([r["min"] for r in batch] + [0] * (n - k), dtype=torch.int32),
                torch.tensor([r["max"] for r in batch] + [0] * (n - k), dtype=torch.int32), g.cache_len)
            if fresh:
                g.state = cont_empty(small, n)
            g.state = cont_insert_rows_masked(g.state, small, slots + [-1] * (n - k),
                                              [r["gen"] for r in batch] + [None] * (n - k))
        except BaseException as e:
            g.cond.acquire()
            g.stepping = False
            g.collecting = False
            g.free.extend(slots)
            for r in batch:
                r["err"] = e
            g.cond.notify_all()
            raise
        g.cond.acquire()
        for r, s in zip(batch, slots):
            g.owners[s] = r["h"]
            g.buffers[r["h"]] = []
            r["slot"] = s
        g.stepping = False
        g.collecting = False
        g.cond.notify_all()
        if fresh and self.prewarm:
            # a first chunk at the new bucket before traffic; its tokens are the inserted rows' own
            # first chunk, and are handed out
            while g.stepping:
                g.cond.wait()
            g.stepping = True
            g.cond.release()
            try:
                self._run_chunk(g)
            finally:
                g.cond.acquire()
                g.stepping = False
                g.cond.notify_all()

    @torch.inference_mode()
    def stream(self, h: int):
        """Yields np.int32 arrays of the session's newly emitted speech
        tokens, silent runs suppressed across chunks (as _stream_tokens
        does); ends when the session's row is done."""
        g = self.sessions[h]
        keep = silent_run_filter(self.silent_tokens)
        try:
            while True:
                lead = False
                with g.cond:
                    while True:
                        if g.buffers.get(h):
                            chunks, g.buffers[h] = g.buffers[h], []
                            break
                        if h in g.errors:
                            raise g.errors.pop(h)
                        if h in g.finished or h not in self.sessions:  # done, or closed from another thread
                            return
                        if not g.stepping:
                            g.stepping = lead = True
                            chunks = []
                            break
                        g.cond.wait()
                if lead:
                    try:
                        self._run_chunk(g)
                    finally:
                        with g.cond:
                            g.stepping = False
                            g.cond.notify_all()
                    continue
                for emitted in chunks:
                    out = [tok for tok in emitted.tolist() if keep(tok)]
                    if out:
                        yield np.asarray(out, np.int32)
        finally:
            # completion, abandonment (GeneratorExit) or an error: free the slot, or a dead row
            # keeps the width; a step in flight holds g.state, so wait it out first
            self.close(h)

    @torch.inference_mode()
    def close(self, h: int) -> None:
        """Free a session's slot (a stream ended or abandoned early)."""
        with self._lock:
            g = self.sessions.get(h)
        if g is None:
            return
        with g.cond:
            self._release(g, h)
        with self._lock:
            self.sessions.pop(h, None)

    @torch.inference_mode()
    def _release(self, g: _Group, h: int) -> None:
        """Free h's row; the caller holds g.cond. A step in flight holds
        g.state, so it is waited out first."""
        while g.stepping:
            g.cond.wait()
        for s, owner in list(g.owners.items()):
            if owner == h:
                del g.owners[s]
                g.state.done[s] = True
                g.free.append(s)
                g.cond.notify_all()
        g.buffers.pop(h, None)
        g.finished.discard(h)
        g.errors.pop(h, None)

    # -- internals ----------------------------------------------------------

    @torch.inference_mode()
    def _run_chunk(self, g: _Group) -> None:
        """One shared chunk, its rows handed out. The caller holds
        g.stepping, not g.cond. An exception is handed to every session of
        the group and raised."""
        try:
            state, toks = decode_chunk_cont(self.t.llm, g.state, self.chunk_steps, g.tp)
            # one device-to-host copy: the tokens and the done flags
            packed = torch.cat([toks, state.done[:, None].to(torch.int32)], dim=1).cpu().numpy()
        except BaseException as e:
            with g.cond:
                for h in g.owners.values():
                    g.errors[h] = e
                g.cond.notify_all()
            raise
        with g.cond:
            g.state = state
            with self._lock:
                self.stats["steps"] += 1
                self.stats["rows"] += len(g.owners)
            for slot, h in g.owners.items():
                row = packed[slot]
                emitted = row[:-1][row[:-1] >= 0]
                if len(emitted):
                    g.buffers.setdefault(h, []).append(emitted.astype(np.int32))
                if row[-1]:
                    g.finished.add(h)
            g.cond.notify_all()
