"""CosyVoice3 synthesis: LLM -> flow -> vocoder
(fangyan_tts_tpu/infer/tts.py, `CosyVoice3TTS` with `tts(stream=False)`
and the solo streaming `tts(stream=True)`, a text generator (bistream) in
either, `batch_synthesize` / `vocode_batch`, and the weight-only quantized
modes `quantize_llm` / `quantize_flow`).

The same stage chain and buckets as the JAX package: the prompt plan is
left-padded to a multiple of 64, the decode bucket is a multiple of 64 and
the cache a multiple of 128; flow tokens are padded to a multiple of 32
(masked inside the flow); the vocoder pads the mel to a multiple of 64.
Parameters of 2 or more dimensions of the flow and the vocoder are cast to
the model dtype, 1-D ones stay float32, and the vocoder's f0 predictor
stays float32 throughout.

Streaming interleaves 32-step `decode_chunk` calls of the LLM with the
constant-cost token2wav hops of infer/stream.py: 25-token hops, the first
one absorbing the prompt's padding to a hop boundary, 3 lookahead tokens a
hop, silent runs suppressed across chunks. A worker thread prefetches the
next decode chunk while a hop runs (`_TokenPrefetcher`); the first hop is
dispatched on the device tokens before their fetch and validated after it
(`_SpecFirstChunk`); hop k's audio is fetched after hop k+1 is dispatched.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import replace
from typing import Any, Generator

import numpy as np
import torch
import torch.nn as nn

from ..config import CosyVoiceConfig
from ..data.lm_plan import build_prompt_plan, pad_plans_left
from ..models.flow import CausalMaskedDiffWithDiT, cfm_solve
from ..models.hift import CausalHiFT
from ..models.llm import CosyVoice3LM, decode_chunk, decode_prefill, generate_speech_tokens
from ..ops.device import exact_fp32, resolve_device
from ..ops.quant import quantize_dit_state, quantize_qwen_state
from .bistream import inference_bistream
from .stream import Token2WavSession, cfm_noise

# FSQ silent and breath tokens
SILENT_TOKENS = (1, 2, 28, 29, 55, 248, 494, 2241, 2242, 2322, 2323)
MAX_SILENT_RUN = 5


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


class _TokenPrefetcher:
    """One-chunk-ahead prefetch of the streaming loop's LLM tokens: a worker
    thread pulls the token iterator, so that the next decode chunk is
    dispatched while the current hop runs token2wav and fetches its audio.
    Values and order are unchanged; only dispatch timing moves.

    The worker holds after the first chunk until release(), so that chunk
    2's decode does not queue ahead of the first hop's token2wav on the one
    stream (first-chunk latency); the consumer releases it once it has the
    first audio, or when it comes back for a second item. The worker enters
    inference mode itself (it is thread-local); its exceptions reach the
    consumer; close() stops it and closes the iterator on the worker's own
    thread."""

    _END = object()

    def __init__(self, it, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._release = threading.Event()
        self._exc: BaseException | None = None
        self._got = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, x) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(x, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        with torch.inference_mode():
            try:
                for i, x in enumerate(self._it):
                    if not self._put(x):
                        break
                    if i == 0:
                        while not (self._release.wait(0.05) or self._stop.is_set()):
                            continue
                        if self._stop.is_set():
                            break
                else:
                    self._put(self._END)
                    return
            except BaseException as e:  # noqa: BLE001 - relayed to the consumer
                self._exc = e
                self._put(self._END)
                return
            # stopped early: close the generator here, on its own thread
            close = getattr(self._it, "close", None)
            if close is not None:
                close()

    def __iter__(self):
        return self

    def __next__(self):
        # the consumer back for item 2+ has dispatched hop 1 (or got no audio from it)
        if self._got >= 1:
            self._release.set()
        self._got += 1
        while True:
            try:
                x = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
        if x is self._END:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return x

    def release(self) -> None:
        self._release.set()

    def close(self) -> None:
        self._stop.set()
        self._release.set()
        self._thread.join(timeout=5.0)
        while not self._q.empty():
            self._q.get_nowait()


class _SpecFirstChunk:
    """The first LLM token chunk with the speculative first hop's audio:
    `tokens` is the chunk after silent-run suppression; `spec_audio` the
    hop's audio if the speculation held (the raw device tokens the flow
    took equal the suppressed stream's), else None, and the consumer resets
    and replays the session."""

    __slots__ = ("tokens", "spec_audio")

    def __init__(self, tokens: np.ndarray, spec_audio):
        self.tokens = tokens
        self.spec_audio = spec_audio


def _cast_state(sd: dict, dtype: torch.dtype, keep_f32: tuple[str, ...] = ()) -> dict:
    """Cast floating tensors of 2 or more dimensions to `dtype`, except under
    the given key prefixes (kept float32). Quantized (int8) kernels stay."""
    out = {}
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = v
        elif k.startswith(keep_f32):
            out[k] = v.float()
        elif v.dim() >= 2:
            out[k] = v.to(dtype)
        else:
            out[k] = v
    return out


def _load(ctor, sd: dict, device: torch.device) -> nn.Module:
    with torch.device("meta"):
        module = ctor()
    module.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True, assign=True)
    return module.requires_grad_(False).eval()


def _random_state(ctor, dtype: torch.dtype, generator: torch.Generator, device: torch.device,
                  keep_f32: tuple[str, ...] = ()) -> dict:
    """Random weights by the JAX package's fast-init rules: N(0, 0.02) for
    tensors of 2 or more dimensions (in `dtype`), ones for 1-D norm weights
    and snake alphas, zeros for biases."""
    with torch.device("meta"):
        skel = ctor()
    out = {}
    for k, v in skel.state_dict().items():
        if v.dim() >= 2:
            w = torch.randn(v.shape, generator=generator, device=device, dtype=torch.float32) * 0.02
            out[k] = w if k.startswith(keep_f32) else w.to(dtype)
        elif k.endswith("bias"):
            out[k] = torch.zeros(v.shape, device=device)
        else:
            out[k] = torch.ones(v.shape, device=device)
    return out


class CosyVoice3TTS:
    def __init__(
        self,
        cfg: CosyVoiceConfig,
        llm_params: dict,
        flow_params: dict,
        hift_params: dict,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 1986,
        device: str | torch.device | None = None,
    ):
        """*_params are the port's state_dicts (models/from_jax.py makes them
        from the JAX package's trees). device None means CUDA."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if dtype != torch.bfloat16:
                raise ValueError("fangyan_tts_torch: the CUDA path runs bfloat16 (its attention kernels take bf16)")
            exact_fp32()
        self.cfg = cfg
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.llm = _load(lambda: CosyVoice3LM(cfg.llm, dtype=dtype), llm_params, self.device)
        self.flow = _load(lambda: CausalMaskedDiffWithDiT(cfg.flow), _cast_state(flow_params, dtype), self.device)
        self.hift = _load(lambda: CausalHiFT(cfg.hift), _cast_state(hift_params, dtype, ("f0_predictor.",)),
                          self.device)
        self._cfm_noise = None
        self._nsf_noise_dev = None
        # the streaming flow's window in target tokens: past it a hop runs on
        # [prompt ++ the last window tokens], a constant cost (infer/stream.py)
        self.stream_window_tokens = 300
        self.flow_kv_stream = True  # the young hops KV-cached (False: the full-prefix solve)
        self.stream_no_speculation = False
        self.stream_no_prefetch = False
        self.stream_stats: dict | None = None  # a dict here collects the per-hop budget (ms lists)
        self.llm_scheduler = None  # enable_batched_llm: streaming decodes share a continuous batch
        self.stream_scheduler = None  # enable_batched_streaming: streams share batched token2wav

    @classmethod
    def random_init(
        cls,
        cfg: CosyVoiceConfig,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
        seed: int = 0,
    ) -> "CosyVoice3TTS":
        """All three models with random weights made on the device from
        `seed` (benchmarks and smoke runs)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        llm = _random_state(lambda: CosyVoice3LM(cfg.llm), dtype, gen, dev)
        flow = _random_state(lambda: CausalMaskedDiffWithDiT(cfg.flow), dtype, gen, dev)
        hift = _random_state(lambda: CausalHiFT(cfg.hift), dtype, gen, dev, keep_f32=("f0_predictor.",))
        return cls(cfg, llm, flow, hift, dtype=dtype, device=dev)

    # ---- weight-only quantization --------------------------------------------

    def quantize_llm(self, int4_mlp: bool = False) -> None:
        """Switch the LLM to weight-only int8 (the MLP kernels to nibble-packed
        int4 with `int4_mlp`), quantized from the weights as the model holds
        them. Returns at once when the LLM is already int8, so int4_mlp=True
        after a plain quantize_llm() changes nothing (as in the JAX package)."""
        if self.cfg.llm.qwen.quant_int8:
            return
        sd = quantize_qwen_state(self.llm.state_dict(), int4_mlp=int4_mlp)
        qwen = replace(self.cfg.llm.qwen, quant_int8=True, quant_int4_mlp=int4_mlp)
        self.cfg = replace(self.cfg, llm=replace(self.cfg.llm, qwen=qwen))
        self.llm = _load(lambda: CosyVoice3LM(self.cfg.llm, dtype=self.dtype), sd, self.device)

    def quantize_flow(self) -> None:
        """Switch the DiT estimator's block kernels to weight-only int8,
        quantized from the flow weights as the model holds them (already in
        the model dtype). Returns at once when the DiT is already int8."""
        if self.cfg.flow.dit.quant_int8:
            return
        sd = quantize_dit_state(self.flow.state_dict())
        self.cfg = replace(self.cfg, flow=replace(self.cfg.flow, dit=replace(self.cfg.flow.dit, quant_int8=True)))
        self.flow = _load(lambda: CausalMaskedDiffWithDiT(self.cfg.flow), sd, self.device)

    def next_generator(self) -> torch.Generator:
        """A generator for one request's own random stream (the JAX package's
        next_key), seeded from the TTS object's generator."""
        seed = int(torch.randint(0, 2**62, (1,), generator=self.generator, device=self.device))
        return torch.Generator(device=self.device).manual_seed(seed)

    def enable_batched_llm(self, width: int = 4) -> None:
        """Continuous batching of the streaming LLM decodes: concurrent
        requests' decode chunks run as one width-N batch with each row's own
        depth, generator and cache slots (infer/llm_batch.LLMScheduler).
        With enable_batched_streaming both serving stages batch."""
        from .llm_batch import LLMScheduler

        self.llm_scheduler = LLMScheduler(self, width=width)

    def enable_batched_streaming(self, width: int = 4) -> None:
        """Concurrent streaming requests' flow and vocoder hops run as
        batched calls (infer/batch_stream.StreamScheduler): sessions are
        grouped by prompt length, slots recycle. Thread-safe, for the
        serving runtimes."""
        from .batch_stream import StreamScheduler

        self.stream_scheduler = StreamScheduler(self, width=width)

    def warmup_streaming(self, prompt_token_len: int = 0, n_tokens: int | None = None) -> None:
        """Run a silent stream of one prompt length on the vc route through
        the streaming steps (the young hops, the window hops, the vocoder
        pushes and the window finalize), so that a served voice's first
        request pays no first-use cost."""
        hop = self.cfg.chunk_size
        n = n_tokens if n_tokens is not None else self.stream_window_tokens + 3 * hop
        ptok = np.zeros(prompt_token_len, np.int32)
        pfeat = np.zeros((prompt_token_len * self.cfg.token_mel_ratio, 80), np.float32)
        for _ in self.tts(text=np.zeros(0, np.int32), flow_embedding=np.zeros(192, np.float32),
                          flow_prompt_speech_token=ptok, prompt_speech_feat=pfeat,
                          source_speech_token=np.zeros(n, np.int32), stream=True):
            pass

    # ---- stage 1: AR token generation ---------------------------------------

    @torch.inference_mode()
    def generate_tokens(
        self,
        text_tokens: np.ndarray,
        prompt_text_tokens: np.ndarray = np.zeros(0, np.int32),
        prompt_speech_tokens: np.ndarray = np.zeros(0, np.int32),
        min_token_text_ratio: float = 2.0,
        max_token_text_ratio: float = 20.0,
    ) -> np.ndarray:
        """One utterance -> speech tokens. The text is prompt_text ++ text;
        min/max lengths come from the new text's length."""
        c = self.cfg.llm
        full_text = np.concatenate([prompt_text_tokens, text_tokens]).astype(np.int32)
        plan = build_prompt_plan(c, full_text.tolist(), np.asarray(prompt_speech_tokens).tolist())
        tp = _round_up(len(plan.ids), 64)
        batch = pad_plans_left([plan], length=tp)
        min_len = int(len(text_tokens) * min_token_text_ratio)
        max_len = int(len(text_tokens) * max_token_text_ratio)
        max_new = max(_round_up(max(max_len, 1), 64), 64)
        cache_len = _round_up(tp + max_new, 128)

        dev = self.device
        res = generate_speech_tokens(
            self.llm,
            torch.from_numpy(batch["src"]).to(dev), torch.from_numpy(batch["ids"]).to(dev),
            torch.from_numpy(batch["lengths"]).to(dev),
            torch.tensor([min_len], dtype=torch.int32), torch.tensor([max_len], dtype=torch.int32),
            self.generator, max_new_tokens=max_new, cache_len=cache_len,
        )
        n = int(res.num_tokens[0])
        return suppress_silent_runs(res.tokens[0, :n].cpu().numpy())

    # ---- stage 2+3: token -> wav --------------------------------------------

    @torch.inference_mode()
    def token2mel(
        self,
        tokens: np.ndarray,
        prompt_tokens: np.ndarray,
        prompt_feat: np.ndarray,  # (Lp_mel, 80), numpy or a tensor
        embedding: np.ndarray,  # (192,), numpy or a tensor
        streaming: bool = False,
        finalize: bool = True,
        device_out: bool = False,
    ) -> np.ndarray | torch.Tensor:
        """Flow inference; returns only the non-prompt mel region (L, 80).
        streaming: the chunk-causal mask. finalize=False: a streaming step,
        the last pre_lookahead_len tokens are lookahead and the tokens are
        not padded to a bucket (they come on the hop grid already)."""
        dev, dt = self.device, self.dtype
        full = np.concatenate([np.asarray(prompt_tokens), np.asarray(tokens)]).astype(np.int32)
        true_len = len(full)
        if finalize:
            full = np.pad(full, (0, _round_up(max(true_len, 1), 32) - true_len))
        token = torch.from_numpy(full[None]).to(dev)
        token_len = torch.tensor([true_len], dtype=torch.int32, device=dev)
        pf = torch.as_tensor(prompt_feat, device=dev).to(dt)[None]
        pf_len = torch.tensor([pf.shape[1]], dtype=torch.int32, device=dev)
        emb = torch.as_tensor(embedding, device=dev).to(dt)[None]

        mu, spks, conds, mel_len = self.flow.prepare_inference(token, token_len, pf, pf_len, emb, finalize=finalize)
        l_mel = mu.shape[1]
        z = cfm_noise(self)[:, :l_mel, :].expand(mu.shape[0], l_mel, self.cfg.flow.output_size).to(mu.dtype)
        mel = cfm_solve(self.cfg.flow, self.flow.estimator, z, mu, spks, conds, mel_len, streaming=streaming)
        n_valid = (true_len - len(prompt_tokens)) * self.cfg.token_mel_ratio
        out = mel[0, pf.shape[1] : pf.shape[1] + n_valid]
        return out if device_out else out.float().cpu().numpy()

    @torch.inference_mode()
    def vocode(self, mel, finalize: bool = True) -> np.ndarray:
        """Causal vocoding of (L, 80) mel, zero-padded to a multiple of 64
        frames and cut back to L * 480 samples; finalize=False is a
        streaming step on the mel as it is (its last frames lookahead)."""
        true_len = mel.shape[0]
        mel = torch.as_tensor(mel, device=self.device).to(self.dtype)
        if finalize:
            mel = torch.nn.functional.pad(mel, (0, 0, 0, _round_up(max(true_len, 1), 64) - true_len))
        audio = self.hift(mel[None], finalize=finalize)[0][0]
        if finalize:
            audio = audio[: true_len * self.cfg.hift.total_upsample]
        return audio.float().cpu().numpy()

    # ---- batched offline synthesis ------------------------------------------

    @torch.inference_mode()
    def batch_synthesize(
        self,
        texts: list[np.ndarray],
        flow_embedding: np.ndarray,  # (192,) or (B, 192)
        prompt_text: np.ndarray = np.zeros(0, np.int32),
        llm_prompt_speech_token: np.ndarray = np.zeros(0, np.int32),
        flow_prompt_speech_token: np.ndarray = np.zeros(0, np.int32),
        prompt_speech_feat: np.ndarray = np.zeros((0, 80), np.float32),
        min_token_text_ratio: float = 2.0,
        max_token_text_ratio: float = 20.0,
    ) -> list[np.ndarray]:
        """B utterances through the three stages as one batch (the
        dataset-generation path), sharing one voice prompt. Returns B wavs,
        each cut to its own tokens. Buckets as the JAX package's: the prompt
        plans left-padded to a multiple of 32, the decode bucket a multiple of
        64 and the cache a multiple of 64; flow tokens padded to a multiple of
        64; the vocoder takes the whole padded mel."""
        fp = np.asarray(flow_prompt_speech_token, np.int32)
        pf = np.asarray(prompt_speech_feat, np.float32)
        all_tokens, counts = self._batch_tokens(texts, prompt_text, llm_prompt_speech_token,
                                                min_token_text_ratio, max_token_text_ratio)
        mel, token_len = self._batch_token2mel(all_tokens, counts, fp, pf, flow_embedding)
        audio = self.vocode_batch(mel)  # the device mel chains in; one audio fetch
        ratio = self.cfg.token_mel_ratio
        hop = self.cfg.hift.total_upsample
        # the output mel's prompt region is len(fp) * ratio frames, and the
        # conditioning layout needs prompt_feat to be exactly that long
        assert pf.shape[0] == len(fp) * ratio, (
            f"prompt_speech_feat has {pf.shape[0]} frames; expected "
            f"{len(fp) * ratio} (= {len(fp)} prompt tokens x ratio {ratio})"
        )
        start = len(fp) * ratio * hop
        return [audio[i, start : start + (token_len[i] - len(fp)) * ratio * hop] for i in range(len(texts))]

    @torch.inference_mode()
    def _batch_tokens(self, texts, prompt_text, llm_prompt_speech_token, min_token_text_ratio,
                      max_token_text_ratio) -> tuple[np.ndarray, np.ndarray]:
        """Stage 1 of batch_synthesize: (B, max_new) tokens and (B,) counts."""
        plans, tp, max_new, cache_len = batch_buckets(self.cfg.llm, texts, prompt_text, llm_prompt_speech_token,
                                                      max_token_text_ratio)
        batch = pad_plans_left(plans, length=tp)
        min_lens = np.asarray([int(len(t) * min_token_text_ratio) for t in texts], np.int32)
        max_lens = np.asarray([int(len(t) * max_token_text_ratio) for t in texts], np.int32)
        dev = self.device
        res = generate_speech_tokens(
            self.llm,
            torch.from_numpy(batch["src"]).to(dev), torch.from_numpy(batch["ids"]).to(dev),
            torch.from_numpy(batch["lengths"]).to(dev), torch.from_numpy(min_lens), torch.from_numpy(max_lens),
            self.generator, max_new_tokens=max_new, cache_len=cache_len,
        )
        return res.tokens.cpu().numpy(), res.num_tokens.cpu().numpy()

    @torch.inference_mode()
    def _batch_token2mel(self, all_tokens: np.ndarray, counts: np.ndarray, fp: np.ndarray, pf: np.ndarray,
                         flow_embedding: np.ndarray) -> tuple[torch.Tensor, np.ndarray]:
        """Stage 2 of batch_synthesize: each row's tokens (silent runs
        suppressed) after the flow prompt tokens, padded to a common bucket,
        through one batched flow solve. Returns the device mel (B, L, 80)
        and the rows' token lengths, prompt included."""
        b = len(counts)
        lt_max = _round_up(int(counts.max()) + len(fp), 64)
        token = np.zeros((b, lt_max), np.int32)
        token_len = np.zeros((b,), np.int32)
        for i in range(b):
            row = np.concatenate([fp, suppress_silent_runs(all_tokens[i, : counts[i]])])
            token[i, : len(row)] = row
            token_len[i] = len(row)
        emb = np.asarray(flow_embedding, np.float32)
        if emb.ndim == 1:
            emb = np.broadcast_to(emb, (b, 192))
        pf_b = np.broadcast_to(pf[None], (b, *pf.shape)) if pf.ndim == 2 else pf

        dev, dt = self.device, self.dtype
        mu, spks, conds, mel_len = self.flow.prepare_inference(
            torch.from_numpy(token).to(dev), torch.from_numpy(token_len).to(dev),
            torch.tensor(pf_b, device=dev).to(dt),
            torch.full((b,), pf.shape[0], dtype=torch.int32, device=dev),
            torch.tensor(emb, device=dev).to(dt),
        )
        l_mel = mu.shape[1]
        z = cfm_noise(self)[:, :l_mel, :].expand(b, l_mel, self.cfg.flow.output_size).to(mu.dtype)
        return cfm_solve(self.cfg.flow, self.flow.estimator, z, mu, spks, conds, mel_len), token_len

    @torch.inference_mode()
    def vocode_batch(self, mel) -> np.ndarray:
        """Causal vocoding of a (B, L, 80) mel as it is (no padding): (B,
        L * 480) float32."""
        mel = torch.as_tensor(mel, device=self.device).to(self.dtype)
        return self.hift(mel)[0].float().cpu().numpy()

    # ---- public generator API -----------------------------------------------

    def tts(
        self,
        text: np.ndarray = np.zeros(0, np.int32),
        flow_embedding: np.ndarray = np.zeros(192, np.float32),
        llm_embedding: np.ndarray | None = None,
        prompt_text: np.ndarray = np.zeros(0, np.int32),
        llm_prompt_speech_token: np.ndarray = np.zeros(0, np.int32),
        flow_prompt_speech_token: np.ndarray = np.zeros(0, np.int32),
        prompt_speech_feat: np.ndarray = np.zeros((0, 80), np.float32),
        source_speech_token: np.ndarray = np.zeros(0, np.int32),
        stream: bool = False,
        speed: float = 1.0,
        **kwargs: Any,
    ) -> Generator[dict, None, None]:
        """Yields {"tts_speech": float32 wav}: once (stream=False), or chunk by
        chunk (stream=True). `text` may be a generator of text-token chunks
        (bistream); source_speech_token given skips the LLM (the vc route)."""
        ratios = {k: kwargs[k] for k in ("min_token_text_ratio", "max_token_text_ratio") if k in kwargs}
        if not stream:
            yield {"tts_speech": self._tts_offline(text, flow_embedding, prompt_text, llm_prompt_speech_token,
                                                   flow_prompt_speech_token, prompt_speech_feat,
                                                   source_speech_token, speed, ratios)}
            return
        yield from self._tts_stream(text, flow_embedding, prompt_text, llm_prompt_speech_token,
                                    flow_prompt_speech_token, prompt_speech_feat, source_speech_token, ratios)

    def _tts_offline(self, text, flow_embedding, prompt_text, llm_prompt_speech_token, flow_prompt_speech_token,
                     prompt_speech_feat, source_speech_token, speed, ratios) -> np.ndarray:
        if hasattr(text, "__next__"):  # bistream text source, offline output
            tokens = suppress_silent_runs(np.asarray(list(inference_bistream(
                self.llm, text, prompt_text, llm_prompt_speech_token, generator=self.generator)), np.int32))
        elif source_speech_token.shape[0] == 0:
            tokens = self.generate_tokens(text, prompt_text, llm_prompt_speech_token, **ratios)
        else:
            tokens = np.asarray(source_speech_token, np.int32)
        # the mel stays on the device and chains straight into the vocoder
        mel = self.token2mel(tokens, flow_prompt_speech_token, prompt_speech_feat, flow_embedding,
                             device_out=(speed == 1.0))
        if speed != 1.0:
            mel = _interp_mel(mel, int(mel.shape[0] / speed))
        return self.vocode(mel)

    def _tts_stream(self, text, flow_embedding, prompt_text, llm_prompt_speech_token, flow_prompt_speech_token,
                    prompt_speech_feat, source_speech_token, ratios):
        sched, lsched = self.stream_scheduler, self.llm_scheduler
        # the solo session comes first, so that the LLM side can speculate its first hop
        sess = None if sched is not None else Token2WavSession(self, flow_prompt_speech_token, prompt_speech_feat,
                                                               flow_embedding)
        bistream = hasattr(text, "__next__")
        llm = bistream or source_speech_token.shape[0] == 0
        lh = None
        if bistream:
            token_iter = self._bistream_tokens(text, prompt_text, llm_prompt_speech_token)
        elif llm and lsched is not None:  # the decode joins the continuous batch
            lh = lsched.open(text, prompt_text, llm_prompt_speech_token, **ratios)
            token_iter = lsched.stream(lh)
        elif llm:
            spec = None if self.stream_no_speculation or sess is None else sess.speculate_first
            token_iter = self._stream_tokens(text, prompt_text, llm_prompt_speech_token, first_hop_spec=spec,
                                             spec_n=sess.first_hop_tokens if spec is not None else 0, **ratios)
        else:
            token_iter = iter([np.asarray(source_speech_token, np.int32)])
        prefetch = None
        if llm and not self.stream_no_prefetch:
            token_iter = prefetch = _TokenPrefetcher(token_iter)
        try:
            if sched is not None:
                yield from self._scheduled_stream(sched, token_iter, prefetch, flow_prompt_speech_token,
                                                  prompt_speech_feat, flow_embedding)
            else:
                yield from self._solo_stream(sess, token_iter, prefetch)
        finally:
            if prefetch is not None:
                prefetch.close()
            if lh is not None:
                lsched.close(lh)  # a stream that was abandoned, or never started, frees its row

    @staticmethod
    def _scheduled_stream(sched, token_iter, prefetch, flow_prompt_speech_token, prompt_speech_feat, flow_embedding):
        """Token2wav through the StreamScheduler: each token chunk is fed, the
        hops its feed made ready come back (batched with other sessions'),
        and close() returns the tail; a consumer that goes away frees the
        slot."""
        h = sched.open(flow_prompt_speech_token, prompt_speech_feat, flow_embedding)
        try:
            for tok_chunk in token_iter:
                for audio in sched.feed(h, tok_chunk):
                    if prefetch is not None:
                        prefetch.release()  # first audio in hand
                    yield {"tts_speech": audio}
        except BaseException:
            sched.close(h)
            raise
        yield {"tts_speech": sched.close(h)}

    def _solo_stream(self, sess, token_iter, prefetch):
        # One-hop audio pipeline: hop k's audio is fetched only after hop k+1
        # is dispatched, so its copy rides under device work; the first chunk
        # is fetched at once. stream_stats (a dict, opt-in) collects the
        # per-hop budget: decode wait, token2wav dispatch, fetch, finalize.
        stats = self.stream_stats
        clock = time.perf_counter
        note = (lambda k, t0: stats.setdefault(k, []).append((clock() - t0) * 1e3)) if stats is not None else None
        pending = None
        emitted = 0
        it = iter(token_iter)
        while True:
            t0 = clock()
            try:
                tok_chunk = next(it)
            except StopIteration:
                break
            if note:
                note("decode_wait_ms", t0)
            t0 = clock()
            if isinstance(tok_chunk, _SpecFirstChunk):
                if tok_chunk.spec_audio is not None:  # the speculation held
                    devs = [tok_chunk.spec_audio] + sess.commit_first(tok_chunk.tokens)
                else:  # suppression (or an early stop) changed the first window: replay
                    sess.reset()
                    devs = sess.push_dev(tok_chunk.tokens)
            else:
                devs = sess.push_dev(tok_chunk)
            if note:
                note("t2w_dispatch_ms", t0)
            for dev in devs:
                t0 = clock()
                if emitted == 0:
                    if prefetch is not None:
                        prefetch.release()  # first audio in hand
                    yield {"tts_speech": dev.numpy()}
                else:
                    if pending is not None:
                        yield {"tts_speech": pending.numpy()}
                    pending = dev
                if note:
                    note("fetch_ms", t0)
                emitted += 1
        t0 = clock()
        # the finalize is dispatched before the last pending fetch, so it runs under it
        fin = sess.finish_dev()
        if pending is not None:
            yield {"tts_speech": pending.numpy()}
        yield {"tts_speech": fin()}
        if note:
            note("finalize_ms", t0)

    @torch.inference_mode()
    def _bistream_tokens(self, text, prompt_text, llm_prompt_speech_token):
        """The bistream decode in chunks of 8 tokens, silent runs suppressed
        across chunks (as stream=False suppresses them)."""
        buf, keep = [], silent_run_filter()
        for tok in inference_bistream(self.llm, text, prompt_text, llm_prompt_speech_token,
                                      generator=self.generator):
            if not keep(tok):
                continue
            buf.append(tok)
            if len(buf) >= 8:
                yield np.asarray(buf, np.int32)
                buf = []
        if buf:
            yield np.asarray(buf, np.int32)

    @torch.inference_mode()
    def _stream_tokens(self, text_tokens, prompt_text_tokens, prompt_speech_tokens, chunk_steps: int = 32,
                       min_token_text_ratio: float = 2.0, max_token_text_ratio: float = 20.0, first_hop_spec=None,
                       spec_n: int = 0):
        """The incremental LLM decode: yields the newly emitted speech tokens
        of each decode_chunk call (silent runs suppressed across chunks).
        With `first_hop_spec` (Token2WavSession.speculate_first) and a first
        hop that fits in one chunk, the first flow + vocoder hop is
        dispatched on the device tokens before their fetch, and the first
        item is a _SpecFirstChunk with the validated (or rejected) audio."""
        plan, tp, cache_len, min_len, max_len = stream_buckets(
            self.cfg.llm, text_tokens, prompt_text_tokens, prompt_speech_tokens, min_token_text_ratio,
            max_token_text_ratio)
        batch = pad_plans_left([plan], length=tp)
        dev = self.device
        state = decode_prefill(
            self.llm, torch.from_numpy(batch["src"]).to(dev), torch.from_numpy(batch["ids"]).to(dev),
            torch.from_numpy(batch["lengths"]).to(dev), torch.tensor([min_len], dtype=torch.int32),
            torch.tensor([max_len], dtype=torch.int32), cache_len)
        keep = silent_run_filter()
        done = False
        first = first_hop_spec is not None and 0 < spec_n <= chunk_steps
        while not done and state.i < max_len:
            state, chunk = decode_chunk(self.llm, state, chunk_steps, tp, self.generator)
            spec_audio = first_hop_spec(chunk[0]) if first else None  # overlaps the fetch below
            # tokens and the done flag in one device-to-host copy
            packed = torch.cat([chunk[0], state.done.all().to(torch.int32)[None]]).cpu().numpy()
            emitted, done = packed[:-1], bool(packed[-1])
            emitted = emitted[emitted >= 0]
            out = [t for t in emitted.tolist() if keep(t)]
            if first:
                # it holds iff suppression dropped nothing in the speculation window and
                # the LLM emitted at least spec_n tokens
                ok = spec_audio is not None and len(out) >= spec_n and np.array_equal(out[:spec_n], emitted[:spec_n])
                yield _SpecFirstChunk(np.asarray(out, np.int32), spec_audio if ok else None)
                first = False
            elif out:
                yield np.asarray(out, np.int32)


def batch_buckets(c, texts, prompt_text, llm_prompt_speech_token, max_token_text_ratio) -> tuple[list, int, int, int]:
    """batch_synthesize's LLM buckets for an LLMConfig `c`: (the prompt
    plans, their left-padded length tp, a multiple of 32; max_new, a
    multiple of 64 and at least 64; the cache length, a multiple of 64)."""
    plans = [build_prompt_plan(c, np.concatenate([prompt_text, t]).astype(np.int32).tolist(),
                               np.asarray(llm_prompt_speech_token, np.int32).tolist()) for t in texts]
    tp = _round_up(max(len(p.ids) for p in plans), 32)
    max_new = max(_round_up(max(int(len(t) * max_token_text_ratio) for t in texts), 64), 64)
    return plans, tp, max_new, _round_up(tp + max_new, 64)


def stream_buckets(c, text_tokens, prompt_text_tokens, prompt_speech_tokens, min_token_text_ratio: float = 2.0,
                   max_token_text_ratio: float = 20.0) -> tuple[Any, int, int, int, int]:
    """The streaming decode's buckets for an LLMConfig `c`: (the prompt plan
    of prompt_text ++ text, its left-padded length tp = a multiple of 64,
    the cache length round_up(tp + round_up(max_len, 256), 256), min_len,
    max_len), the lengths from the new text's."""
    full_text = np.concatenate([prompt_text_tokens, text_tokens]).astype(np.int32)
    plan = build_prompt_plan(c, full_text.tolist(), np.asarray(prompt_speech_tokens, np.int32).tolist())
    tp = _round_up(len(plan.ids), 64)
    min_len = int(len(text_tokens) * min_token_text_ratio)
    max_len = int(len(text_tokens) * max_token_text_ratio)
    return plan, tp, _round_up(tp + _round_up(max(max_len, 1), 256), 256), min_len, max_len


def silent_run_filter(silent_tokens=SILENT_TOKENS):
    """A token filter that drops FSQ silent tokens beyond MAX_SILENT_RUN
    consecutive ones; the run it counts carries over from call to call (a
    stream's chunks)."""
    silent, run = set(silent_tokens), 0

    def keep(t: int) -> bool:
        nonlocal run
        run = run + 1 if t in silent else 0
        return run <= MAX_SILENT_RUN

    return keep


def suppress_silent_runs(tokens: np.ndarray) -> np.ndarray:
    """Drop FSQ silent tokens beyond 5 consecutive."""
    keep = silent_run_filter()
    return np.asarray([t for t in tokens.tolist() if keep(t)], np.int32)


def _interp_mel(mel: np.ndarray, new_len: int) -> np.ndarray:
    """F.interpolate(mode='linear') on the time axis of an (L, 80) mel."""
    l = mel.shape[0]
    coords = np.clip((np.arange(new_len) + 0.5) * (l / new_len) - 0.5, 0, l - 1)
    lo = np.floor(coords).astype(int)
    hi = np.minimum(lo + 1, l - 1)
    w = (coords - lo)[:, None]
    return mel[lo] * (1 - w) + mel[hi] * w
