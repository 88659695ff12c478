"""CosyVoice1/2 synthesis: LLM -> flow -> vocoder with the fade and cache
machinery of the reference runtimes (fangyan_tts_tpu/infer/tts_v12.py).

- `CosyVoice2TTS`: the Qwen2LMV2 decode (offline `generate_speech_tokens`,
  streamed `decode_prefill` / `decode_chunk`, a bistream text generator, or
  the continuous batch of infer/llm_batch.LLMScheduler with no silent-run
  suppression); the flow recomputes the whole prefix each hop and is
  trimmed at the token offset; 25-token hops with 3 lookahead tokens, the
  first hop absorbing the prompt's padding to a hop boundary; the HiFT
  mel / source / speech cache (8 mel frames) with a Hamming cross-fade of
  the speech at every join. Every decode step runs the decode-attention
  kernel on the card (ops/decode_attention), so on CUDA it runs bfloat16
  only; the HiFT f0 predictor stays float32.
- `CosyVoiceV1TTS`: the KV-cached TransformerLM decode
  (models/llm_v1_decode.py); streaming in growing token hops (2 s, a
  20-token overlap) with 34-frame Hamming mel fades, the z / mu flow cache
  and the HiFT source / speech cache (20 mel frames). float32, plain
  PyTorch throughout: none of its attention is a kernel in the JAX package.

Buckets follow the JAX package, because the non-causal vocoder's right
edge and the v1 flow's noise depend on the padded lengths: flow tokens pad
to a multiple of 32 (64 for a v2 streaming hop), the v1 mel to a multiple
of 64, and the final vocoder call to a multiple of 32 frames. The additive
NSF noise is read from one Gaussian buffer at the chunk's absolute sample
offset. The v1 flow draws its noise from the TTS object's generator
(`_flow_noise`).
"""

from __future__ import annotations

from typing import Any, Generator

import numpy as np
import torch

from ..config import HiFTConfig, LLMConfig, QwenConfig
from ..data.lm_plan import build_prompt_plan, pad_plans_left, remap_plan_v2
from ..models.flow import fixed_cfm_noise
from ..models.flow_xvec import (
    CausalMaskedDiffWithXvec,
    MaskedDiffWithXvec,
    xvec_flow_inference,
    xvec_flow_inference_v1,
)
from ..models.hift import HiFT, nsf_gauss_buffer
from ..models.llm import Qwen2LMV2, decode_chunk, decode_prefill, generate_speech_tokens
from ..models.llm_v1 import TransformerLM
from ..models.llm_v1_decode import v1_generate_cached
from ..ops.device import exact_fp32, resolve_device
from ..utils.common import fade_in_out
from .bistream import inference_bistream
from .tts import CosyVoice3TTS, _cast_state, _interp_mel, _load, _random_state, _round_up

# the v1 (22.05 kHz) HiFT layout (conf/cosyvoice.yaml)
V1_HIFT = HiFTConfig(
    sampling_rate=22050,
    upsample_rates=(8, 8),
    upsample_kernel_sizes=(16, 16),
    source_resblock_kernel_sizes=(7, 11),
    source_resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
)


def v2_llm_config(qwen: QwenConfig | None = None) -> LLMConfig:
    """The CosyVoice2 LM layout: head = speech_token_size + 3."""
    return LLMConfig(speech_token_size=6561, extra_tokens=3, qwen=qwen or QwenConfig())


def v2_decode_buckets(n_text: int, n_plan: int, stream: bool, min_token_text_ratio: float = 2.0,
                      max_token_text_ratio: float = 20.0) -> tuple[int, int, int, int, int]:
    """The v2 decode's buckets for a text of n_text new tokens and a prompt
    plan of n_plan ids: (tp, max_new, cache_len, min_len, max_len). tp is
    the plan left-padded to a multiple of 64; min / max_len are the ratios
    times n_text. Offline: max_new = max(round_up(max_len, 64), 64) steps
    and a cache of round_up(tp + max_new, 128) slots; streamed: the cache is
    round_up(tp + round_up(max_len, 256), 256) and max_new is max_len."""
    tp = _round_up(n_plan, 64)
    min_len, max_len = int(n_text * min_token_text_ratio), int(n_text * max_token_text_ratio)
    if stream:
        return tp, max_len, _round_up(tp + _round_up(max(max_len, 1), 256), 256), min_len, max_len
    max_new = max(_round_up(max(max_len, 1), 64), 64)
    return tp, max_new, _round_up(tp + max_new, 128), min_len, max_len


class _HiFTVocoderMixin:
    """The non-causal HiFT vocoding of both families: the additive NSF noise
    is indexed at the chunk's absolute sample offset in one long buffer,
    so consecutive streaming chunks draw fresh noise."""

    def _gauss_buf(self) -> torch.Tensor:
        if self._gauss_noise_dev is None:
            c = self.hift_cfg
            buf = nsf_gauss_buffer(c.nb_harmonics + 1, c.stream_noise_seconds * c.sampling_rate)
            self._gauss_noise_dev = torch.from_numpy(buf).to(self.device)
        return self._gauss_noise_dev

    @torch.inference_mode()
    def vocode(self, mel: np.ndarray, cache_source: np.ndarray, noise_mel_base: int = 0,
               pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """mel (L, 80), cache_source (Lc, 1) -> (audio (L*hop,), source
        (L*hop, 1)), float32. noise_mel_base: the absolute mel frame of
        mel[0]; pad_to zero-pads the mel (the final chunk)."""
        true_len = mel.shape[0]
        if pad_to is not None and pad_to > true_len:
            mel = np.pad(mel, ((0, pad_to - true_len), (0, 0)))
        dev, dt = self.device, self.dtype
        hop = self.hift_cfg.total_upsample
        cs = torch.from_numpy(np.ascontiguousarray(cache_source, np.float32)).to(dev, dt)[None]
        audio, source = self.hift(torch.from_numpy(np.ascontiguousarray(mel, np.float32)).to(dev, dt)[None],
                                  cs if cs.shape[1] else None, noise_offset=noise_mel_base * hop,
                                  noise_buf=self._gauss_buf())
        return (audio[0, : true_len * hop].float().cpu().numpy(),
                source[0, : true_len * hop].float().cpu().numpy())

    next_generator = CosyVoice3TTS.next_generator  # one request's own generator, seeded from the object's


class CosyVoice2TTS(_HiFTVocoderMixin):
    """The CosyVoice2Model equivalent. *_params are the port's state_dicts
    (models/from_jax.py makes them from the JAX package's trees); flow_kw
    are CausalMaskedDiffWithXvec's arguments."""

    def __init__(self, llm_cfg: LLMConfig, llm_params: dict, flow_kw: dict, flow_params: dict,
                 hift_cfg: HiFTConfig, hift_params: dict, dtype: torch.dtype = torch.bfloat16, seed: int = 1986,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if dtype != torch.bfloat16:
                raise ValueError("fangyan_tts_torch: the CUDA path runs bfloat16 (its attention kernels take bf16)")
            exact_fp32()
        self.llm_cfg, self.hift_cfg, self.dtype = llm_cfg, hift_cfg, dtype
        self.flow_kw = dict(flow_kw)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.llm = _load(lambda: Qwen2LMV2(llm_cfg, dtype=dtype), llm_params, self.device)
        self.flow = _load(lambda: CausalMaskedDiffWithXvec(**self.flow_kw), _cast_state(flow_params, dtype),
                          self.device)
        self.hift = _load(lambda: HiFT(hift_cfg), _cast_state(hift_params, dtype, ("f0_predictor.",)), self.device)
        self._gauss_noise_dev = None
        self._cfm_noise = None
        self.llm_scheduler = None  # enable_batched_llm: streaming decodes share a continuous batch
        self.token_hop = self.flow.static_chunk_size  # 25
        self.mel_cache_len = 8
        self.source_cache_len = self.mel_cache_len * hift_cfg.total_upsample
        self.speech_window = np.hamming(2 * self.source_cache_len)
        self.token_mel_ratio = self.flow.token_mel_ratio

    @classmethod
    def random_init(cls, llm_cfg: LLMConfig, flow_kw: dict, hift_cfg: HiFTConfig, dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device | None = None, seed: int = 0) -> "CosyVoice2TTS":
        """The three models with random weights made on the device from
        `seed` (benchmarks and smoke runs)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        llm = _random_state(lambda: Qwen2LMV2(llm_cfg), dtype, gen, dev)
        flow = _random_state(lambda: CausalMaskedDiffWithXvec(**flow_kw), dtype, gen, dev)
        hift = _random_state(lambda: HiFT(hift_cfg), dtype, gen, dev, keep_f32=("f0_predictor.",))
        return cls(llm_cfg, llm, flow_kw, flow, hift_cfg, hift, dtype=dtype, device=dev)

    def enable_batched_llm(self, width: int = 4) -> None:
        """Continuous batching of the streaming decodes (v2 plans through
        `_plan`, no silent-run suppression)."""
        from .llm_batch import LLMScheduler

        self.llm_scheduler = LLMScheduler(self, width=width, silent_tokens=())

    # ---- LLM -----------------------------------------------------------------

    def _plan(self, full_text: np.ndarray, prompt_speech: np.ndarray):
        plan = build_prompt_plan(self.llm_cfg, np.asarray(full_text).tolist(), np.asarray(prompt_speech).tolist())
        return remap_plan_v2(self.llm_cfg, plan)

    def _prefill_inputs(self, text, prompt_text, prompt_speech, stream: bool, ratios: dict):
        full_text = np.concatenate([prompt_text, text]).astype(np.int32)
        plan = self._plan(full_text, np.asarray(prompt_speech, np.int32))
        tp, max_new, cache_len, min_len, max_len = v2_decode_buckets(len(text), len(plan.ids), stream, **ratios)
        batch = pad_plans_left([plan], length=tp)
        dev = self.device
        args = (torch.from_numpy(batch["src"]).to(dev), torch.from_numpy(batch["ids"]).to(dev),
                torch.from_numpy(batch["lengths"]).to(dev), torch.tensor([min_len], dtype=torch.int32),
                torch.tensor([max_len], dtype=torch.int32))
        return args, tp, max_new, cache_len, max_len

    @torch.inference_mode()
    def generate_tokens(self, text, prompt_text=np.zeros(0, np.int32), prompt_speech=np.zeros(0, np.int32),
                        **ratios):
        """The whole decode; `ratios` (min_token_text_ratio,
        max_token_text_ratio) default to the reference's 2 and 20."""
        args, _, max_new, cache_len, _ = self._prefill_inputs(text, prompt_text, prompt_speech, False, ratios)
        res = generate_speech_tokens(self.llm, *args, self.next_generator(), max_new_tokens=max_new,
                                     cache_len=cache_len)
        return res.tokens[0, : int(res.num_tokens[0])].cpu().numpy()

    @torch.inference_mode()
    def _stream_tokens(self, text, prompt_text, prompt_speech, chunk_steps: int = 32, **ratios):
        """Yields the newly emitted tokens of each chunk of decode steps."""
        args, tp, _, cache_len, max_len = self._prefill_inputs(text, prompt_text, prompt_speech, True, ratios)
        state = decode_prefill(self.llm, *args, cache_len)
        gen = self.next_generator()
        done = False
        while not done and state.i < max_len:
            state, chunk = decode_chunk(self.llm, state, chunk_steps, tp, gen)
            packed = torch.cat([chunk[0], state.done.all().to(torch.int32)[None]]).cpu().numpy()
            emitted, done = packed[:-1], bool(packed[-1])
            emitted = emitted[emitted >= 0]
            if len(emitted):
                yield emitted.astype(np.int32)

    # ---- flow + vocoder ------------------------------------------------------

    def _noise(self) -> torch.Tensor:
        if self._cfm_noise is None:
            self._cfm_noise = torch.from_numpy(fixed_cfm_noise()).to(self.device)
        return self._cfm_noise

    @torch.inference_mode()
    def token2mel(self, tokens, prompt_tokens, prompt_feat, embedding, token_offset: int, streaming: bool,
                  finalize: bool) -> np.ndarray:
        """The flow over prompt ++ tokens, trimmed at token_offset: (L, 80)
        mel of tokens[token_offset:] (without the lookahead tokens of a
        streaming hop)."""
        full = np.concatenate([np.asarray(prompt_tokens, np.int32), np.asarray(tokens, np.int32)])
        true_len = len(full)
        bucket = _round_up(max(true_len, 1), 32 if finalize else 64)
        full = np.pad(full, (0, bucket - true_len))
        mel1 = prompt_feat.shape[0]
        dev, dt = self.device, self.dtype
        mel = xvec_flow_inference(
            self.flow, torch.from_numpy(full[None]).to(dev), torch.tensor([true_len], dtype=torch.int32, device=dev),
            torch.as_tensor(np.asarray(prompt_feat, np.float32), device=dev).to(dt)[None],
            torch.tensor([mel1], dtype=torch.int32, device=dev),
            torch.as_tensor(np.asarray(embedding, np.float32), device=dev).to(dt)[None],
            streaming=streaming, finalize=finalize, noise=self._noise())
        r = self.token_mel_ratio
        start = mel1 + token_offset * r
        valid = true_len - (0 if finalize else self.flow.pre_lookahead_len)
        n = (valid - len(prompt_tokens) - token_offset) * r
        return mel[0, start: start + n].float().cpu().numpy()

    def token2wav(self, tokens, prompt_tokens, prompt_feat, embedding, token_offset, session: dict,
                  stream: bool = False, finalize: bool = False, speed: float = 1.0) -> np.ndarray:
        """Flow trim, then the HiFT with its mel / source cache and the
        speech cross-fade."""
        mel = self.token2mel(tokens, prompt_tokens, prompt_feat, embedding, token_offset, stream, finalize)
        cache = session.get("hift")
        base = session.get("noise_mel_base", 0)  # the absolute mel frame of mel[0]
        if cache is not None:
            mel = np.concatenate([cache["mel"], mel], axis=0)
            cache_source = cache["source"]
        else:
            cache_source = np.zeros((0, 1), np.float32)
        if not finalize:
            audio, source = self.vocode(mel, cache_source, noise_mel_base=base)
            if cache is not None:
                audio = fade_in_out(audio, cache["speech"], self.speech_window)
            session["hift"] = {"mel": mel[-self.mel_cache_len:], "source": source[-self.source_cache_len:],
                               "speech": audio[-self.source_cache_len:]}
            session["noise_mel_base"] = base + mel.shape[0] - self.mel_cache_len
            return audio[: -self.source_cache_len]
        if speed != 1.0:
            if cache is not None:
                raise ValueError("a speed change needs non-streaming inference")
            mel = _interp_mel(mel, int(mel.shape[0] / speed))
        audio, _ = self.vocode(mel, cache_source, noise_mel_base=base, pad_to=_round_up(mel.shape[0], 32))
        if cache is not None:
            audio = fade_in_out(audio, cache["speech"], self.speech_window)
        return audio

    # ---- public generator ------------------------------------------------------

    def _bistream_tokens(self, text, prompt_text, prompt_speech):
        """The bistream decode in chunks of 8 tokens."""
        buf = []
        for tok in inference_bistream(self.llm, text, np.asarray(prompt_text, np.int32),
                                      np.asarray(prompt_speech, np.int32), generator=self.next_generator()):
            buf.append(tok)
            if len(buf) >= 8:
                yield np.asarray(buf, np.int32)
                buf = []
        if buf:
            yield np.asarray(buf, np.int32)

    def tts(
        self,
        text: np.ndarray = np.zeros(0, np.int32),
        flow_embedding: np.ndarray = np.zeros(192, np.float32),
        llm_embedding=None,
        prompt_text: np.ndarray = np.zeros(0, np.int32),
        llm_prompt_speech_token: np.ndarray = np.zeros(0, np.int32),
        flow_prompt_speech_token: np.ndarray = np.zeros(0, np.int32),
        prompt_speech_feat: np.ndarray = np.zeros((0, 80), np.float32),
        source_speech_token: np.ndarray = np.zeros(0, np.int32),
        stream: bool = False,
        speed: float = 1.0,
        **kwargs: Any,
    ) -> Generator[dict, None, None]:
        """Yields {"tts_speech": float32 wav}: once, or hop by hop with
        stream=True. `text` may be a generator of text-token chunks
        (bistream); source_speech_token given skips the LLM (vc).
        min_token_text_ratio / max_token_text_ratio in kwargs set the decode's
        length bounds (2 and 20 by default, as the reference's)."""
        ratios = {k: kwargs[k] for k in ("min_token_text_ratio", "max_token_text_ratio") if k in kwargs}
        hop = self.token_hop
        la = self.flow.pre_lookahead_len
        flow_embedding = np.asarray(flow_embedding, np.float32).reshape(-1)
        session: dict = {}
        lsched, lh = self.llm_scheduler, None
        if hasattr(text, "__next__"):
            token_iter = self._bistream_tokens(text, prompt_text, llm_prompt_speech_token)
        elif source_speech_token.shape[0] == 0:
            if stream and lsched is not None:
                lh = lsched.open(text, prompt_text, llm_prompt_speech_token, **ratios)
                token_iter = lsched.stream(lh)
            elif stream:
                token_iter = self._stream_tokens(text, prompt_text, llm_prompt_speech_token, **ratios)
            else:
                token_iter = iter([self.generate_tokens(text, prompt_text, llm_prompt_speech_token, **ratios)])
        else:
            token_iter = iter([np.asarray(source_speech_token, np.int32)])
        try:
            if not stream:
                arrs = list(token_iter)
                tokens = np.concatenate(arrs) if arrs else np.zeros(0, np.int32)
                yield {"tts_speech": self.token2wav(tokens, flow_prompt_speech_token, prompt_speech_feat,
                                                    flow_embedding, 0, session, finalize=True, speed=speed)}
                return
            prompt_pad = _round_up(len(flow_prompt_speech_token), hop) - len(flow_prompt_speech_token)
            tokens = np.zeros(0, np.int32)
            llm_done = False
            token_offset = 0
            while True:
                this_hop = hop + prompt_pad if token_offset == 0 else hop
                while len(tokens) - token_offset < this_hop + la and not llm_done:
                    try:
                        tokens = np.concatenate([tokens, next(token_iter)])
                    except StopIteration:
                        llm_done = True
                if len(tokens) - token_offset >= this_hop + la:
                    audio = self.token2wav(tokens[: token_offset + this_hop + la], flow_prompt_speech_token,
                                           prompt_speech_feat, flow_embedding, token_offset, session, stream=True,
                                           finalize=False)
                    token_offset += this_hop
                    yield {"tts_speech": audio}
                elif llm_done:
                    break
            yield {"tts_speech": self.token2wav(tokens, flow_prompt_speech_token, prompt_speech_feat, flow_embedding,
                                                token_offset, session, finalize=True)}
        finally:
            if lh is not None:
                lsched.close(lh)  # a stream that was abandoned, or never started, frees its row


class CosyVoiceV1TTS(_HiFTVocoderMixin):
    """The CosyVoiceModel equivalent, float32. llm_kw / flow_kw are
    TransformerLM's and MaskedDiffWithXvec's arguments; *_params the port's
    state_dicts."""

    def __init__(self, llm_kw: dict, llm_params: dict, flow_kw: dict, flow_params: dict,
                 hift_cfg: HiFTConfig = V1_HIFT, hift_params: dict | None = None, seed: int = 1986,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            exact_fp32()
        self.dtype = torch.float32
        self.llm_kw, self.flow_kw, self.hift_cfg = dict(llm_kw), dict(flow_kw), hift_cfg
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        f32 = torch.float32
        self.llm = _load(lambda: TransformerLM(**self.llm_kw), _cast_state(llm_params, f32), self.device)
        self.flow = _load(lambda: MaskedDiffWithXvec(**self.flow_kw), _cast_state(flow_params, f32), self.device)
        self.hift = _load(lambda: HiFT(hift_cfg), _cast_state(hift_params, f32), self.device)
        self._gauss_noise_dev = None
        fr = self.flow.input_frame_rate
        # the regulator and the flow cache pin the 20-token overlap to 34 mel
        # frames (int(20 / 50 * 22050 / 256)), which holds at 50 Hz tokens only
        if fr != 50:
            raise ValueError(f"CosyVoiceV1TTS supports input_frame_rate 50 only (got {fr}): the flow cache and the "
                             "regulator pin the chunk overlap to 34 mel frames")
        self.token_min_hop = 2 * fr
        self.token_max_hop = 4 * fr
        self.token_overlap = 20
        self.mel_overlap_len = int(self.token_overlap / fr * 22050 / 256)  # 34
        self.mel_window = np.hamming(2 * self.mel_overlap_len)
        self.mel_cache_len = 20
        self.source_cache_len = self.mel_cache_len * hift_cfg.total_upsample
        self.speech_window = np.hamming(2 * self.source_cache_len)

    @classmethod
    def random_init(cls, llm_kw: dict, flow_kw: dict, hift_cfg: HiFTConfig = V1_HIFT,
                    device: str | torch.device | None = None, seed: int = 0) -> "CosyVoiceV1TTS":
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        f32 = torch.float32
        llm = _random_state(lambda: TransformerLM(**llm_kw), f32, gen, dev)
        flow = _random_state(lambda: MaskedDiffWithXvec(**flow_kw), f32, gen, dev)
        hift = _random_state(lambda: HiFT(hift_cfg), f32, gen, dev)
        return cls(llm_kw, llm, flow_kw, flow, hift_cfg, hift, device=dev)

    def _mel_len2(self, n_tokens: int) -> int:
        return int(n_tokens / self.flow.input_frame_rate * 22050 / 256)

    def _flow_noise(self, out_len: int) -> torch.Tensor:
        """The CFM noise of one flow call (1, out_len, 80)."""
        return torch.randn((1, out_len, self.flow.output_size), generator=self.generator, device=self.device)

    @torch.inference_mode()
    def token2mel(self, tokens, prompt_tokens, prompt_feat, embedding, session: dict) -> np.ndarray:
        """The flow over prompt ++ the pending chunk (hop + overlap), with the
        session's z / mu cache: (mel_len2, 80)."""
        tok1, tok2 = len(prompt_tokens), len(tokens)
        mel1 = prompt_feat.shape[0]
        mel2 = self._mel_len2(tok2)
        full = np.concatenate([np.asarray(prompt_tokens, np.int32), np.asarray(tokens, np.int32)])
        full = np.pad(full, (0, _round_up(max(len(full), 1), 32) - len(full)))
        out_len = _round_up(max(mel1 + mel2, 1), 64)
        dev = self.device
        mel, session["flow"] = xvec_flow_inference_v1(
            self.flow, torch.from_numpy(full[None]).to(dev), tok1, tok2,
            torch.as_tensor(np.asarray(prompt_feat, np.float32), device=dev)[None],
            torch.as_tensor(np.asarray(embedding, np.float32), device=dev)[None], mel2,
            cache=session.get("flow"), out_len=out_len, noise=self._flow_noise(out_len))
        return mel[0, mel1: mel1 + mel2].float().cpu().numpy()

    def token2wav(self, tokens, prompt_tokens, prompt_feat, embedding, session: dict, finalize: bool = False,
                  speed: float = 1.0) -> np.ndarray:
        """The mel fade, then the HiFT with its mel / source / speech cache."""
        mel = self.token2mel(tokens, prompt_tokens, prompt_feat, embedding, session)
        if session.get("mel_overlap") is not None:
            mel = fade_in_out(mel.T, session["mel_overlap"].T, self.mel_window).T
        cache = session.get("hift")
        base = session.get("noise_mel_base", 0)  # the absolute mel frame of mel_in[0]
        if cache is not None:
            mel_in = np.concatenate([cache["mel"], mel], axis=0)
            cache_source = cache["source"]
        else:
            mel_in = mel
            cache_source = np.zeros((0, 1), np.float32)
        if not finalize:
            session["mel_overlap"] = mel_in[-self.mel_overlap_len:]
            mel_in = mel_in[: -self.mel_overlap_len]
            audio, source = self.vocode(mel_in, cache_source, noise_mel_base=base)
            if cache is not None:
                audio = fade_in_out(audio, cache["speech"], self.speech_window)
            session["hift"] = {"mel": mel_in[-self.mel_cache_len:], "source": source[-self.source_cache_len:],
                               "speech": audio[-self.source_cache_len:]}
            session["noise_mel_base"] = base + mel_in.shape[0] - self.mel_cache_len
            return audio[: -self.source_cache_len]
        if speed != 1.0:
            if cache is not None:
                raise ValueError("a speed change needs non-streaming inference")
            mel_in = _interp_mel(mel_in, int(mel_in.shape[0] / speed))
        audio, _ = self.vocode(mel_in, cache_source, noise_mel_base=base, pad_to=_round_up(mel_in.shape[0], 32))
        if cache is not None:
            audio = fade_in_out(audio, cache["speech"], self.speech_window)
        return audio

    def tts(
        self,
        text: np.ndarray = np.zeros(0, np.int32),
        flow_embedding: np.ndarray = np.zeros(192, np.float32),
        llm_embedding: np.ndarray = np.zeros(192, np.float32),
        prompt_text: np.ndarray = np.zeros(0, np.int32),
        llm_prompt_speech_token: np.ndarray = np.zeros(0, np.int32),
        flow_prompt_speech_token: np.ndarray = np.zeros(0, np.int32),
        prompt_speech_feat: np.ndarray = np.zeros((0, 80), np.float32),
        source_speech_token: np.ndarray = np.zeros(0, np.int32),
        stream: bool = False,
        speed: float = 1.0,
        **kwargs: Any,
    ) -> Generator[dict, None, None]:
        """As CosyVoice2TTS.tts, without a text generator; the ratios in
        kwargs bound the decode as there."""
        if hasattr(text, "__next__"):
            raise NotImplementedError("bistream generator text is a CosyVoice2/3 feature; the v1 LM decodes a "
                                      "fixed token plan (pass the text as a string)")
        ratios = {k: kwargs[k] for k in ("min_token_text_ratio", "max_token_text_ratio") if k in kwargs}
        session: dict = {}
        flow_embedding = np.asarray(flow_embedding, np.float32).reshape(-1)
        llm_embedding = np.asarray(llm_embedding, np.float32).reshape(-1)

        def gen_tokens():
            full_text = np.concatenate([prompt_text, text]).astype(np.int32)
            for arr in v1_generate_cached(self.llm, full_text, llm_embedding,
                                          prompt_speech=np.asarray(llm_prompt_speech_token, np.int32),
                                          generator=self.next_generator(), prompt_text_len=len(prompt_text),
                                          **ratios):
                yield from arr.tolist()

        token_iter = (iter(np.asarray(source_speech_token, np.int32).tolist()) if source_speech_token.shape[0] > 0
                      else gen_tokens())
        if not stream:
            tokens = np.asarray(list(token_iter), np.int32)
            yield {"tts_speech": self.token2wav(tokens, flow_prompt_speech_token, prompt_speech_feat, flow_embedding,
                                                session, finalize=True, speed=speed)}
            return
        pending: list[int] = []
        hop = self.token_min_hop
        llm_done = False
        while True:
            while len(pending) < hop + self.token_overlap and not llm_done:
                try:
                    pending.append(int(next(token_iter)))
                except StopIteration:
                    llm_done = True
            if len(pending) >= hop + self.token_overlap:
                chunk = np.asarray(pending[: hop + self.token_overlap], np.int32)
                yield {"tts_speech": self.token2wav(chunk, flow_prompt_speech_token, prompt_speech_feat,
                                                    flow_embedding, session)}
                pending = pending[hop:]
                # the reference's stream_scale_factor is 1: the hop stays at token_min_hop
                hop = min(self.token_max_hop, int(hop * 1))
            elif llm_done:
                break
        yield {"tts_speech": self.token2wav(np.asarray(pending, np.int32), flow_prompt_speech_token,
                                            prompt_speech_feat, flow_embedding, session, finalize=True)}
