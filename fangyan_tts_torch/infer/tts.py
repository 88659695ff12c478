"""CosyVoice3 offline synthesis: LLM -> flow -> vocoder
(fangyan_tts_tpu/infer/tts.py, `CosyVoice3TTS` with `tts(stream=False)`,
`batch_synthesize` / `vocode_batch`, and the weight-only quantized modes
`quantize_llm` / `quantize_flow`).

The same stage chain and buckets as the JAX package: the prompt plan is
left-padded to a multiple of 64, the decode bucket is a multiple of 64 and
the cache a multiple of 128; flow tokens are padded to a multiple of 32
(masked inside the flow); the vocoder pads the mel to a multiple of 64.
Parameters of 2 or more dimensions of the flow and the vocoder are cast to
the model dtype, 1-D ones stay float32, and the vocoder's f0 predictor
stays float32 throughout.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Generator

import numpy as np
import torch
import torch.nn as nn

from ..config import CosyVoiceConfig
from ..data.lm_plan import build_prompt_plan, pad_plans_left
from ..models.flow import CausalMaskedDiffWithDiT, cfm_solve, fixed_cfm_noise
from ..models.hift import CausalHiFT
from ..models.llm import CosyVoice3LM, generate_speech_tokens
from ..ops.device import exact_fp32, resolve_device
from ..ops.quant import quantize_dit_state, quantize_qwen_state

# FSQ silent and breath tokens
SILENT_TOKENS = (1, 2, 28, 29, 55, 248, 494, 2241, 2242, 2322, 2323)
MAX_SILENT_RUN = 5


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


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
        prompt_feat: np.ndarray,  # (Lp_mel, 80)
        embedding: np.ndarray,  # (192,)
        device_out: bool = False,
    ) -> np.ndarray | torch.Tensor:
        """Flow inference; returns only the non-prompt mel region (L, 80)."""
        dev, dt = self.device, self.dtype
        full = np.concatenate([np.asarray(prompt_tokens), np.asarray(tokens)]).astype(np.int32)
        true_len = len(full)
        full = np.pad(full, (0, _round_up(max(true_len, 1), 32) - true_len))
        token = torch.from_numpy(full[None]).to(dev)
        token_len = torch.tensor([true_len], dtype=torch.int32, device=dev)
        pf = torch.as_tensor(np.asarray(prompt_feat), device=dev).to(dt)[None]
        pf_len = torch.tensor([pf.shape[1]], dtype=torch.int32, device=dev)
        emb = torch.as_tensor(np.asarray(embedding), device=dev).to(dt)[None]

        mu, spks, conds, mel_len = self.flow.prepare_inference(token, token_len, pf, pf_len, emb)
        l_mel = mu.shape[1]
        if self._cfm_noise is None:
            self._cfm_noise = torch.from_numpy(fixed_cfm_noise()).to(dev, dt)
        z = self._cfm_noise[:, :l_mel, :].expand(mu.shape[0], l_mel, self.cfg.flow.output_size).to(mu.dtype)
        mel = cfm_solve(self.cfg.flow, self.flow.estimator, z, mu, spks, conds, mel_len)
        n_valid = (true_len - len(prompt_tokens)) * self.cfg.token_mel_ratio
        out = mel[0, pf.shape[1] : pf.shape[1] + n_valid]
        return out if device_out else out.float().cpu().numpy()

    @torch.inference_mode()
    def vocode(self, mel) -> np.ndarray:
        """Causal vocoding of (L, 80) mel, zero-padded to a multiple of 64
        frames and cut back to L * 480 samples."""
        true_len = mel.shape[0]
        mel = torch.as_tensor(mel, device=self.device).to(self.dtype)
        mel = torch.nn.functional.pad(mel, (0, 0, 0, _round_up(max(true_len, 1), 64) - true_len))
        audio = self.hift(mel[None])[0][0, : true_len * self.cfg.hift.total_upsample]
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
        if self._cfm_noise is None:
            self._cfm_noise = torch.from_numpy(fixed_cfm_noise()).to(dev, dt)
        z = self._cfm_noise[:, :l_mel, :].expand(b, l_mel, self.cfg.flow.output_size).to(mu.dtype)
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
        """Offline synthesis: yields one {"tts_speech": float32 wav}. Only
        stream=False is in the port so far."""
        if stream:
            raise NotImplementedError("fangyan_tts_torch: streaming synthesis is not ported yet")
        if source_speech_token.shape[0] == 0:
            ratios = {k: kwargs[k] for k in ("min_token_text_ratio", "max_token_text_ratio") if k in kwargs}
            tokens = self.generate_tokens(text, prompt_text, llm_prompt_speech_token, **ratios)
        else:
            tokens = np.asarray(source_speech_token, np.int32)
        # the mel stays on the device and chains straight into the vocoder
        mel = self.token2mel(tokens, flow_prompt_speech_token, prompt_speech_feat, flow_embedding,
                             device_out=(speed == 1.0))
        if speed != 1.0:
            mel = _interp_mel(mel, int(mel.shape[0] / speed))
        yield {"tts_speech": self.vocode(mel)}


def batch_buckets(c, texts, prompt_text, llm_prompt_speech_token, max_token_text_ratio) -> tuple[list, int, int, int]:
    """batch_synthesize's LLM buckets for an LLMConfig `c`: (the prompt
    plans, their left-padded length tp, a multiple of 32; max_new, a
    multiple of 64 and at least 64; the cache length, a multiple of 64)."""
    plans = [build_prompt_plan(c, np.concatenate([prompt_text, t]).astype(np.int32).tolist(),
                               np.asarray(llm_prompt_speech_token, np.int32).tolist()) for t in texts]
    tp = _round_up(max(len(p.ids) for p in plans), 32)
    max_new = max(_round_up(max(int(len(t) * max_token_text_ratio) for t in texts), 64), 64)
    return plans, tp, max_new, _round_up(tp + max_new, 64)


def suppress_silent_runs(tokens: np.ndarray) -> np.ndarray:
    """Drop FSQ silent tokens beyond 5 consecutive."""
    out, run = [], 0
    silent = set(SILENT_TOKENS)
    for t in tokens.tolist():
        if t in silent:
            run += 1
            if run > MAX_SILENT_RUN:
                continue
        else:
            run = 0
        out.append(t)
    return np.asarray(out, np.int32)


def _interp_mel(mel: np.ndarray, new_len: int) -> np.ndarray:
    """F.interpolate(mode='linear') on the time axis of an (L, 80) mel."""
    l = mel.shape[0]
    coords = np.clip((np.arange(new_len) + 0.5) * (l / new_len) - 0.5, 0, l - 1)
    lo = np.floor(coords).astype(int)
    hi = np.minimum(lo + 1, l - 1)
    w = (coords - lo)[:, None]
    return mel[lo] * (1 - w) + mel[hi] * w
