"""CosyVoice3 offline synthesis: LLM -> flow -> vocoder
(fangyan_tts_tpu/infer/tts.py, `CosyVoice3TTS` with `tts(stream=False)`).

The same stage chain and buckets as the JAX package: the prompt plan is
left-padded to a multiple of 64, the decode bucket is a multiple of 64 and
the cache a multiple of 128; flow tokens are padded to a multiple of 32
(masked inside the flow); the vocoder pads the mel to a multiple of 64.
Parameters of 2 or more dimensions of the flow and the vocoder are cast to
the model dtype, 1-D ones stay float32, and the vocoder's f0 predictor
stays float32 throughout.
"""

from __future__ import annotations

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

# FSQ silent and breath tokens
SILENT_TOKENS = (1, 2, 28, 29, 55, 248, 494, 2241, 2242, 2322, 2323)
MAX_SILENT_RUN = 5


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _cast_state(sd: dict, dtype: torch.dtype, keep_f32: tuple[str, ...] = ()) -> dict:
    """Cast tensors of 2 or more dimensions to `dtype`, except under the
    given key prefixes (kept float32)."""
    out = {}
    for k, v in sd.items():
        if k.startswith(keep_f32):
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
