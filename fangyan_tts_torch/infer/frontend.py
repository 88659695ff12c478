"""Feature and prompt frontend, the CosyVoiceFrontEnd equivalent
(fangyan_tts_tpu/infer/frontend.py).

Text: normalization (infer/textnorm.py) and the tokenizer. Prompt audio:
CAM++ on a mean-subtracted kaldi fbank (the x-vector), the S3 tokenizer on
the whisper log-mel (the prompt speech tokens) and the 24 kHz matcha mel
(the prompt feature). Prompts are zero-padded to the 3 / 5 / 10 / 15 / 30 s
buckets, so each bucket is one set of shapes. The spk2info dict keeps the
reference's layout, so a `spk2info.pt` saved by either package loads in the
other.

`Frontend`, `make_campplus_fn` and `make_s3_fn` run on CUDA unless the
caller passes device="cpu".
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..config import CosyVoiceConfig
from ..data.audio import load_audio, resample_poly
from ..ops.device import exact_fp32, resolve_device
from ..ops.mel import kaldi_fbank, matcha_mel, whisper_logmel
from .textnorm import text_normalize as _text_normalize
from .tts import _cast_state, _load

_PROMPT_BUCKETS_SEC = (3, 5, 10, 15, 30)


def _pad_bucket(audio: np.ndarray, sr: int) -> tuple[np.ndarray, int]:
    """Zero-pad to the smallest bucket that holds the audio (longer audio is
    cut to the last); returns (padded, true length)."""
    n = len(audio)
    for b in _PROMPT_BUCKETS_SEC:
        if n <= b * sr:
            out = np.zeros((b * sr,), np.float32)
            out[:n] = audio
            return out, n
    return audio[: _PROMPT_BUCKETS_SEC[-1] * sr], _PROMPT_BUCKETS_SEC[-1] * sr


class Frontend:
    def __init__(
        self,
        tokenizer,
        cfg: CosyVoiceConfig,
        campplus_fn: Callable | None = None,  # (fbank (1, T, 80)) -> (1, 192)
        s3_fn: Callable | None = None,  # (mel (1, 128, T), len (1,)) -> (codes, code_len)
        spk2info: str | Path = "",
        allowed_special: str = "all",
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            exact_fp32()
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.campplus_fn = campplus_fn
        self.s3_fn = s3_fn
        self.allowed_special = allowed_special
        self.spk2info: dict[str, dict] = {}
        self._spk2info_path = str(spk2info)
        if spk2info and os.path.exists(spk2info):
            raw = torch.load(spk2info, map_location="cpu", weights_only=False)
            self.spk2info = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in raw.items()}

    def _wave(self, audio: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(audio, np.float32))[None].to(self.device)

    # ---- primitives ---------------------------------------------------------

    def extract_text_token(self, text):
        """str -> token ids; a text generator maps to a generator of each
        piece's token ids."""
        if hasattr(text, "__next__"):
            return (np.asarray(self.tokenizer.encode(piece, allowed_special=self.allowed_special), np.int32)
                    for piece in text)
        return np.asarray(self.tokenizer.encode(text, allowed_special=self.allowed_special), np.int32)

    @torch.inference_mode()
    def extract_speech_token(self, wav_16k: np.ndarray) -> np.ndarray:
        """25 Hz prompt speech tokens of at most 30 s of 16 kHz audio."""
        assert len(wav_16k) / 16000 <= 30, "do not support extract speech token for audio longer than 30s"
        if self.s3_fn is None:
            raise RuntimeError("no S3 tokenizer loaded")
        padded, n = _pad_bucket(wav_16k, 16000)
        mel = whisper_logmel(self._wave(padded))
        codes, code_len = self.s3_fn(mel, torch.tensor([n // 160], dtype=torch.int32, device=self.device))
        return codes[0, : int(code_len[0])].cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def extract_spk_embedding(self, wav_16k: np.ndarray) -> np.ndarray:
        """192-d x-vector: the fbank mean is taken over the valid frames only,
        and CAM++ runs over the whole bucket."""
        if self.campplus_fn is None:
            raise RuntimeError("no CAM++ model loaded")
        padded, n = _pad_bucket(wav_16k, 16000)
        feat = kaldi_fbank(self._wave(padded))
        frames = max((n - 400) // 160 + 1, 1)
        mask = (torch.arange(feat.shape[1], device=self.device) < frames)[None, :, None].to(feat.dtype)
        mean = (feat * mask).sum(dim=1, keepdim=True) / frames
        feat = (feat - mean) * mask
        return self.campplus_fn(feat)[0].float().cpu().numpy()

    @torch.inference_mode()
    def extract_speech_feat(self, wav: np.ndarray) -> np.ndarray:
        """(T, 80) mel at the model's sample rate, with cfg.mel's parameters."""
        m = self.cfg.mel
        n = len(wav) // m.hop_size * m.hop_size
        mel = matcha_mel(
            self._wave(wav[:n]), n_fft=m.n_fft, num_mels=m.num_mels,
            sampling_rate=m.sampling_rate, hop_size=m.hop_size, win_size=m.win_size,
            fmin=m.fmin, fmax=m.fmax,
        )
        return mel[0].T.cpu().numpy()

    def text_normalize(self, text, split: bool = True, text_frontend: bool = True):
        if hasattr(text, "__next__"):  # a text generator passes through
            return [text] if split else text
        return _text_normalize(
            text,
            lambda t: self.tokenizer.encode(t, allowed_special=self.allowed_special),
            split=split,
            use_frontend=text_frontend,
        )

    # ---- per-mode prompt builders -------------------------------------------

    def _prompt_features(self, prompt_wav: str | np.ndarray) -> dict:
        """A path is loaded at 16 kHz and at the model's rate; a numpy prompt
        is taken as 16 kHz. At 24 kHz, feat and tokens are cut to 2:1."""
        sr = self.cfg.sample_rate
        if isinstance(prompt_wav, (str, Path)):
            wav16, _ = load_audio(prompt_wav, target_sr=16000)
            wav_sr, _ = load_audio(prompt_wav, target_sr=sr)
        else:
            wav16 = prompt_wav
            wav_sr = resample_poly(prompt_wav, 16000, sr)
        feat = self.extract_speech_feat(wav_sr)
        tokens = self.extract_speech_token(wav16)
        if sr == 24000:
            token_len = min(feat.shape[0] // 2, len(tokens))
            feat, tokens = feat[: 2 * token_len], tokens[:token_len]
        return {
            "speech_feat": feat,
            "speech_token": tokens,
            "embedding": self.extract_spk_embedding(wav16),
        }

    def frontend_zero_shot(self, tts_text, prompt_text, prompt_wav, zero_shot_spk_id="") -> dict:
        out: dict[str, Any] = {"text": self.extract_text_token(tts_text)}
        if zero_shot_spk_id == "":
            pf = self._prompt_features(prompt_wav)
            out.update(
                prompt_text=self.extract_text_token(prompt_text),
                llm_prompt_speech_token=pf["speech_token"],
                flow_prompt_speech_token=pf["speech_token"],
                prompt_speech_feat=pf["speech_feat"],
                llm_embedding=pf["embedding"],
                flow_embedding=pf["embedding"],
            )
        else:
            out.update(self.spk2info[zero_shot_spk_id])
        return out

    def frontend_cross_lingual(self, tts_text, prompt_wav, zero_shot_spk_id="") -> dict:
        out = self.frontend_zero_shot(tts_text, "", prompt_wav, zero_shot_spk_id)
        out.pop("prompt_text", None)
        out.pop("llm_prompt_speech_token", None)
        return out

    def frontend_instruct2(self, tts_text, instruct_text, prompt_wav, zero_shot_spk_id="") -> dict:
        out = self.frontend_zero_shot(tts_text, instruct_text, prompt_wav, zero_shot_spk_id)
        out.pop("llm_prompt_speech_token", None)
        return out

    def frontend_sft(self, tts_text, spk_id) -> dict:
        info = self.spk2info[spk_id]
        return {
            "text": self.extract_text_token(tts_text),
            "llm_embedding": info["embedding"],
            "flow_embedding": info["embedding"],
        }

    def frontend_instruct(self, tts_text, spk_id, instruct_text) -> dict:
        out = self.frontend_sft(tts_text, spk_id)
        del out["llm_embedding"]  # the reference drops it: information leakage
        out["prompt_text"] = self.extract_text_token(instruct_text + "<endofprompt>")
        return out

    def frontend_vc(self, source_speech_16k, prompt_wav) -> dict:
        pf = self._prompt_features(prompt_wav)
        return {
            "source_speech_token": self.extract_speech_token(source_speech_16k),
            "flow_prompt_speech_token": pf["speech_token"],
            "prompt_speech_feat": pf["speech_feat"],
            "flow_embedding": pf["embedding"],
        }

    # ---- spk2info -----------------------------------------------------------

    def add_zero_shot_spk(self, prompt_text, prompt_wav, zero_shot_spk_id) -> bool:
        pf = self._prompt_features(prompt_wav)
        self.spk2info[zero_shot_spk_id] = {
            "prompt_text": self.extract_text_token(prompt_text),
            "llm_prompt_speech_token": pf["speech_token"],
            "flow_prompt_speech_token": pf["speech_token"],
            "prompt_speech_feat": pf["speech_feat"],
            "llm_embedding": pf["embedding"],
            "flow_embedding": pf["embedding"],
        }
        return True

    def save_spkinfo(self, path: str | Path | None = None) -> None:
        path = str(path or self._spk2info_path or "spk2info.pt")
        torch.save({k: {kk: torch.from_numpy(np.array(vv, copy=True)) for kk, vv in v.items()}
                    for k, v in self.spk2info.items()}, path)


def make_campplus_fn(params, device: str | torch.device | None = None, dtype: torch.dtype = torch.bfloat16,
                     **model_kwargs) -> Callable:
    """fbank (B, T, 80) -> float32 x-vectors (B, 192), CAM++ in `dtype`
    (weights of two or more dimensions cast to it, the rest kept). `params`
    is the JAX-layout tree (campplus.msgpack); model_kwargs are CAMPPlus's
    (full size by default)."""
    from ..models.campplus import CAMPPlus
    from ..models.from_jax import campplus_from_jax

    dev = resolve_device(device)
    model = _load(lambda: CAMPPlus(**model_kwargs), _cast_state(campplus_from_jax(params, **model_kwargs), dtype), dev)

    @torch.inference_mode()
    def fn(fbank: torch.Tensor) -> torch.Tensor:
        return model(fbank.to(dev, dtype)).float()

    return fn


def make_s3_fn(params, device: str | torch.device | None = None, dtype: torch.dtype = torch.bfloat16,
               **model_kwargs) -> Callable:
    """(whisper mel (B, 128, T), valid frames (B,)) -> (codes (B, T//4) int32,
    code lengths (B,) int32), S3 in `dtype`. `params` is the JAX-layout tree
    (s3tokenizer.msgpack); model_kwargs are S3TokenizerV3's."""
    from ..models.from_jax import s3_from_jax
    from ..models.s3tokenizer import S3TokenizerV3

    dev = resolve_device(device)
    model = _load(lambda: S3TokenizerV3(**model_kwargs), _cast_state(s3_from_jax(params, **model_kwargs), dtype), dev)

    @torch.inference_mode()
    def fn(mel: torch.Tensor, mel_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return model(mel.to(dev, dtype), mel_len.to(dev))

    return fn
