"""Public model API, the cli/cosyvoice.py equivalent
(fangyan_tts_tpu/api.py: `CosyVoice3`, `CosyVoice2`, `CosyVoice` and
`AutoModel`).

A model directory holds:
    config.json                                (CosyVoiceConfig overrides; optional)
    llm.msgpack / flow.msgpack / hift.msgpack  (parameter trees, flax msgpack)
    campplus.msgpack / s3tokenizer.msgpack     (the frontend models; optional)
    tokenizer/                                 (HF tokenizer files; optional)
    spk2info.pt                                (saved speakers; optional)
The msgpack files are the JAX package's (train/checkpoint.py reads and
writes them without flax). Reference torch checkpoints (llm.pt / flow.pt /
hift.pt) are converted to msgpack on first load when the msgpack is absent
(models/convert.py). Without a tokenizer directory the byte tokenizer
serves, as in the JAX package.

`AutoModel` picks the family by config.json's "version", else by the
reference yaml present. The CosyVoice2 and CosyVoice (v1) directories may
carry module-size overrides in config.json ("xvec_flow": the flow's
arguments, "llm_v1": the v1 LM's), as the JAX package reads them. The v1
family runs float32 (fp16=True is refused with a warning, as in the
reference) and tokenizes with the whisper-style tiktoken tokenizer when the
directory holds its rank file (multilingual_zh_ja_yue_char_del.tiktoken),
else with the byte tokenizer.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from .config import CosyVoiceConfig, _to_jsonable, config_from_dict, cosyvoice1_config, cosyvoice2_config
from .infer.frontend import Frontend, make_campplus_fn, make_s3_fn
from .infer.tts import CosyVoice3TTS, _cast_state
from .infer.tts_v12 import CosyVoice2TTS, CosyVoiceV1TTS
from .models.convert import (
    filter_training_meta,
    flow_params_from_reference,
    flow_v1_params_from_reference,
    flow_v2_params_from_reference,
    fuse_qwen_split_params,
    hift_nc_params_from_reference,
    hift_params_from_reference,
    llm_params_from_reference,
    llm_v1_params_from_reference,
    llm_v2_params_from_reference,
)
from .models.from_jax import (
    flow_from_jax,
    flow_v1_from_jax,
    flow_v2_from_jax,
    hift_from_jax,
    hift_nc_from_jax,
    llm_from_jax,
    llm_v1_from_jax,
    llm_v2_from_jax,
)
from .ops.device import resolve_device
from .tokenizer import get_qwen_tokenizer, get_tokenizer
from .train.checkpoint import load_params, save_params


def _maybe_convert(model_dir: Path, name: str, convert_fn) -> Path | None:
    """<name>.msgpack, written first from <name>.pt when only that exists."""
    msg = model_dir / f"{name}.msgpack"
    if msg.exists():
        return msg
    pt = model_dir / f"{name}.pt"
    if pt.exists():
        sd = filter_training_meta(torch.load(pt, map_location="cpu", weights_only=False))
        save_params(msg, convert_fn(sd))
        logging.info("converted %s -> %s", pt, msg)
        return msg
    return None


def _checkpoints(model_dir: Path, converters: dict) -> dict:
    """{name: msgpack path} for llm / flow / hift, converted from .pt when
    only that exists; raises when one is missing."""
    paths = {name: _maybe_convert(model_dir, name, fn) for name, fn in converters.items()}
    missing = [k for k, v in paths.items() if v is None]
    if missing:
        raise FileNotFoundError(f"missing checkpoints in {model_dir}: {missing}")
    return paths


def _family_config(model_dir: Path, preset: CosyVoiceConfig) -> tuple[CosyVoiceConfig, dict]:
    """config.json overlaid on the family's preset (omitted sections keep
    the family's defaults), and the raw config.json dict."""
    cfg_path = model_dir / "config.json"
    extra = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
    cfg = config_from_dict({**_deep_merge(_to_jsonable(preset), extra), "version": preset.version})
    return cfg, extra


def _module_kw(extra: dict, key: str, **defaults) -> dict:
    """config.json's module-size overrides under `key` (lists as tuples)."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in extra.get(key, {}).items()}
    return {**defaults, **kw}


def _deep_merge(base: dict, extra: dict) -> dict:
    """Recursive config overlay: a partial nested section merges into the
    base's section instead of replacing it."""
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class CosyVoice3:
    """The CosyVoice3 family. fp16=True runs bfloat16, the only dtype on
    CUDA (its attention kernels take bf16); fp16=False runs float32 on the
    CPU and raises on CUDA. device None means CUDA."""

    sample_rate = 24000

    def __init__(
        self,
        model_dir: str,
        fp16: bool = True,
        load_frontend_models: bool = True,
        quant_int8: bool = False,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        cfg = CosyVoiceConfig()
        cfg_path = self.model_dir / "config.json"
        if cfg_path.exists():
            cfg = config_from_dict(json.loads(cfg_path.read_text()))
        self.cfg = cfg

        dtype = torch.bfloat16 if fp16 else torch.float32
        paths = _checkpoints(self.model_dir, {"llm": llm_params_from_reference, "flow": flow_params_from_reference,
                                              "hift": hift_params_from_reference})
        llm_sd = _cast_state(llm_from_jax(fuse_qwen_split_params(load_params(paths["llm"])), cfg.llm), dtype)
        flow_sd = flow_from_jax(load_params(paths["flow"]), cfg.flow)
        hift_sd = hift_from_jax(load_params(paths["hift"]), cfg.hift)
        self.model = CosyVoice3TTS(cfg, llm_sd, flow_sd, hift_sd, dtype=dtype, device=self.device)
        if quant_int8:
            self.model.quantize_llm()  # weight-only int8 LLM (ops/quant.py)

        tok_dir = self.model_dir / "tokenizer"
        tokenizer = get_qwen_tokenizer(str(tok_dir) if tok_dir.exists() else None, True, "cosyvoice3")
        self._build_frontend(tokenizer, load_frontend_models)

    def _build_frontend(self, tokenizer, load_frontend_models: bool) -> None:
        # the prompt resampler's scipy.signal takes seconds to import: pay that at
        # load, not in the first request's frontend
        import scipy.signal  # noqa: F401

        campplus_fn = s3_fn = None
        if load_frontend_models:
            cp = self.model_dir / "campplus.msgpack"
            s3 = self.model_dir / "s3tokenizer.msgpack"
            if cp.exists():
                campplus_fn = make_campplus_fn(load_params(cp), device=self.device)
            if s3.exists():
                s3_fn = make_s3_fn(load_params(s3), device=self.device)
        self.frontend = Frontend(tokenizer, self.cfg, campplus_fn, s3_fn, spk2info=self.model_dir / "spk2info.pt",
                                 device=self.device)

    # -- speaker management
    def add_zero_shot_spk(self, prompt_text: str, prompt_wav, zero_shot_spk_id: str) -> bool:
        assert zero_shot_spk_id != "", "do not use empty zero_shot_spk_id"
        return self.frontend.add_zero_shot_spk(prompt_text, prompt_wav, zero_shot_spk_id)

    def save_spkinfo(self):
        self.frontend.save_spkinfo(self.model_dir / "spk2info.pt")

    def list_available_spks(self) -> list[str]:
        return list(self.frontend.spk2info.keys())

    # -- inference generators
    def _run(self, model_input: dict, stream: bool, speed: float, text_label: str):
        start = time.time()
        for out in self.model.tts(stream=stream, speed=speed, **model_input):
            speech_len = len(out["tts_speech"]) / self.sample_rate
            rtf = (time.time() - start) / max(speech_len, 1e-9)
            logging.info("yield speech len %.2f, rtf %.3f (%s)", speech_len, rtf, text_label)
            yield out
            start = time.time()

    def inference_zero_shot(self, tts_text, prompt_text, prompt_wav, zero_shot_spk_id="", stream=False, speed=1.0,
                            text_frontend=True):
        prompt_text_norm = self.frontend.text_normalize(prompt_text, split=False, text_frontend=text_frontend)
        for seg in self.frontend.text_normalize(tts_text, split=True, text_frontend=text_frontend):
            if not hasattr(seg, "__next__") and len(seg) < 0.5 * len(prompt_text_norm):
                logging.warning("synthesis text %s too short than prompt text %s, this may lead to bad performance",
                                seg, prompt_text_norm)
            mi = self.frontend.frontend_zero_shot(seg, prompt_text_norm, prompt_wav, zero_shot_spk_id)
            yield from self._run(mi, stream, speed, "<bistream>" if hasattr(seg, "__next__") else seg)

    def inference_cross_lingual(self, tts_text, prompt_wav, zero_shot_spk_id="", stream=False, speed=1.0,
                                text_frontend=True):
        for seg in self.frontend.text_normalize(tts_text, split=True, text_frontend=text_frontend):
            mi = self.frontend.frontend_cross_lingual(seg, prompt_wav, zero_shot_spk_id)
            yield from self._run(mi, stream, speed, seg)

    def inference_instruct2(self, tts_text, instruct_text, prompt_wav, zero_shot_spk_id="", stream=False, speed=1.0,
                            text_frontend=True):
        assert "<|endofprompt|>" in instruct_text, "v3 instruct should contain <|endofprompt|>"
        for seg in self.frontend.text_normalize(tts_text, split=True, text_frontend=text_frontend):
            mi = self.frontend.frontend_instruct2(seg, instruct_text, prompt_wav, zero_shot_spk_id)
            yield from self._run(mi, stream, speed, seg)

    def inference_sft(self, tts_text, spk_id, stream=False, speed=1.0, text_frontend=True):
        for seg in self.frontend.text_normalize(tts_text, split=True, text_frontend=text_frontend):
            mi = self.frontend.frontend_sft(seg, spk_id)
            yield from self._run(mi, stream, speed, seg)

    def inference_instruct(self, tts_text, spk_id, instruct_text, stream=False, speed=1.0, text_frontend=True):
        """The v1-only natural-language instruct mode."""
        raise NotImplementedError(
            "inference_instruct is only implemented for CosyVoice (v1); use inference_instruct2"
        )

    def inference_vc(self, source_wav, prompt_wav, stream=False, speed=1.0):
        from .data.audio import load_audio

        if isinstance(source_wav, (str, Path)):
            src16, _ = load_audio(source_wav, target_sr=16000)
        else:
            src16 = source_wav
        mi = self.frontend.frontend_vc(src16, prompt_wav)
        mi["source_speech_token"] = np.asarray(mi.pop("source_speech_token"), np.int32)
        yield from self._run(mi, stream, speed, "vc")


class CosyVoice2(CosyVoice3):
    """The CosyVoice2 family: Qwen2LMV2 (the 2-row sos / task table), the
    x-vector flow (UpsampleConformerEncoder + causal U-Net CFM) and the
    non-causal 24 kHz HiFT with its mel / source / speech streaming cache.
    fp16=True runs bfloat16, the only dtype on CUDA."""

    sample_rate = 24000

    def __init__(self, model_dir: str, fp16: bool = True, load_frontend_models: bool = True,
                 device: str | torch.device | None = None, **_):
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        self.cfg, extra = _family_config(self.model_dir, cosyvoice2_config())
        cfg = self.cfg
        dtype = torch.bfloat16 if fp16 else torch.float32
        paths = _checkpoints(self.model_dir, {"llm": llm_v2_params_from_reference,
                                              "flow": flow_v2_params_from_reference,
                                              "hift": hift_nc_params_from_reference})
        llm_sd = _cast_state(llm_v2_from_jax(fuse_qwen_split_params(load_params(paths["llm"])), cfg.llm), dtype)
        flow_kw = _module_kw(extra, "xvec_flow", vocab_size=cfg.llm.speech_token_size)
        self.model = CosyVoice2TTS(cfg.llm, llm_sd, flow_kw, flow_v2_from_jax(load_params(paths["flow"]), **flow_kw),
                                   cfg.hift, hift_nc_from_jax(load_params(paths["hift"]), cfg.hift), dtype=dtype,
                                   device=self.device)
        tok_dir = self.model_dir / "CosyVoice-BlankEN"
        if not tok_dir.exists():
            tok_dir = self.model_dir / "tokenizer"
        tokenizer = get_qwen_tokenizer(str(tok_dir) if tok_dir.exists() else None, True, "cosyvoice2")
        self._build_frontend(tokenizer, load_frontend_models)


class CosyVoice(CosyVoice3):
    """The CosyVoice1 family: TransformerLM, the conformer flow with the
    InterpolateRegulator and the non-causal U-Net, and the 22.05 kHz HiFT;
    streaming through mel-overlap fades and the z / mu flow cache. Runs
    float32, as the reference serves it."""

    sample_rate = 22050

    def __init__(self, model_dir: str, fp16: bool = False, load_frontend_models: bool = True,
                 device: str | torch.device | None = None, **_):
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        self.cfg, extra = _family_config(self.model_dir, cosyvoice1_config())
        cfg = self.cfg
        paths = _checkpoints(self.model_dir, {
            "llm": llm_v1_params_from_reference, "flow": flow_v1_params_from_reference,
            "hift": lambda sd: hift_nc_params_from_reference(sd, upsample_rates=(8, 8))})
        llm_kw = _module_kw(extra, "llm_v1", speech_token_size=cfg.llm.speech_token_size)
        flow_kw = _module_kw(extra, "xvec_flow", vocab_size=cfg.llm.speech_token_size)
        if fp16:
            logging.warning("CosyVoice (v1) ignores fp16=True and runs float32, as the reference does")
        self.model = CosyVoiceV1TTS(
            llm_kw, llm_v1_from_jax(load_params(paths["llm"]), **llm_kw),
            flow_kw, flow_v1_from_jax(load_params(paths["flow"]), **flow_kw),
            cfg.hift, hift_nc_from_jax(load_params(paths["hift"]), cfg.hift), device=self.device)
        vocab = self.model_dir / "multilingual_zh_ja_yue_char_del.tiktoken"
        tokenizer = get_tokenizer(multilingual=True, vocab_path=str(vocab) if vocab.exists() else None)
        self._build_frontend(tokenizer, load_frontend_models)

    def inference_instruct2(self, *args, **kwargs):
        raise NotImplementedError("inference_instruct2 requires CosyVoice2/3")

    def inference_instruct(self, tts_text, spk_id, instruct_text, stream=False, speed=1.0, text_frontend=True):
        """A saved speaker and a natural-language instruction: frontend_sft
        without the LLM embedding, the instruction as prompt text."""
        instruct_norm = self.frontend.text_normalize(instruct_text, split=False, text_frontend=text_frontend)
        for seg in self.frontend.text_normalize(tts_text, split=True, text_frontend=text_frontend):
            mi = self.frontend.frontend_instruct(seg, spk_id, instruct_norm)
            yield from self._run(mi, stream, speed, seg)


def AutoModel(model_dir: str, **kwargs):
    """Dispatch by the files present: config.json's "version", else the
    reference yaml's name, else 3."""
    d = Path(model_dir)
    if (d / "config.json").exists():
        version = json.loads((d / "config.json").read_text()).get("version", 3)
    elif (d / "cosyvoice3.yaml").exists():
        version = 3
    elif (d / "cosyvoice2.yaml").exists():
        version = 2
    elif (d / "cosyvoice.yaml").exists():
        version = 1
    else:
        version = 3
    return {1: CosyVoice, 2: CosyVoice2, 3: CosyVoice3}[version](model_dir, **kwargs)
