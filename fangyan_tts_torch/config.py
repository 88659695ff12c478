"""Dataclass configuration for the CosyVoice3-style model family.

The port's own copy of fangyan_tts_tpu/config.py: the same dataclasses,
fields and defaults, so one configuration describes a model on both sides.
Fields that only the JAX package reads (the Qwen decode-path switches) are
kept so configurations stay interchangeable; the port's Qwen2 model raises
NotImplementedError when one of them is set away from its default
(`reject_unported`), so such a setting is never ignored without a word.
`QwenConfig.remat` is read by both: gradient rematerialisation of the
cache-free (training) forward.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class QwenConfig:
    """Qwen2-0.5B-style decoder backbone (matches HF Qwen2Config fields).

    Defaults are the CosyVoice3-0.5B backbone: hidden 896, 24 layers,
    14 query heads / 2 kv heads (GQA), ffn 4864.
    """

    hidden_size: int = 896
    intermediate_size: int = 4864
    num_hidden_layers: int = 24
    num_attention_heads: int = 14
    num_key_value_heads: int = 2
    head_dim: int = 64
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    vocab_size: int = 151936
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = True
    # Weight-only int8 for every block dense kernel (ops/quant.py); with it,
    # quant_int4_mlp stores the MLP kernels as nibble-packed int4 instead
    # (int4 without int8 is ignored, as in the JAX package).
    quant_int8: bool = False
    quant_int4_mlp: bool = False
    # Read by the JAX package only (decode-path variants); kept so
    # configurations round-trip.
    fused_decode_attention: bool = True
    use_pallas_decode_attention: bool = False
    # Gradient remat of the training forward: "" off, "full" recomputes each
    # block in the backward pass, "dots" keeps its matmul outputs.
    remat: str = ""


@dataclass(frozen=True)
class LLMConfig:
    """CosyVoice3 AR speech-token LM (reference: cosyvoice/llm/llm.py:628-748).

    Special ids (CosyVoice3 layout, llm.py:645-648):
      sos = speech_token_size + 0, eos = +1, task = +2, fill = +3;
      decoder head size speech_token_size + 200, bias-free (llm.py:651);
      stop ids = speech_token_size + [0..200) (llm.py:667).
    """

    llm_input_size: int = 896
    llm_output_size: int = 896
    speech_token_size: int = 6561
    extra_tokens: int = 200  # head size = speech_token_size + extra_tokens
    mix_ratio: tuple[int, int] = (5, 15)
    lsm_weight: float = 0.0
    length_normalized_loss: bool = True
    qwen: QwenConfig = field(default_factory=QwenConfig)

    # sampling defaults (conf/cosyvoice3.yaml:32-36)
    top_p: float = 0.8
    top_k: int = 25
    win_size: int = 10
    tau_r: float = 0.1

    @property
    def sos(self) -> int:
        return self.speech_token_size + 0

    @property
    def eos(self) -> int:
        return self.speech_token_size + 1

    @property
    def task_id(self) -> int:
        return self.speech_token_size + 2

    @property
    def fill(self) -> int:
        return self.speech_token_size + 3

    @property
    def head_size(self) -> int:
        return self.speech_token_size + self.extra_tokens


@dataclass(frozen=True)
class DiTConfig:
    """Flow-matching DiT estimator (reference: cosyvoice/flow/DiT/dit.py:104-176)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 80
    mu_dim: int = 80
    spk_dim: int = 80
    out_channels: int = 80
    static_chunk_size: int = 50  # chunk_size(25) * token_mel_ratio(2)
    num_decoding_left_chunks: int = -1
    freq_embed_dim: int = 256
    conv_pos_kernel: int = 31
    conv_pos_groups: int = 16
    quant_int8: bool = False  # weight-only int8 block dense kernels (ops/quant.py)


@dataclass(frozen=True)
class FlowConfig:
    """CausalMaskedDiffWithDiT (reference: cosyvoice/flow/flow.py:278-433)."""

    input_size: int = 80  # token embedding dim
    output_size: int = 80  # mel dim
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    input_frame_rate: int = 25
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    pre_lookahead_channels: int = 1024
    only_mask_loss: bool = True

    # CFM (conf/cosyvoice3.yaml:52-63)
    sigma_min: float = 1e-6
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7
    n_timesteps: int = 10

    dit: DiTConfig = field(default_factory=DiTConfig)


@dataclass(frozen=True)
class HiFTConfig:
    """CausalHiFTGenerator (reference: cosyvoice/hifigan/generator.py:572-726)."""

    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: tuple[int, ...] = (7, 7, 11)
    source_resblock_dilation_sizes: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    conv_pre_look_right: int = 4
    f0_cond_channels: int = 512
    # windowed-streaming NSF noise buffer length (exact vs the reference's
    # deterministic buffer up to this duration, wraps after — noise is iid)
    stream_noise_seconds: int = 120

    @property
    def total_upsample(self) -> int:
        r = self.istft_hop_len
        for u in self.upsample_rates:
            r *= u
        return r  # 480 = hop size at 24kHz


@dataclass(frozen=True)
class MelConfig:
    """24kHz training/feature mel (matcha mel_spectrogram parameters,
    conf/cosyvoice3.yaml:103-111)."""

    n_fft: int = 1920
    num_mels: int = 80
    sampling_rate: int = 24000
    hop_size: int = 480
    win_size: int = 1920
    fmin: float = 0.0
    fmax: float | None = None
    center: bool = False


@dataclass(frozen=True)
class CosyVoiceConfig:
    """Top-level model family config (mirrors cosyvoice3.yaml fixed params).

    `version` selects the model family (1/2/3) for AutoModel dispatch and
    the api.py module wiring; the nested configs carry the per-family
    hyperparameters (see cosyvoice1_config / cosyvoice2_config)."""

    version: int = 3
    sample_rate: int = 24000
    token_frame_rate: int = 25
    token_mel_ratio: int = 2
    chunk_size: int = 25  # streaming hop, in speech tokens
    spk_embed_dim: int = 192

    llm: LLMConfig = field(default_factory=LLMConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    hift: HiFTConfig = field(default_factory=HiFTConfig)
    mel: MelConfig = field(default_factory=MelConfig)


def cosyvoice1_config() -> CosyVoiceConfig:
    """CosyVoice1 fixed params (conf/cosyvoice.yaml): 22.05 kHz, 50 Hz
    tokens, hop-256 mel, [8,8]x4 non-causal HiFT, 4096-token flow vocab."""
    return CosyVoiceConfig(
        version=1,
        sample_rate=22050,
        token_frame_rate=50,
        token_mel_ratio=0,  # non-integer (22050/256 per 50 Hz token); v1 uses mel_len2 arithmetic
        llm=LLMConfig(speech_token_size=4096, extra_tokens=1, llm_input_size=1024, llm_output_size=1024),
        hift=HiFTConfig(
            sampling_rate=22050,
            upsample_rates=(8, 8),
            upsample_kernel_sizes=(16, 16),
            source_resblock_kernel_sizes=(7, 11),
            source_resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
        ),
        mel=MelConfig(n_fft=1024, sampling_rate=22050, hop_size=256, win_size=1024),
    )


def cosyvoice2_config() -> CosyVoiceConfig:
    """CosyVoice2 fixed params (conf/cosyvoice2.yaml): 24 kHz, 25 Hz tokens,
    x2 upsampling flow, non-causal [8,5,3]x4 HiFT, 6561-token FSQ vocab,
    Qwen2 LM with the 2-row sos/task table (head = size + 3)."""
    return CosyVoiceConfig(
        version=2,
        llm=LLMConfig(speech_token_size=6561, extra_tokens=3),
    )


_UNPORTED = ("fused_decode_attention", "use_pallas_decode_attention")


def reject_unported(cfg: QwenConfig) -> None:
    """Raise NotImplementedError if `cfg` sets a JAX-package-only field away
    from its default."""
    bad = [n for n in _UNPORTED if getattr(cfg, n) != getattr(QwenConfig, n)]
    if bad:
        raise NotImplementedError(f"fangyan_tts_torch: {type(cfg).__name__} fields {bad} are not ported")


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def config_to_json(cfg: Any) -> str:
    return json.dumps(_to_jsonable(cfg), indent=2, ensure_ascii=False)


def _dataclass_from_dict(cls: type, d: dict[str, Any]) -> Any:
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            v = _dataclass_from_dict(f.type, v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f.name] = v
    return cls(**kwargs)


_NESTED = {"llm": LLMConfig, "flow": FlowConfig, "hift": HiFTConfig, "mel": MelConfig, "qwen": QwenConfig, "dit": DiTConfig}


def config_from_dict(d: dict[str, Any], cls: type = CosyVoiceConfig) -> Any:
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _NESTED and isinstance(v, dict):
            v = config_from_dict(v, _NESTED[f.name])
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f.name] = v
    return cls(**kwargs)


def load_reference_yaml(path: str) -> CosyVoiceConfig:
    """Map a reference cosyvoice3.yaml onto CosyVoiceConfig.

    Parses only scalar hyperparameters (no object instantiation — unlike
    hyperpyyaml, nothing in the YAML is executed). Unknown keys are ignored;
    missing keys keep CosyVoice3-0.5B defaults.
    """
    import re

    scalars: dict[str, Any] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            m = re.match(r"^(\w+):\s*([^#\n]+?)\s*(#.*)?$", line)
            if m and "!" not in m.group(2):
                key, raw = m.group(1), m.group(2).strip()
                try:
                    scalars[key] = json.loads(raw)
                except (json.JSONDecodeError, ValueError):
                    scalars[key] = raw

    kw: dict[str, Any] = {}
    for name in ("sample_rate", "token_frame_rate", "token_mel_ratio", "chunk_size", "spk_embed_dim"):
        if name in scalars:
            kw[name] = scalars[name]
    cfg = CosyVoiceConfig(**kw)
    return cfg
