"""CosyVoice3 with a Moonlight-16B-A3B (DeepSeek-V3-style MLA-MoE) speech
LM, through fangyan_tts_torch's `CosyVoice3TTS` and the same batched path
as the `cosyvoice3` family (systems/cosyvoice3.py), whose spans, traffic
calls and checks it keeps. What it changes:

- the configuration: the decoder's sizes at the top level under the
  published config's keys, the speech vocabulary and sampling beside
  them, the flow and vocoder as the cosyvoice3 family's;
- the weights: the fast-init rule, and each MoE layer's
  `e_score_correction_bias` drawn N(0, 0.05) from the seed (a generator of
  its own), so that selection and weighting differ as in a trained
  router (fast-init would make it zero);
- the LM reference (reference/moonlight_lm.py), which keeps the seed's
  bf16 weights and upcasts one layer at a time: a float32 copy of the
  decoder would not fit beside the flow on the card;
- `batch_work`: the MLA decode kernel's launches (two a layer a decode
  step) with their bytes and operations, and the model FLOPs of the
  decoder's active weights;
- the int8 control: every LM weight of two or more dimensions rounded to
  int8 per output channel and loaded into the served bf16 path (the
  program has no int8 MLA-MoE route), and the flow quantized.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.metrics import counters, counters_moe
from benchmark.reference import exact_float32
from benchmark.reference.check import int8_rounded
from benchmark.reference.dit_flow import Flow
from benchmark.reference.hift import CausalHiFT
from benchmark.reference.moonlight_lm import SpeechLM
from benchmark.systems import cosyvoice3 as base

VERSION = base.VERSION
BIAS_STD = 0.05  # e_score_correction_bias ~ N(0, BIAS_STD), from the seed
BIAS_STREAM = 7919  # its generator's seed is the run's seed plus this


def reference_models(c: dict) -> dict:
    return {"llm": lambda: SpeechLM(c), "flow": lambda: Flow(c["flow"]), "hift": lambda: CausalHiFT(c["hift"])}


def make_weights(c: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """The cosyvoice3 family's fast-init weights of these models, then the
    routers' correction biases from a generator of their own."""
    w = base.make_weights(c, seed, device, dtype, reference_models(c))
    gen = torch.Generator(device=device).manual_seed(int(seed) + BIAS_STREAM)
    for k in sorted(w["llm"]):
        if k.endswith("e_score_correction_bias"):
            w["llm"][k] = torch.empty(w["llm"][k].shape, device=device).normal_(0.0, BIAS_STD, generator=gen)
    return w


def port_config(c: dict):
    """The system's configuration object: the cosyvoice3 family's, with the
    MLA-MoE backbone in the LM."""
    from fangyan_tts_torch.config import LLMConfig, MLAMoEConfig

    llm = base._pick(LLMConfig, c, qwen=base._pick(MLAMoEConfig, c))
    return dataclasses.replace(base.port_config(c), llm=llm)


def build_references(system) -> dict:
    """The float32 references on the weights made again from the seed; the
    LM's stay in the seed's bf16 and are upcast as they are used."""
    if system.device.type == "cuda":
        exact_float32()
    models = reference_models(system.c)
    w = make_weights(system.c, system.seed, system.device, system.dtype)
    out = {}
    for name, ctor in models.items():
        with torch.device("meta"):
            m = ctor()
        sd = w[name] if name == "llm" else {k: v.float() for k, v in w[name].items()}
        m.load_state_dict(sd, strict=True, assign=True)
        out[name] = m.eval()
    return out


class System(base.System):
    def build(self) -> None:
        from fangyan_tts_torch.infer.tts import CosyVoice3TTS

        cfg = port_config(self.c)
        w = make_weights(self.c, self.seed, self.device, self.dtype)
        self.tts = CosyVoice3TTS(cfg, w["llm"], w["flow"], w["hift"], dtype=self.dtype, device=self.device)
        del w
        tok = lambda a, k, out: {"tokens": out[0], "counts": out[1], "texts": a[0]}
        mel = lambda a, k, out: {"mel": out[0], "token_len": out[1]}
        self.spans.wrap(self.tts, "_batch_tokens", "llm", keep=tok)
        self.spans.wrap(self.tts, "_batch_token2mel", "flow", keep=mel)
        self.spans.wrap(self.tts, "vocode_batch", "vocoder")

    def control(self, kind: str) -> None:
        """LM weights rounded to int8 in the served path, the flow in int8."""
        if kind != "int8":
            raise ValueError(f"no control {kind!r}")
        with torch.no_grad():
            for p in self.tts.llm.parameters():
                if p.dim() >= 2:
                    p.copy_(int8_rounded(p.float()).to(p.dtype))
        self.tts.quantize_flow()

    def references(self) -> dict:
        return build_references(self)

    def batch_work(self, b: dict, prompt: dict, ratio: float) -> dict:
        """The MLA decode kernel's launches (the split pass with the call's
        bytes and operations, then the merge) and the model FLOPs of one
        completed batch."""
        c = self.c
        texts = b["texts"]
        plens = [base.plan_len(len(prompt["instruct"]) + len(t)) for t in texts]
        tp = base._round_up(max(plens), base.PLAN_BUCKET)
        max_lens = [int(len(t) * ratio) for t in texts]
        max_new = max(base._round_up(max(max_lens), base.NEW_BUCKET), base.NEW_BUCKET)
        cache_len = base._round_up(tp + max_new, base.CACHE_BUCKET)
        steps = max(max_lens)
        mla = []
        for i in range(steps):
            w = counters_moe.mla_decode_work(len(texts), cache_len, c["num_attention_heads"], c["kv_lora_rank"],
                                             c["qk_rope_head_dim"], sum(p + i + 1 for p in plens))
            mla += [w, (0.0, 0.0)] * c["num_hidden_layers"]
        ratio_mel = c["flow"]["token_mel_ratio"]
        mel_len = [int(n) * ratio_mel for n in b["token_len"]]
        flops = sum(counters_moe.lm_sequence_flops(c, p, int(n)) for p, n in zip(plens, b["counts"]))
        flops += sum(counters.dit_solve_flops(c["flow"], m) for m in mel_len)
        flops += sum(mel_len) * counters.causal_hift_frame_flops(c["hift"])
        return {"decode_steps": steps, "launches": {"mla_decode": mla}, "model_flops": flops}
