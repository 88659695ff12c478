"""CosyVoice2 through fangyan_tts_torch's `CosyVoice2TTS`: weights made from
the seed, spans around the LLM scheduler's shared chunks and each stream's
token2wav hops, the model FLOPs of delivered audio, and the correctness
check against the float32 references, which work the streaming hops out
again (reference/v2_stream.py).

What a configuration's file holds: the Qwen2 sizes and the LM's speech
vocabulary and sampling at the top level, the flow's (the conformer encoder
and the U-Net) under "flow" and the vocoder's under "hift", and the dtype
the models are served in.
"""

from __future__ import annotations

import inspect
import threading

import numpy as np
import torch

from benchmark.harness import Spans, note
from benchmark.metrics import counters
from benchmark.reference.check import greedy_gap, mean_gap, rel_err, spectral_err
from benchmark.reference.hift import HiFT, total_upsample
from benchmark.reference.qwen2_lm import SpeechLM
from benchmark.reference.v2_flow import FlowV2
from benchmark.reference.v2_stream import stream_audio
from benchmark.systems.cosyvoice3 import (_pick, build_references, free_program, make_weights, plan_len, stream_key,
                                          stream_request, watch_llm_scheduler)


def reference_models(c: dict) -> dict:
    return {"llm": lambda: SpeechLM(c, 2), "flow": lambda: FlowV2(c["flow"]), "hift": lambda: HiFT(c["hift"])}


class System:
    """`params` are the cell's traffic parameters: `llm_width` turns on the
    continuous-batched LLM scheduler at that width."""

    def __init__(self, c: dict, seed: int, device: torch.device, params: dict | None = None):
        self.c, self.seed, self.device, self.params = c, int(seed), device, params or {}
        self.dtype = getattr(torch, c["dtype"])
        self.sample_rate = c["hift"]["sampling_rate"]
        self.spans = Spans(device.type == "cuda")
        self._tl = threading.local()
        self.tts = None
        self.control_kind = None

    def build(self) -> None:
        from fangyan_tts_torch.config import HiFTConfig, LLMConfig, QwenConfig
        from fangyan_tts_torch.infer.tts_v12 import CosyVoice2TTS
        from fangyan_tts_torch.models.flow_xvec import CausalMaskedDiffWithXvec

        c = self.c
        w = make_weights(c, self.seed, self.device, self.dtype, reference_models(c))
        names = set(inspect.signature(CausalMaskedDiffWithXvec).parameters)
        flow_kw = {k: tuple(v) if isinstance(v, list) else v for k, v in c["flow"].items() if k in names}
        self.tts = CosyVoice2TTS(_pick(LLMConfig, c, qwen=_pick(QwenConfig, c)), w["llm"], flow_kw, w["flow"],
                                 _pick(HiFTConfig, c["hift"]), w["hift"], dtype=self.dtype, device=self.device)
        del w
        self.spans.wrap(self.tts, "token2wav", "t2w_hop")
        if self.params.get("llm_width"):
            self.tts.enable_batched_llm(self.params["llm_width"])
            watch_llm_scheduler(self, self.tts.llm_scheduler)

    def control(self, kind: str) -> None:
        """The program has no lower-precision path: the control is the
        reference put in its place with every weight rounded to int8 (per
        output channel, symmetric), read on the served prompts and tokens."""
        if kind != "int8":
            raise ValueError(f"no control {kind!r}")
        self.control_kind = kind

    stream = stream_request
    stream_key = stream_key

    def stream_flops(self, s: dict, inputs: dict) -> float:
        """Model FLOPs of one finished stream: its prompt and decode, one
        chunk-masked encoder pass and U-Net solve over its prompt and tokens,
        its vocoder frames (the hops' re-solves of the prefix are overhead
        and count nothing)."""
        c, f = self.c, self.c["flow"]
        voice = inputs["voices"][s["req"]["voice"]]
        n = sum(len(t) for t in s["tokens"])
        n_plan = len(voice["prompt_text"]) + plan_len(len(s["req"]["text"])) + len(voice["llm_tokens"])
        n_tok = len(voice["flow_tokens"]) + n
        mel_len = n_tok * f["token_mel_ratio"]
        return (counters.lm_sequence_flops(c, n_plan, n)
                + counters.upsample_encoder_flops(f, n_tok, f["static_chunk_size"])
                + counters.unet_solve_flops(f, mel_len, f["static_chunk_size"] * f["token_mel_ratio"])
                + n * f["token_mel_ratio"] * counters.hift_frame_flops(c["hift"]))

    free = free_program

    def references(self, int8: bool = False) -> dict:
        return build_references(self, reference_models(self.c), int8)

    def check_streams(self, streams: list[dict], inputs: dict) -> dict:
        """Numbers compared for served streams: the widest greedy gap of the
        served tokens and its mean, the relative error of each whole
        stream's STFT magnitudes against the reference's hop-by-hop
        token2wav of the same tokens, and the count of streams whose length
        is not what their text asked for."""
        ref = self.references()
        low = self.references(int8=True) if self.control_kind else None
        c = self.c
        gap = wav_e = gap_sum = 0.0
        bad_len = n_served = 0
        for s in streams:
            voice = inputs["voices"][s["req"]["voice"]]
            served = np.concatenate(s["tokens"]).astype(np.int64) if s["tokens"] else np.zeros(0, np.int64)
            audio = np.concatenate(s["audio"])
            if len(served) != int(len(s["req"]["text"]) * inputs["ratio"]) or len(served) == 0:
                bad_len += 1
                continue
            text = np.concatenate([voice["prompt_text"], s["req"]["text"]])
            logits = ref["llm"].served_logits(text, voice["llm_tokens"], served)
            want = stream_audio(ref["flow"], ref["hift"], voice["flow_tokens"], voice["feat"], voice["xvec"], served)
            if low is not None:  # the control: the tokens the int8 reference puts first, and its audio
                low_logits = low["llm"].served_logits(text, voice["llm_tokens"], served)
                served = low_logits[:, : c["speech_token_size"]].argmax(dim=1).cpu().numpy()
                audio = stream_audio(low["flow"], low["hift"], voice["flow_tokens"], voice["feat"], voice["xvec"],
                                     np.concatenate(s["tokens"]))
            g = greedy_gap(logits, served, c["speech_token_size"])
            gap = max(gap, g)
            gap_sum += mean_gap(logits, served, c["speech_token_size"]) * len(served)
            n_served += len(served)
            w_e = spectral_err(audio, want) if len(audio) == len(want) else float("inf")
            wav_e = max(wav_e, w_e)
            note(f"stream of {len(served)} tokens, {len(s['audio'])} chunks: gap {g:.5g} "
                 f"(mean {mean_gap(logits, served, c['speech_token_size']):.5g}), wav spectral {w_e:.5g}, "
                 f"wav rel {rel_err(audio, want) if len(audio) == len(want) else float('inf'):.5g}, "
                 f"{len(audio)} samples against {len(want)} ({total_upsample(c['hift'])} a frame)")
        return {"lm_gap": gap, "lm_gap_mean": gap_sum / max(n_served, 1), "wav_spec_rel": wav_e,
                "length_errors": float(bad_len)}

