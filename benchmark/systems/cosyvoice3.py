"""CosyVoice3 through fangyan_tts_torch's `CosyVoice3TTS`: weights made from
the seed, spans around the calls into the LLM, flow and vocoder stages, the
shapes of the kernel launches and the model FLOPs of completed work, and
the correctness check against the float32 references.

What a configuration's file holds: the Qwen2 sizes and the LM's speech
vocabulary and sampling at the top level, the flow's under "flow" (the
DiT's under "flow"/"dit") and the vocoder's under "hift", and the dtype the
models are served in.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import threading

import numpy as np
import torch

from benchmark.harness import Spans, note
from benchmark.metrics import counters
from benchmark.reference import exact_float32
from benchmark.reference.check import greedy_gap, int8_rounded, mean_gap, rel_err, spectral_err, suppress_silent_runs
from benchmark.reference.dit_flow import Flow, fixed_noise
from benchmark.reference.hift import CausalHiFT, total_upsample
from benchmark.reference.qwen2_lm import SpeechLM

VERSION = 3
# the decode buckets of batch_synthesize (prompt plans, new tokens, cache), in tokens
PLAN_BUCKET, NEW_BUCKET, CACHE_BUCKET, FLOW_BUCKET = 32, 64, 64, 64
# audio frames at each utterance's end that the vocoder's lookahead (conv_pre 4, f0 3) ties to the padding after it
TAIL_FRAMES = 8


def reference_models(c: dict) -> dict:
    return {"llm": lambda: SpeechLM(c, VERSION), "flow": lambda: Flow(c["flow"]), "hift": lambda: CausalHiFT(c["hift"])}


def make_weights(c: dict, seed: int, device, dtype: torch.dtype, models: dict | None = None) -> dict:
    """State dicts of every model, in the parameter names both sides share,
    by the fast-init rule: N(0, 0.02) for tensors of two or more dimensions
    (in `dtype`; the vocoder's f0 predictor in float32), ones for norms and
    Snake alphas, zeros for biases. Drawn on `device` in one call a dtype."""
    models = models or reference_models(c)
    specs = []
    for group, ctor in models.items():
        with torch.device("meta"):
            skel = ctor()
        for k, v in skel.state_dict().items():
            if v.dim() >= 2:
                kind = "f32" if group == "hift" and k.startswith("f0_predictor.") else "low"
            else:
                kind = "zeros" if k.endswith("bias") else "ones"
            specs.append((group, k, tuple(v.shape), kind))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: dict = {g: {} for g in models}
    for kind, dt in (("low", dtype), ("f32", torch.float32)):
        sel = [s for s in specs if s[3] == kind]
        flat = torch.empty(sum(math.prod(s[2]) for s in sel), dtype=dt, device=device).normal_(0.0, 0.02, generator=gen)
        off = 0
        for group, k, shape, _ in sel:
            n = math.prod(shape)
            out[group][k] = flat[off: off + n].view(shape)
            off += n
    for group, k, shape, kind in specs:
        if kind == "zeros":
            out[group][k] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[group][k] = torch.ones(shape, device=device)
    return out


def _pick(cls, d: dict, **extra):
    names = {f.name for f in dataclasses.fields(cls)}
    tup = lambda v: tuple(tup(x) for x in v) if isinstance(v, list) else v
    return cls(**{k: tup(v) for k, v in d.items() if k in names}, **extra)


def port_config(c: dict):
    """The system's configuration object from the file's sizes."""
    from fangyan_tts_torch.config import CosyVoiceConfig, DiTConfig, FlowConfig, HiFTConfig, LLMConfig, QwenConfig

    f = c["flow"]
    llm = _pick(LLMConfig, c, qwen=_pick(QwenConfig, c))
    flow = _pick(FlowConfig, {k: v for k, v in f.items() if k != "dit"}, dit=_pick(DiTConfig, f["dit"]))
    return CosyVoiceConfig(version=VERSION, sample_rate=c["hift"]["sampling_rate"], token_mel_ratio=f["token_mel_ratio"],
                           chunk_size=c["chunk_size"], llm=llm, flow=flow, hift=_pick(HiFTConfig, c["hift"]))


def plan_len(n_text: int) -> int:
    """Tokens of an inference prompt [sos, text, task] without prompt speech."""
    return n_text + 2


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def stream_key(system, text, voice: dict, ratio: float) -> tuple:
    """The streaming decode's bucket (left-padded plan, cache): requests
    that share it share one continuous batch."""
    n_plan = len(voice["prompt_text"]) + plan_len(len(text)) + len(voice["llm_tokens"])
    tp = _round_up(n_plan, 64)
    return tp, _round_up(tp + _round_up(max(int(len(text) * ratio), 1), 256), 256)


def watch_llm_scheduler(system, lsched) -> None:
    """Spans around the LLM scheduler's shared decode chunks, and each
    stream's served tokens recorded as the scheduler hands them out (into
    the record the calling thread set on system._tl.rec)."""
    system.spans.wrap(lsched, "_run_chunk", "llm_chunk")
    real_open, real_stream = lsched.open, lsched.stream
    by_handle: dict = {}

    def open_(*a, **k):
        h = real_open(*a, **k)
        rec = getattr(system._tl, "rec", None)
        if rec is not None:
            by_handle[h] = rec["tokens"]
        return h

    def stream_(h):
        sink = by_handle.pop(h, [])
        for toks in real_stream(h):
            sink.append(np.asarray(toks))
            yield toks

    lsched.open, lsched.stream = open_, stream_


def stream_request(system, text, voice: dict, ratio: float, rec: dict):
    """One zero-shot `tts(stream=True)` request from a cached voice; yields
    its audio chunks, its served tokens recorded in rec["tokens"] (by
    watch_llm_scheduler)."""
    system._tl.rec = rec
    try:
        for out in system.tts.tts(text=text, flow_embedding=voice["xvec"], prompt_text=voice["prompt_text"],
                                  llm_prompt_speech_token=voice["llm_tokens"],
                                  flow_prompt_speech_token=voice["flow_tokens"], prompt_speech_feat=voice["feat"],
                                  stream=True, min_token_text_ratio=ratio, max_token_text_ratio=ratio):
            yield out["tts_speech"]
    finally:
        system._tl.rec = None


def free_program(system) -> None:
    """Drop the program and everything it made, before the references run."""
    system.tts = None
    system.spans.items.clear()
    gc.collect()
    if system.device.type == "cuda":
        torch.cuda.empty_cache()


def build_references(system, models: dict, int8: bool = False) -> dict:
    """The float32 references on the weights made again from the seed; with
    `int8` every weight of two or more dimensions rounded to int8 first (a
    control that puts the reference in the program's place)."""
    if system.device.type == "cuda":
        exact_float32()
    w = make_weights(system.c, system.seed, system.device, system.dtype, models)
    out = {}
    for name, ctor in models.items():
        with torch.device("meta"):
            m = ctor()
        sd = {k: (int8_rounded(v.float()) if int8 and v.dim() >= 2 else v.float()) for k, v in w[name].items()}
        m.load_state_dict(sd, strict=True, assign=True)
        out[name] = m.eval()
    return out


class System:
    """`params` are the cell's traffic parameters: `llm_width` turns on the
    continuous-batched LLM scheduler and `stream_width` the batched stream
    scheduler, at those widths."""

    def __init__(self, c: dict, seed: int, device: torch.device, params: dict | None = None):
        self.c, self.seed, self.device, self.params = c, int(seed), device, params or {}
        self._tl = threading.local()
        self.dtype = getattr(torch, c["dtype"])
        self.sample_rate = c["hift"]["sampling_rate"]
        self.spans = Spans(device.type == "cuda")
        self.tts = None

    def build(self) -> None:
        from fangyan_tts_torch.infer.tts import CosyVoice3TTS

        w = make_weights(self.c, self.seed, self.device, self.dtype)
        self.tts = CosyVoice3TTS(port_config(self.c), w["llm"], w["flow"], w["hift"], dtype=self.dtype,
                                 device=self.device)
        del w
        tok = lambda a, k, out: {"tokens": out[0], "counts": out[1], "texts": a[0]}
        mel = lambda a, k, out: {"mel": out[0], "token_len": out[1]}
        self.spans.wrap(self.tts, "_batch_tokens", "llm", keep=tok)
        self.spans.wrap(self.tts, "_batch_token2mel", "flow", keep=mel)
        self.spans.wrap(self.tts, "vocode_batch", "vocoder")
        if self.params.get("llm_width"):
            self.tts.enable_batched_llm(self.params["llm_width"])
            watch_llm_scheduler(self, self.tts.llm_scheduler)
        if self.params.get("stream_width"):
            self.tts.enable_batched_streaming(self.params["stream_width"])
            sched = self.tts.stream_scheduler
            real_open = sched.open

            def open_and_watch(*a, **k):  # each new group's batched steps get a span
                h = real_open(*a, **k)
                for groups in list(sched.groups.values()):
                    for g in groups:
                        if not getattr(g, "_bench_watched", False):
                            g._bench_watched = True
                            self.spans.wrap(g, "step", "hop")
                return h

            sched.open = open_and_watch

    def control(self, kind: str) -> None:
        """The program's own lower-precision path, in place of the served one."""
        if kind != "int8":
            raise ValueError(f"no control {kind!r}")
        self.tts.quantize_llm()
        self.tts.quantize_flow()

    # ---- what the traffic calls ---------------------------------------------------

    def batch(self, texts: list, prompt: dict, ratio: float) -> dict:
        """One batch_synthesize call; returns its wavs with the spans' record
        of the served tokens and mel."""
        wavs = self.tts.batch_synthesize(
            texts, flow_embedding=prompt["xvec"], prompt_text=prompt["instruct"],
            flow_prompt_speech_token=prompt["flow_tokens"], prompt_speech_feat=prompt["feat"],
            min_token_text_ratio=ratio, max_token_text_ratio=ratio)
        llm, flow = self.spans.named("llm")[-1], self.spans.named("flow")[-1]
        return {"wavs": wavs, "tokens": llm["tokens"], "counts": llm["counts"], "mel": flow["mel"],
                "token_len": flow["token_len"]}

    stream = stream_request
    stream_key = stream_key

    def stream_flops(self, s: dict, inputs: dict) -> float:
        """Model FLOPs of one finished stream: its prompt and decode, one
        chunk-masked solve over its prompt and tokens, its vocoder frames."""
        c = self.c
        voice = inputs["voices"][s["req"]["voice"]]
        n = sum(len(t) for t in s["tokens"])
        n_plan = len(voice["prompt_text"]) + plan_len(len(s["req"]["text"])) + len(voice["llm_tokens"])
        mel_len = (len(voice["flow_tokens"]) + n) * c["flow"]["token_mel_ratio"]
        return (counters.lm_sequence_flops(c, n_plan, n)
                + counters.dit_solve_flops(c["flow"], mel_len, c["flow"]["dit"]["static_chunk_size"])
                + n * c["flow"]["token_mel_ratio"] * counters.causal_hift_frame_flops(c["hift"]))

    def expected_samples(self, n_tokens: int) -> int:
        return n_tokens * self.c["flow"]["token_mel_ratio"] * total_upsample(self.c["hift"])

    # ---- the yardstick's view of the window's work ------------------------------------

    def batch_work(self, b: dict, prompt: dict, ratio: float) -> dict:
        """The kernel launches and model FLOPs of one completed batch, from
        the texts the benchmark made and the tokens its wrapper recorded."""
        c = self.c
        d = c["flow"]["dit"]
        texts = b["texts"]
        n_instr = len(prompt["instruct"])
        plens = [plan_len(n_instr + len(t)) for t in texts]
        tp = _round_up(max(plens), PLAN_BUCKET)
        max_lens = [int(len(t) * ratio) for t in texts]
        max_new = max(_round_up(max(max_lens), NEW_BUCKET), NEW_BUCKET)
        cache_len = _round_up(tp + max_new, CACHE_BUCKET)
        steps = max(max_lens)  # the loop stops once every row reached its length
        qh, kv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        decode = []
        for i in range(steps):
            w = counters.decode_attention_work(len(texts), cache_len, qh, kv, hd, sum(p + i + 1 for p in plens))
            decode += [w] * c["num_hidden_layers"]
        nfp = len(prompt["flow_tokens"])
        ratio_mel = c["flow"]["token_mel_ratio"]
        l_mel = _round_up(int(b["counts"].max()) + nfp, FLOW_BUCKET) * ratio_mel
        mel_len = [int(n) * ratio_mel for n in b["token_len"]]
        fw = counters.flash_attention_work(mel_len * 2, l_mel, d["heads"], d["dim_head"], 0)
        flash = [fw] * (c["flow"]["n_timesteps"] * d["depth"])
        flops = sum(counters.lm_sequence_flops(c, p, int(n)) for p, n in zip(plens, b["counts"]))
        flops += sum(counters.dit_solve_flops(c["flow"], m) for m in mel_len)
        flops += sum(mel_len) * counters.causal_hift_frame_flops(c["hift"])
        return {"decode_steps": steps, "launches": {"decode_attention": decode, "flash_attention": flash},
                "model_flops": flops}

    # ---- correctness -------------------------------------------------------------------

    free = free_program

    def references(self) -> dict:
        return build_references(self, reference_models(self.c))

    def check_utterances(self, utts: list[dict], prompt: dict) -> dict:
        """Numbers compared for offline utterances, each {"text", "tokens"
        (served, raw), "mel" (the program's, prompt frames first), "wav"}:
        the widest greedy gap of the served tokens and its mean over them
        all, the worst relative error of the mel and of the audio's STFT
        magnitudes, and the count of utterances whose length is not what
        their text asked for."""
        ref = self.references()
        c = self.c
        ratio_mel = c["flow"]["token_mel_ratio"]
        up = total_upsample(c["hift"])
        nfp = len(prompt["flow_tokens"])
        gap = mel_e = wav_e = 0.0
        bad_len = 0
        gaps = []
        for u in utts:
            served = np.asarray(u["tokens"], np.int64)
            if len(served) != u["expected_tokens"]:
                bad_len += 1
            text = np.concatenate([prompt["instruct"], u["text"]])
            logits = ref["llm"].served_logits(text, np.zeros(0, np.int64), served)
            gap = max(gap, greedy_gap(logits, served, c["speech_token_size"]))
            gaps.append(mean_gap(logits, served, c["speech_token_size"]) * len(served))
            kept = suppress_silent_runs(served)
            mel_ref = ref["flow"].mel(np.concatenate([prompt["flow_tokens"], kept]), prompt["feat"], prompt["xvec"])
            prog_mel = torch.as_tensor(u["mel"])[: mel_ref.shape[0]]
            mel_e = max(mel_e, rel_err(prog_mel, mel_ref))
            audio = ref["hift"].audio(mel_ref).cpu().numpy()
            start, n = nfp * ratio_mel * up, len(kept) * ratio_mel * up
            keep = n - TAIL_FRAMES * up
            wav = np.asarray(u["wav"])
            w_e = spectral_err(wav[:keep], audio[start: start + keep]) if len(wav) == n else float("inf")
            wav_e = max(wav_e, w_e)
            moved = (mel_ref - fixed_noise()[: mel_ref.shape[0]].to(mel_ref.device)).norm()
            note(f"utterance of {len(served)} tokens: gap {greedy_gap(logits, served, c['speech_token_size']):.5g} "
                 f"(mean {mean_gap(logits, served, c['speech_token_size']):.5g}), mel rel "
                 f"{rel_err(prog_mel, mel_ref):.5g} (of the move from the noise "
                 f"{float((prog_mel.to(mel_ref.device).float() - mel_ref).norm() / moved):.5g}), wav spectral {w_e:.5g}, "
                 f"wav rel {rel_err(wav[:keep], audio[start: start + keep]) if len(wav) == n else float('inf'):.5g}")
        n_served = sum(len(u["tokens"]) for u in utts)
        return {"lm_gap": gap, "lm_gap_mean": sum(gaps) / max(n_served, 1), "mel_rel": mel_e, "wav_spec_rel": wav_e,
                "length_errors": float(bad_len)}

    def check_streams(self, streams: list[dict], inputs: dict) -> dict:
        """Numbers compared for served streams, each with its request, voice,
        served tokens and audio chunks: the widest greedy gap of the served
        tokens and its mean, the relative error of the whole stream's STFT
        magnitudes against the chunk-masked reference flow and the vocoder
        over the target's whole mel, and the count of streams whose length is not
        what their text asked for."""
        ref = self.references()
        c = self.c
        ratio_mel = c["flow"]["token_mel_ratio"]
        up = total_upsample(c["hift"])
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
            g = greedy_gap(logits, served, c["speech_token_size"])
            gap = max(gap, g)
            gap_sum += mean_gap(logits, served, c["speech_token_size"]) * len(served)
            n_served += len(served)
            mel_ref = ref["flow"].mel(np.concatenate([voice["flow_tokens"], served]), voice["feat"], voice["xvec"],
                                      chunk=c["flow"]["dit"]["static_chunk_size"])
            # the stream vocodes the target's mel alone, from its first frame (as tts(stream=False) does)
            want = ref["hift"].audio(mel_ref[len(voice["flow_tokens"]) * ratio_mel:]).cpu().numpy()
            w_e = spectral_err(audio, want) if len(audio) == len(want) else float("inf")
            wav_e = max(wav_e, w_e)
            note(f"stream of {len(served)} tokens, {len(s['audio'])} chunks: gap {g:.5g} "
                 f"(mean {mean_gap(logits, served, c['speech_token_size']):.5g}), wav spectral {w_e:.5g}, "
                 f"wav rel {rel_err(audio, want) if len(audio) == len(want) else float('inf'):.5g}, "
                 f"{len(audio)} samples against {len(want)}")
        return {"lm_gap": gap, "lm_gap_mean": gap_sum / max(n_served, 1), "wav_spec_rel": wav_e,
                "length_errors": float(bad_len)}
