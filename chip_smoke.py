"""Drive the PyTorch/CUDA port (fangyan_tts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase; needs one CUDA card
    python3 chip_smoke.py --phases 1,2,3     # build and check the kernels only

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     TF32 off
  2. build every CUDA kernel of the port from csrc/ (one nvcc per source,
     all at once) and print the build time and ptxas report
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, with the tolerances below; kernel, plain and
     library (scaled_dot_product_attention, timed only) times
  4. a small model on the card against the same weights on the CPU
     (plain versions), then the offline path at full CosyVoice3-0.5B width
     with random weights: three requests through CosyVoice3TTS.tts, with
     the kernel launch counts read around them
  5. each stage of one request under torch.profiler: device busy time,
     idle share, device operations, largest kernels
  6. one JSON line of per-kernel results
The last line is {"ok": true, "device": {...}} and the exit code is 0 only
when every phase passed. Without a CUDA card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

# Kernel check inputs: k and v are N(0, 1) and q is N(0, QK_SCALE^2), so
# the scaled scores have a standard deviation of QK_SCALE and the softmax
# puts its weight on a few keys, as a trained model's does; the outputs are
# then of order 0.1-1 (their mean |.| is printed beside each limit).
QK_SCALE = 2.0
# Each kernel is held to its plain version run in float32 on the same bf16
# inputs (max |kernel - plain f32| over the valid rows):
DECODE_ATOL = 1e-2  # the kernel rounds only its output to bf16
FLASH_ATOL = 1.5e-2  # the kernel also rounds P to bf16 before P.V
MAX_LIMIT_SHARE = 0.15  # each limit must stay under this share of the mean |output| it is held to
# and it must be at least as close to that as the plain version run in bf16
# (the precision the JAX package's path runs at), whose scores and
# probabilities are rounded to bf16.
SMALL_REL_TOL = 5e-2  # small model, bf16 on the card vs bf16 plain on the CPU

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph,
    replayed `reps` times between two CUDA events (host launch cost
    excluded). Inputs stay in the 50 MB L2 between calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def eager_ms(fn, iters: int = 50) -> float:
    """Wall time of one eager call, launch cost included (what the main
    path pays per call)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def held(name: str, err: float, err_bf16: float, limit: float, scale: float) -> str:
    """Check a kernel's max error `err` against its plain version in float32:
    within `limit`, and no larger than the bf16 plain version's `err_bf16`.
    `scale` is the mean |plain f32| over the valid rows; a limit over
    MAX_LIMIT_SHARE of it would be too loose for this data, and raises."""
    if limit > MAX_LIMIT_SHARE * scale:
        raise AssertionError(f"{name}: limit {limit:.1e} is over {MAX_LIMIT_SHARE} of the mean |output| "
                             f"{scale:.3e}; the check would be too loose for this data")
    msg = (f"max|kernel-plain f32|={err:.3e} (limit {limit:.1e} = {limit / scale:.3f} of mean|plain f32|="
           f"{scale:.3e}; max|plain bf16-plain f32|={err_bf16:.3e})")
    if not err <= min(limit, err_bf16):
        raise AssertionError(f"{name} kernel disagrees with its plain version: {msg}")
    return msg


# ---------------------------------------------------------------- phase 3


def check_decode(results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from fangyan_tts_torch.ops import decode_attention as da

    nl, kv, hd, qh = 24, 2, 64, 14
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    # S = 256: the 150-token requests' cache; S = 768: the zero-shot request's (three tiles of slots)
    for b, s, idx_list in ((1, 256, [100]), (4, 256, [0, 100, 255, 300]), (1, 768, [700])):
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        q = (torch.randn((b, qh, hd), generator=gen, device=dev) * QK_SCALE).to(torch.bfloat16)
        kn, vn = rnd(b, kv, hd), rnd(b, kv, hd)
        ck, cv = rnd(nl, b, s, kv, hd), rnd(nl, b, s, kv, hd)
        idx = torch.tensor(idx_list, dtype=torch.int32, device=dev)
        valid = torch.clamp(idx, max=s - 1) + 1
        bias = torch.where(torch.arange(s, device=dev)[None, :] < valid[:, None], 0.0, -1e10).float().contiguous()
        for layer in (0, nl - 1):
            ck1, cv1, ck2, cv2, ck3, cv3 = ck.clone(), cv.clone(), ck.clone(), cv.clone(), ck.clone(), cv.clone()
            out_k = da.decode_attention(q, kn, vn, ck1, cv1, idx, bias, layer).float()
            out_p = da.decode_attention_plain(q, kn, vn, ck2, cv2, idx, bias, layer).float()
            # the plain version in float32 on the same inputs (a float32 q makes it cast K and V up)
            out_f = da.decode_attention_plain(q.float(), kn, vn, ck3, cv3, idx, bias, layer)
            torch.cuda.synchronize()
            err = (out_k - out_f).abs().max().item()
            msg = held("decode_attention", err, (out_p - out_f).abs().max().item(), DECODE_ATOL,
                       out_f.abs().mean().item())
            caches_equal = all(torch.equal(a, c) for a, c in ((ck1, ck2), (cv1, cv2), (ck1, ck3), (cv1, cv3)))
            finite = bool(torch.isfinite(out_k).all())
            rows.append(dict(b=b, layer=layer, err=err, caches_equal=caches_equal))
            log(f"decode_attention B={b} S={s} L={nl} layer={layer} idx={idx_list}: {msg} "
                f"caches bit-equal={caches_equal} finite={finite}")
            if not (caches_equal and finite):
                raise AssertionError("decode_attention kernel wrote other cache rows than its plain version")
        # timing at this shape (layer 0)
        run_k = lambda: da.decode_attention(q, kn, vn, ck, cv, idx, bias, 0)
        ms_k, ms_e = time_ms(run_k), eager_ms(run_k)
        ms_p = time_ms(lambda: da.decode_attention_plain(q, kn, vn, ck, cv, idx, bias, 0))
        kl = ck[0].permute(0, 2, 1, 3).contiguous()  # (B, KV, S, hd)
        vl = cv[0].permute(0, 2, 1, 3).contiguous()
        mask = (bias == 0)[:, None, None, :]
        q4 = q[:, :, None, :]
        ms_l = time_ms(lambda: F.scaled_dot_product_attention(q4, kl, vl, attn_mask=mask, enable_gqa=True))
        # what this data needs: q and out, the new rows read and written, K and
        # V of the slots the bias leaves open (a masked slot's weight is exactly
        # 0), the whole bias and idx; two products per (query head, open slot)
        open_slots = int((bias > -1e9).sum().item())
        nbytes = 2 * (b * qh * hd) * 2 + 2 * (b * kv * hd) * 2 * 2 + 2 * (open_slots * kv * hd) * 2 + b * s * 4 + b * 4
        flops = 2 * 2 * qh * hd * open_slots
        bms, by = bound(nbytes, flops)
        results.setdefault("decode_timing", []).append(
            dict(b=b, s=s, ms=ms_k, eager_ms=ms_e, plain_ms=ms_p, library_ms=ms_l, bound_ms=bms, bound_by=by))
        log(f"decode_attention B={b} S={s}: kernel {ms_k * 1e3:.2f} us (eager call {ms_e * 1e3:.1f} us), "
            f"plain {ms_p * 1e3:.1f} us, "
            f"sdpa {ms_l * 1e3:.1f} us, bound {bms * 1e3:.3f} us ({by})")
    results["decode_err"] = max(r["err"] for r in rows)


def check_flash(results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from fangyan_tts_torch.ops import flash_attention as fa
    from fangyan_tts_torch.ops.masks import chunk_attn_mask

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = []
    # L = 320: the 150-token requests (CFG pair, one length); L = 1344: the zero-shot request
    for l, mel in ((320, (320, 250)), (448, (448, 301)), (1344, (1300, 1300))):
        b, h, d = 2, 16, 64
        rnd = lambda scale: (torch.randn((b, h, l, d), generator=gen, device=dev) * scale).to(torch.bfloat16)
        q, k, v = rnd(QK_SCALE), rnd(1.0), rnd(1.0)
        mel_len = torch.tensor(mel, dtype=torch.int32, device=dev)
        for chunk in (0, 50):
            out_k = fa.chunk_flash_attention(q, k, v, mel_len, chunk)
            out_p = fa.chunk_flash_attention_plain(q, k, v, mel_len, chunk)
            out_f = fa.chunk_flash_attention_plain(q.float(), k.float(), v.float(), mel_len, chunk)
            torch.cuda.synchronize()
            valid = lambda t: torch.cat([t[bi, :, :mel[bi]].float().flatten() for bi in range(b)])  # rows < mel_len
            vk, vp, vf = valid(out_k), valid(out_p), valid(out_f)
            err = (vk - vf).abs().max().item()
            msg = held("chunk_flash_attention", err, (vp - vf).abs().max().item(), FLASH_ATOL, vf.abs().mean().item())
            finite = bool(torch.isfinite(out_k.float()).all())
            errs.append(err)
            log(f"chunk_flash_attention ({b},{h},{l},{d}) chunk={chunk} mel_len={mel}: {msg} all rows finite={finite}")
            if not finite:
                raise AssertionError("chunk_flash_attention kernel gave a row that is not finite")
            run_k = lambda: fa.chunk_flash_attention(q, k, v, mel_len, chunk)
            ms_k, ms_e = time_ms(run_k), eager_ms(run_k)
            ms_p = time_ms(lambda: fa.chunk_flash_attention_plain(q, k, v, mel_len, chunk))
            mask = chunk_attn_mask(mel_len, l, chunk)[:, None]  # (B, 1, L, L) bool, built outside the timing
            ms_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            pairs = int(mask.sum().item()) * h  # (query, key) pairs this data needs
            # q and out over every row; K and V only below each row's mel_len
            nbytes = 2 * b * h * l * d * 2 + sum(min(m, l) for m in mel) * h * d * 2 * 2 + b * 4
            bms, by = bound(nbytes, 4 * d * pairs)
            results.setdefault("flash_timing", []).append(
                dict(l=l, chunk=chunk, ms=ms_k, eager_ms=ms_e, plain_ms=ms_p, library_ms=ms_l, bound_ms=bms, bound_by=by,
                     dense_bound_ms=4 * b * h * l * l * d / BF16_FLOP_PER_S * 1e3))
            log(f"chunk_flash_attention L={l} chunk={chunk}: kernel {ms_k * 1e3:.2f} us (eager call "
                f"{ms_e * 1e3:.1f} us), plain {ms_p * 1e3:.1f} us, "
                f"sdpa {ms_l * 1e3:.1f} us, bound {bms * 1e3:.2f} us ({by})")
    results["flash_err"] = max(errs)


# ---------------------------------------------------------------- phase 4


def small_reference_check() -> None:
    """A small bf16 model (head dim 64, as the kernels take) on the card
    against the same weights on the CPU, where the plain versions run."""
    import torch

    from fangyan_tts_torch.config import CosyVoiceConfig, DiTConfig, FlowConfig, HiFTConfig, LLMConfig, QwenConfig
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS

    qwen = QwenConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=64, vocab_size=300)
    llm = LLMConfig(llm_input_size=128, llm_output_size=128, speech_token_size=50, extra_tokens=8, qwen=qwen,
                    top_k=1, tau_r=1.1)
    dit = DiTConfig(dim=128, depth=2, heads=2, dim_head=64, static_chunk_size=10)
    cfg = CosyVoiceConfig(llm=llm, flow=FlowConfig(vocab_size=50, dit=dit, n_timesteps=4, pre_lookahead_channels=64),
                          hift=HiFTConfig(base_channels=64, f0_cond_channels=32))
    ref = CosyVoice3TTS.random_init(cfg, dtype=torch.bfloat16, device="cpu", seed=3)
    sd = lambda m: {k: v.clone() for k, v in m.state_dict().items()}
    gpu = CosyVoice3TTS(cfg, sd(ref.llm), sd(ref.flow), sd(ref.hift), dtype=torch.bfloat16, device="cuda")

    # LLM: prefill + teacher-forced decode logits
    def logits(t: CosyVoice3TTS) -> np.ndarray:
        from fangyan_tts_torch.models.qwen2 import init_cache

        dev = t.device
        with torch.inference_mode():
            ids = torch.tensor([[llm.sos] + list(range(3, 15)) + [llm.task_id]], device=dev)
            src = torch.tensor([[1] + [0] * 12 + [1]], device=dev)
            lens = torch.tensor([14], device=dev)
            cache = init_cache(qwen, 1, 64, device=dev)
            out = [t.llm.decode_logits(t.llm.prefill_leftpad(src, ids, lens, cache))]
            start = torch.zeros(1, dtype=torch.int32, device=dev)
            for i, tok in enumerate([5, 9, 17, 33]):
                pos = torch.tensor([[14 + i]], device=dev)
                out.append(t.llm.decode_step(torch.tensor([tok], device=dev), pos, start, 14 + i + 1, cache))
            return torch.stack(out).float().cpu().numpy()

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))

    lg_g, lg_c = logits(gpu), logits(ref)
    r_llm = rel(lg_g, lg_c)
    argmax_eq = float((lg_g.argmax(-1) == lg_c.argmax(-1)).mean())
    rng = np.random.default_rng(0)
    req = dict(source_speech_token=rng.integers(0, 50, 37).astype(np.int32),
               flow_prompt_speech_token=rng.integers(0, 50, 6).astype(np.int32),
               prompt_speech_feat=(rng.standard_normal((12, 80)) * 0.5).astype(np.float32),
               flow_embedding=rng.standard_normal(192).astype(np.float32))
    mel_g = gpu.token2mel(req["source_speech_token"], req["flow_prompt_speech_token"], req["prompt_speech_feat"],
                          req["flow_embedding"])
    mel_c = ref.token2mel(req["source_speech_token"], req["flow_prompt_speech_token"], req["prompt_speech_feat"],
                          req["flow_embedding"])
    wav_g = next(gpu.tts(**req))["tts_speech"]
    wav_c = next(ref.tts(**req))["tts_speech"]
    r_mel, r_wav = rel(mel_g, mel_c), rel(wav_g, wav_c)
    ok = max(r_llm, r_mel, r_wav) <= SMALL_REL_TOL and wav_g.shape == wav_c.shape and np.isfinite(wav_g).all()
    log(f"small model card vs CPU: logits rel {r_llm:.3e} (argmax agreement {argmax_eq:.2f}), mel rel {r_mel:.3e}, "
        f"wav rel {r_wav:.3e} (limit {SMALL_REL_TOL}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the port on the card disagrees with its CPU path on a small model")


def full_path(results: dict, card: str):
    import torch

    from fangyan_tts_torch.config import CosyVoiceConfig
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS
    from fangyan_tts_torch.ops import decode_attention as da
    from fangyan_tts_torch.ops import flash_attention as fa

    cfg = CosyVoiceConfig()
    t0 = time.perf_counter()
    tts = CosyVoice3TTS.random_init(cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"random_init at full width (bf16, cuda): {time.perf_counter() - t0:.2f} s")

    # per-stage clocks and counts: wrap the instance's stage methods
    stage = {}

    def wrap(name, fn, note=None):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage[name] = stage.get(name, 0.0) + time.perf_counter() - t
            if note is not None:
                note(a, k, out)
            return out
        return inner

    steps = [0]
    inner_step = tts.llm.decode_step

    def counted_step(*a, **k):
        steps[0] += 1
        return inner_step(*a, **k)

    tts.llm.decode_step = counted_step
    mel_frames = []
    n_tokens = []
    tts.generate_tokens = wrap("llm", tts.generate_tokens, lambda a, k, out: n_tokens.append(len(out)))
    tts.token2mel = wrap("flow", tts.token2mel)
    tts.vocode = wrap("vocoder", tts.vocode, lambda a, k, out: mel_frames.append(a[0].shape[0]))

    rng = np.random.default_rng(0)
    text = rng.integers(0, 50000, 30).astype(np.int32)
    xvec = rng.standard_normal(192).astype(np.float32)
    zs = dict(text=text, prompt_text=rng.integers(0, 50000, 10).astype(np.int32),
              llm_prompt_speech_token=rng.integers(0, 6561, 50).astype(np.int32),
              flow_prompt_speech_token=rng.integers(0, 6561, 50).astype(np.int32),
              prompt_speech_feat=(rng.standard_normal((100, 80)) * 0.5).astype(np.float32), flow_embedding=xvec)
    fixed = dict(text=text, flow_embedding=xvec, min_token_text_ratio=5, max_token_text_ratio=5)
    requests = [("150 tokens (bench.py workload)", fixed), ("zero-shot prompt", zs),
                ("150 tokens, speed 1.1", dict(fixed, speed=1.1))]

    da.launches = 0
    fa.launches = 0
    for name, req in requests:
        stage.clear()
        steps[0] = 0
        d0, f0 = da.launches, fa.launches
        t = time.perf_counter()
        wav = next(tts.tts(**req))["tts_speech"]
        wall = time.perf_counter() - t
        n_dec, n_flash = da.launches - d0, fa.launches - f0
        frames = mel_frames[-1]
        audio_s = len(wav) / cfg.sample_rate
        ok = (np.isfinite(wav).all() and np.abs(wav).max() <= 0.99 and len(wav) == frames * 480
              and n_dec == cfg.llm.qwen.num_hidden_layers * steps[0] and steps[0] > 0
              and n_flash == cfg.flow.dit.depth * cfg.flow.n_timesteps)
        tok_s = n_tokens[-1] / stage["llm"]
        log(f"request '{name}': {n_tokens[-1]} tokens in {steps[0]} decode steps, {frames} mel frames, "
            f"{audio_s:.2f} s audio; decode {stage['llm']:.3f} s ({tok_s:.1f} tok/s, "
            f"{stage['llm'] / steps[0] * 1e3:.2f} ms/step), flow {stage['flow']:.3f} s, "
            f"vocoder {stage['vocoder']:.3f} s, wall {wall:.3f} s, RTF {wall / audio_s:.4f}; "
            f"launches decode {n_dec} flash {n_flash} [{card}] {'OK' if ok else 'FAIL'}")
        results.setdefault("requests", []).append(dict(
            name=name, tokens=n_tokens[-1], steps=steps[0], mel_frames=frames, tok_s=tok_s, audio_s=audio_s, llm_s=stage["llm"],
            flow_s=stage["flow"], vocoder_s=stage["vocoder"], wall_s=wall, rtf=wall / audio_s,
            decode_launches=n_dec, flash_launches=n_flash))
        if not ok:
            raise AssertionError(f"request '{name}' failed its checks")
    results["launches"] = {"decode_attention": da.launches, "chunk_flash_attention": fa.launches}
    return tts, fixed


def profile_stages(tts, req: dict, results: dict, card: str) -> None:
    """Each stage of one request under torch.profiler: wall time, device
    kernel time (sum of CUDA events), idle share, kernel count and the
    largest kernels. The profiler's own host cost is in the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    text = req["text"]
    tokens = tts.generate_tokens(text, min_token_text_ratio=5, max_token_text_ratio=5)
    mel = tts.token2mel(tokens, np.zeros(0, np.int32), np.zeros((0, 80), np.float32), req["flow_embedding"])
    stages = {
        "llm": lambda: tts.generate_tokens(text, min_token_text_ratio=5, max_token_text_ratio=5),
        "flow": lambda: tts.token2mel(tokens, np.zeros(0, np.int32), np.zeros((0, 80), np.float32),
                                      req["flow_embedding"]),
        "vocoder": lambda: tts.vocode(mel),
    }
    out = {}
    for name, fn in stages.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        by_name: dict = {}
        n = 0
        for e in prof.events():
            if e.device_type == cuda:
                n += 1
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        busy = sum(by_name.values()) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        out[name] = dict(wall_s=wall, device_s=busy, idle_share=1 - busy / wall, device_ops=n,
                         top=[[k[:60], v / 1e3] for k, v in top])
        log(f"profile {name}: wall {wall:.3f} s, device busy {busy:.4f} s, idle share {1 - busy / wall:.3f}, "
            f"{n} device ops [{card}]")
        for k, v in top:
            log(f"    {v / 1e3:9.3f} ms  {k[:90]}")
    results["profile"] = out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6", help="comma-separated phases to run (see above)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2
    from fangyan_tts_torch.ops import _build
    from fangyan_tts_torch.ops.device import exact_fp32

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    exact_fp32()
    results: dict = {}

    if 2 in phases:
        t = time.perf_counter()
        _build.build_all()
        log(f"kernel build: {time.perf_counter() - t:.2f} s for {', '.join(_build.SOURCES)}")
        for name, text in _build.build_logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "error" in line.lower():
                    log(f"  nvcc {name}: {line.strip()}")
    if 3 in phases:
        check_decode(results)
        check_flash(results)
    if 4 in phases:
        small_reference_check()
        tts, req = full_path(results, card)
        if 5 in phases:
            profile_stages(tts, req, results, card)
    if 6 in phases and 3 in phases and 4 in phases:
        # the zero-shot request's shapes: its 600-token decode holds most of the
        # main path's decode launches, and its flow the longest attention
        dt = next(r for r in results["decode_timing"] if r["s"] == 768)
        ft = next(r for r in results["flash_timing"] if r["l"] == 1344 and r["chunk"] == 0)
        kernels = [
            dict(name="decode_attention", route="cuda", source="fangyan_tts_torch/csrc/decode_attention.cu",
                 replaces="fangyan_tts_tpu/ops/decode_attention.py:124",
                 launches=results["launches"]["decode_attention"], max_abs_err=results["decode_err"],
                 ms=dt["ms"], plain_ms=dt["plain_ms"], bound_ms=dt["bound_ms"], bound_by=dt["bound_by"],
                 library_ms=dt["library_ms"]),
            dict(name="chunk_flash_attention", route="cuda", source="fangyan_tts_torch/csrc/flash_attention.cu",
                 replaces="fangyan_tts_tpu/ops/flash_attention.py:78",
                 launches=results["launches"]["chunk_flash_attention"], max_abs_err=results["flash_err"],
                 ms=ft["ms"], plain_ms=ft["plain_ms"], bound_ms=ft["bound_ms"], bound_by=ft["bound_by"],
                 library_ms=ft["library_ms"]),
        ]
        log("detail: " + json.dumps({k: results[k] for k in ("decode_timing", "flash_timing", "requests", "profile")
                                     if k in results}))
        log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failure is a failed run: report it and exit non-zero
        traceback.print_exc()
        sys.exit(1)
