"""Drive the PyTorch/CUDA port (fangyan_tts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase; needs one CUDA card
    python3 chip_smoke.py --phases 1,2,3     # build and check the kernels only

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     TF32 off
  2. build every CUDA kernel of the port from csrc/ (one nvcc per source,
     all at once) and print the build time and ptxas report
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes (the single requests', and the batches of 16 as
     worked out from their own buckets), with the tolerances below, and
     decode attention also with a row that has no open slot, write slots on
     a block boundary of its launch plan, one long cache (S = 4096) and
     strided q / k_new / v_new views (bit-equal to the contiguous call);
     kernel, plain and library times (timed only:
     scaled_dot_product_attention for the attention kernels, F.linear on the
     dequantized weight for int4_matmul)
  4. a small model on the card against the same weights on the CPU
     (plain versions), bf16 and then int8 LLM + int4 MLP + int8 DiT; then
     at full CosyVoice3-0.5B width with random weights: three requests
     through CosyVoice3TTS.tts (bf16), and two batched requests of 16
     through batch_synthesize, (a) in the int8 LLM mode and (b) in the
     int8 + int4 MLP + int8 DiT mode; the kernel launch counts are set to
     0 before each run and read after it, and each run fails if it
     launched a kernel at a shape that phase 3 did not check
  5. each stage under torch.profiler, for the 150-token request and the
     batched requests: device busy time, idle share, device operations,
     largest kernels
  6. one JSON line of per-kernel results
The last line is {"ok": true, "device": {...}} and the exit code is 0 only
when every phase passed. Without a CUDA card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
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
INT4_ATOL = 3e-2  # the kernel rounds only its output to bf16: half an ulp of outputs up to about 5
MAX_LIMIT_SHARE = 0.15  # each limit must stay under this share of the mean |output| it is held to
# and it must be at least as close to that as the plain version run in bf16
# (the precision the JAX package's path runs at), whose scores and
# probabilities are rounded to bf16.
SMALL_REL_TOL = 5e-2  # small model, bf16 on the card vs bf16 plain on the CPU

CARDS_USED = 1  # every phase runs on card 0
PORT_KERNELS = ("decode_attention", "flash_attention", "int4_matmul")  # kernel names the profile reports
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12


_START = time.perf_counter()


def log(msg: str, stamp: bool = True) -> None:
    """Print a line, by default after the seconds since the script started."""
    print(f"[{time.perf_counter() - _START:7.1f} s] {msg}" if stamp else msg, flush=True)


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


def cycling(fn, n: int):
    """A call that passes 0, 1, ..., n-1, 0, ... to `fn` on successive calls
    (to walk over n copies of a weight, as the layers of a model do)."""
    it = itertools.cycle(range(n))
    return lambda: fn(next(it))


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


def batch_requests_spec() -> tuple[dict, dict]:
    """The batch_synthesize arguments of requests (a) and (b) (see
    batched_requests)."""
    rng = np.random.default_rng(1)
    xvec = rng.standard_normal(192).astype(np.float32)
    req_a = dict(texts=[rng.integers(0, 50000, 30).astype(np.int32) for _ in range(16)], flow_embedding=xvec,
                 min_token_text_ratio=5, max_token_text_ratio=5)
    req_b = dict(texts=[rng.integers(0, 50000, int(n)).astype(np.int32) for n in rng.integers(12, 41, 16)],
                 flow_embedding=xvec, prompt_text=rng.integers(0, 50000, 10).astype(np.int32),
                 llm_prompt_speech_token=rng.integers(0, 6561, 50).astype(np.int32),
                 flow_prompt_speech_token=rng.integers(0, 6561, 50).astype(np.int32),
                 prompt_speech_feat=(rng.standard_normal((100, 80)) * 0.5).astype(np.float32),
                 min_token_text_ratio=5, max_token_text_ratio=5)
    return req_a, req_b


def batch_shapes(req: dict) -> dict:
    """The kernel shapes a batch_synthesize request gives, from the port's
    own buckets (infer/tts.batch_buckets): B rows, a prefill of B x tp rows,
    the cache length, and the flow length of the longest row (the requests'
    min and max ratios are equal, so every row stops at its max length)."""
    from fangyan_tts_torch.config import CosyVoiceConfig
    from fangyan_tts_torch.infer.tts import batch_buckets

    cfg = CosyVoiceConfig()
    texts, ratio = req["texts"], req["max_token_text_ratio"]
    _, tp, _, cache_len = batch_buckets(cfg.llm, texts, req.get("prompt_text", np.zeros(0, np.int32)),
                                        req.get("llm_prompt_speech_token", np.zeros(0, np.int32)), ratio)
    longest = max(int(len(t) * ratio) for t in texts) + len(req.get("flow_prompt_speech_token", ()))
    return dict(b=len(texts), tp=tp, prefill_m=len(texts) * tp, cache_len=cache_len,
                l_mel=-(-longest // 64) * 64 * cfg.token_mel_ratio)


def _checked(results: dict, kernel: str, key: tuple) -> None:
    results.setdefault("checked", {}).setdefault(kernel, set()).add(key)


# ---------------------------------------------------------------- phase 3


def check_decode(results: dict, batches: list[dict]) -> None:
    import torch
    import torch.nn.functional as F

    from fangyan_tts_torch.ops import decode_attention as da

    nl, kv, hd, qh = 24, 2, 64, 14
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    # S = 256: the 150-token requests' cache (B = 4: a write past the end, clamped, and a row with no
    # open slot, start 256); S = 768: the zero-shot request's; B = 16: the batched requests' caches,
    # left-padded rows whose first valid slot differs; B = 2: write slots on each side of the first
    # block boundary of the launch plan; S = 4096: one long cache (a block of 512 slots)
    starts16 = [int(v) for v in np.random.default_rng(5).integers(0, 40, 16)]
    edge = da.plan(2, 256, kv)[1]
    shapes = [(1, 256, [100], [0]), (4, 256, [0, 100, 255, 300], [0, 0, 0, 256]), (1, 768, [700], [0]),
              (2, 256, [edge - 1, edge], [0, 0]), (1, 4096, [4000], [0])]
    for s in sorted({sh["cache_len"] for sh in batches}):
        shapes.append((16, s, [s - 56] * 16, starts16))
    for b, s, idx_list, starts in shapes:
        _checked(results, "decode_attention", (b, s))
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        q = (torch.randn((b, qh, hd), generator=gen, device=dev) * QK_SCALE).to(torch.bfloat16)
        kn, vn = rnd(b, kv, hd), rnd(b, kv, hd)
        ck, cv = rnd(nl, b, s, kv, hd), rnd(nl, b, s, kv, hd)
        idx = torch.tensor(idx_list, dtype=torch.int32, device=dev)
        valid = torch.clamp(idx, max=s - 1) + 1
        slot = torch.arange(s, device=dev)[None, :]
        first = torch.tensor(starts, device=dev)[:, None]
        bias = torch.where((slot >= first) & (slot < valid[:, None]), 0.0, -1e10).float().contiguous()
        # the caller's layout too: q, k_new and v_new as views of one fused qkv row per batch row
        # (models/qwen2.py), which must give the contiguous call's output and writes bit for bit
        qkv = torch.cat([q.reshape(b, -1), kn.reshape(b, -1), vn.reshape(b, -1)], dim=1)
        views = (qkv[:, : qh * hd].view(b, qh, hd), qkv[:, qh * hd: (qh + kv) * hd].view(b, kv, hd),
                 qkv[:, (qh + kv) * hd:].view(b, kv, hd))
        ck4, cv4 = ck.clone(), cv.clone()
        out_v = da.decode_attention(*views, ck4, cv4, idx, bias, 0)
        ck5, cv5 = ck.clone(), cv.clone()
        out_c = da.decode_attention(q, kn, vn, ck5, cv5, idx, bias, 0)
        torch.cuda.synchronize()
        same = torch.equal(out_v, out_c) and torch.equal(ck4, ck5) and torch.equal(cv4, cv5)
        log(f"decode_attention B={b} S={s} plan {da.plan(b, s, kv)} (blocks a cluster, slots a block): strided "
            f"q/k_new/v_new views (batch stride {qkv.stride(0)}) equal to the contiguous call={same}")
        if not same:
            raise AssertionError("decode_attention kernel on strided views differs from the contiguous call")
        del ck4, cv4, ck5, cv5
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
            log(f"decode_attention B={b} S={s} L={nl} layer={layer} idx={idx_list[:4]} starts={starts[:4]}: {msg} "
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


def check_flash(results: dict, batches: list[dict]) -> None:
    import torch
    import torch.nn.functional as F

    from fangyan_tts_torch.ops import flash_attention as fa
    from fangyan_tts_torch.ops.masks import chunk_attn_mask

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = []
    # L = 320: the 150-token requests (CFG pair, one length); L = 1344: the zero-shot request;
    # 2B = 32 rows: the batched requests, ragged mel_len, each length twice (the CFG pair)
    rag = np.random.default_rng(6)
    shapes = [(320, (320, 250)), (448, (448, 301)), (1344, (1300, 1300))]
    for l in sorted({sh["l_mel"] for sh in batches}):
        shapes.append((l, tuple(int(v) for v in rag.integers(l * 5 // 8, l + 1, 16)) * 2))
    # the DiT's own layout too: q and k (B, L, H*D) projections and v a slice of the (B, L, 3*H*D) qkv
    # buffer, each viewed as (B, H, L, D) without a copy (models/dit.py); L = 1344 and the larger batch
    strided = {1344, max(sh["l_mel"] for sh in batches)}
    for (l, mel), layout in [(sh, "contiguous") for sh in shapes] + [(sh, "strided") for sh in shapes
                                                                     if sh[0] in strided]:
        b, h, d = len(mel), 16, 64
        _checked(results, "chunk_flash_attention", (b, l))
        rnd = lambda shape, scale: (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)
        if layout == "contiguous":
            q, k, v = rnd((b, h, l, d), QK_SCALE), rnd((b, h, l, d), 1.0), rnd((b, h, l, d), 1.0)
        else:
            heads = lambda t: t.reshape(b, l, h, d).transpose(1, 2)
            qkv = rnd((b, l, 3 * h * d), 1.0)
            q, k = heads(rnd((b, l, h * d), QK_SCALE)), heads(rnd((b, l, h * d), 1.0))
            v = heads(qkv[..., 2 * h * d:])
        mel_len = torch.tensor(mel, dtype=torch.int32, device=dev)
        for chunk in (0, 50):
            out_k = fa.chunk_flash_attention(q, k, v, mel_len, chunk)
            out_p = fa.chunk_flash_attention_plain(q, k, v, mel_len, chunk)
            out_f = fa.chunk_flash_attention_plain(q.float(), k.float(), v.float(), mel_len, chunk)
            same = True
            if layout == "strided":  # the layout must not change a bit of the result
                same = torch.equal(out_k, fa.chunk_flash_attention(*(t.contiguous() for t in (q, k, v)), mel_len, chunk))
            torch.cuda.synchronize()
            valid = lambda t: torch.cat([t[bi, :, :mel[bi]].float().flatten() for bi in range(b)])  # rows < mel_len
            vk, vp, vf = valid(out_k), valid(out_p), valid(out_f)
            err = (vk - vf).abs().max().item()
            msg = held("chunk_flash_attention", err, (vp - vf).abs().max().item(), FLASH_ATOL, vf.abs().mean().item())
            finite = bool(torch.isfinite(out_k.float()).all())
            errs.append(err)
            log(f"chunk_flash_attention ({b},{h},{l},{d}) {layout} chunk={chunk} mel_len={mel[:4]}: {msg} "
                f"all rows finite={finite}" + (f" equal to the contiguous call={same}" if layout == "strided" else ""))
            if not (finite and same):
                raise AssertionError("chunk_flash_attention kernel gave a row that is not finite, or a strided "
                                     "call that differs from the contiguous one")
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
                dict(b=b, l=l, chunk=chunk, layout=layout, ms=ms_k, eager_ms=ms_e, plain_ms=ms_p, library_ms=ms_l,
                     bound_ms=bms, bound_by=by, dense_bound_ms=4 * b * h * l * l * d / BF16_FLOP_PER_S * 1e3))
            log(f"chunk_flash_attention B={b} L={l} {layout} chunk={chunk}: kernel {ms_k * 1e3:.2f} us (eager call "
                f"{ms_e * 1e3:.1f} us), plain {ms_p * 1e3:.1f} us, "
                f"sdpa {ms_l * 1e3:.1f} us, bound {bms * 1e3:.2f} us ({by})")
    results["flash_err"] = max(errs)


def check_int4(results: dict, batch_b: dict) -> None:
    """int4_matmul at the LLM's MLP shapes: M = 1 and 512, and the two that
    request (b) runs, its decode (M = B = 16) and its prefill (M = B x tp);
    and one M on each side of the launch plan's route boundary (16 | 17,
    between the 16-token decode blocks and the 128-token blocks) and
    M = 100, which is no multiple of a tile. The block's channels (64, 128 or
    256) and the cluster split follow from M and N; gate_up_proj and
    down_proj at these M take each of them.
    The weights are N(0, 1/K) quantized by the port, x is N(0, 1), so
    outputs are of order one. Times cycle over 24 weight copies (the 24
    layers), so the packed weight is read from device memory and not from
    L2, as on the main path."""
    import torch
    import torch.nn.functional as F

    from fangyan_tts_torch.ops import int4_matmul as i4
    from fangyan_tts_torch.ops.quant import quantize_int4_packed, unpack_int4

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = []
    for name, k, n in (("gate_up_proj", 896, 9728), ("down_proj", 4864, 896)):
        copies = [quantize_int4_packed(torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k))
                  for _ in range(24)]
        w, s = copies[0]
        # the library call's weight: dequantized, scale folded in, torch's (N, K)
        lib_w = [(unpack_int4(wc).float() * sc).t().contiguous().to(torch.bfloat16) for wc, sc in copies]
        edges = {i4.DECODE_TILE_M, i4.DECODE_TILE_M + 1, 100}
        for m in sorted({1, 512, batch_b["b"], batch_b["prefill_m"]} | edges):
            _checked(results, "int4_matmul", (m, k, n))
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            out_k = i4.int4_matmul(x, w, s).float()
            out_p = i4.int4_matmul_plain(x, w, s).float()
            out_f = i4.int4_matmul_plain(x.float(), w, s)
            torch.cuda.synchronize()
            err = (out_k - out_f).abs().max().item()
            msg = held("int4_matmul", err, (out_p - out_f).abs().max().item(), INT4_ATOL, out_f.abs().mean().item())
            finite = bool(torch.isfinite(out_k).all())
            errs.append(err)
            tile_m, tile_n, cs, per = i4.plan(m, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
            log(f"int4_matmul {name} M={m} K={k} N={n} (block {tile_m} tokens x {tile_n} channels, cluster {cs} x "
                f"{per} K steps): {msg} finite={finite}")
            if not finite:
                raise AssertionError("int4_matmul kernel gave a value that is not finite")
            run_k = cycling(lambda i: i4.int4_matmul(x, *copies[i]), len(copies))
            ms_k, ms_e = time_ms(run_k, iters=len(copies)), eager_ms(run_k, iters=2 * len(copies))
            ms_p = time_ms(cycling(lambda i: i4.int4_matmul_plain(x, *copies[i]), len(copies)), iters=len(copies))
            ms_l = time_ms(cycling(lambda i: F.linear(x, lib_w[i]), len(copies)), iters=len(copies))
            nbytes = m * k * 2 + k * n // 2 + n * 4 + m * n * 2
            bms, by = bound(nbytes, 2 * m * k * n)
            results.setdefault("int4_timing", []).append(
                dict(proj=name, m=m, k=k, n=n, tile_m=tile_m, tile_n=tile_n, cluster=cs, ms=ms_k, eager_ms=ms_e,
                     plain_ms=ms_p, library_ms=ms_l, bound_ms=bms, bound_by=by))
            log(f"int4_matmul {name} M={m}: kernel {ms_k * 1e3:.2f} us (eager call {ms_e * 1e3:.1f} us), "
                f"plain {ms_p * 1e3:.1f} us, F.linear on the dequantized weight {ms_l * 1e3:.2f} us, "
                f"bound {bms * 1e3:.3f} us ({by})")
        del copies, lib_w
    results["int4_err"] = max(errs)


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

    rng = np.random.default_rng(0)
    req = dict(source_speech_token=rng.integers(0, 50, 37).astype(np.int32),
               flow_prompt_speech_token=rng.integers(0, 50, 6).astype(np.int32),
               prompt_speech_feat=(rng.standard_normal((12, 80)) * 0.5).astype(np.float32),
               flow_embedding=rng.standard_normal(192).astype(np.float32))
    for mode in ("bf16", "int8 LLM with int4 MLP, int8 DiT"):
        if mode != "bf16":
            for t in (gpu, ref):
                t.quantize_llm(int4_mlp=True)
                t.quantize_flow()
        lg_g, lg_c = logits(gpu), logits(ref)
        r_llm = rel(lg_g, lg_c)
        argmax_eq = float((lg_g.argmax(-1) == lg_c.argmax(-1)).mean())
        mel_g, mel_c = (t.token2mel(req["source_speech_token"], req["flow_prompt_speech_token"],
                                    req["prompt_speech_feat"], req["flow_embedding"]) for t in (gpu, ref))
        wav_g = next(gpu.tts(**req))["tts_speech"]
        wav_c = next(ref.tts(**req))["tts_speech"]
        r_mel, r_wav = rel(mel_g, mel_c), rel(wav_g, wav_c)
        ok = max(r_llm, r_mel, r_wav) <= SMALL_REL_TOL and wav_g.shape == wav_c.shape and np.isfinite(wav_g).all()
        log(f"small model card vs CPU ({mode}): logits rel {r_llm:.3e} (argmax agreement {argmax_eq:.2f}), "
            f"mel rel {r_mel:.3e}, wav rel {r_wav:.3e} (limit {SMALL_REL_TOL}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the port on the card disagrees with its CPU path on a small model ({mode})")


def clocked(stage: dict, name: str, fn, note=None):
    """`fn` with its wall time (synchronised before and after) added to
    stage[name]; note(args, kwargs, result) sees each call."""
    import torch

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


def counted_steps(tts) -> list:
    """Count the LLM's decode steps: a one-element list the wrapper bumps."""
    steps = [0]
    inner_step = tts.llm.decode_step

    def step(*a, **k):
        steps[0] += 1
        return inner_step(*a, **k)

    tts.llm.decode_step = step
    return steps


def _count(results: dict, counts: dict) -> None:
    """Add one main-path run's kernel launches to the totals."""
    tot = results.setdefault("launches", {})
    for k, v in counts.items():
        tot[k] = tot.get(k, 0) + v


@contextlib.contextmanager
def kernel_shapes(results: dict, label: str):
    """Record the shape of every kernel call the models make inside the
    block (decode attention (B, S), flash attention (rows, L), int4 matmul
    (M, K, N)); after it, fail if phase 3 ran and did not check one of them.
    The hooks count nothing: the launch counters stay in the wrappers."""
    from fangyan_tts_torch.models import dit, qwen2

    hooks = ((qwen2, "decode_attention", lambda a: (a[3].shape[1], a[3].shape[2])),
             (dit, "chunk_flash_attention", lambda a: (a[0].shape[0], a[0].shape[2])),
             (qwen2, "int4_matmul", lambda a: (a[0].numel() // a[0].shape[-1], a[0].shape[-1], a[1].shape[1])))
    seen: dict = {}
    saved = []
    for mod, name, key in hooks:
        inner = getattr(mod, name)
        saved.append((mod, name, inner))

        def hooked(*a, _inner=inner, _name=name, _key=key, **k):
            seen.setdefault(_name, set()).add(tuple(int(v) for v in _key(a)))
            return _inner(*a, **k)
        setattr(mod, name, hooked)
    try:
        yield
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    log(f"kernel shapes of {label}: " + "; ".join(f"{k} {sorted(v)}" for k, v in sorted(seen.items())))
    if "checked" in results:
        missing = {k: sorted(v - results["checked"].get(k, set())) for k, v in seen.items()}
        if any(missing.values()):
            raise AssertionError(f"{label} launched kernel shapes that phase 3 did not check: {missing}")


def full_path(results: dict, card: str):
    """The three single offline requests through CosyVoice3TTS.tts, bf16."""
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
    steps = counted_steps(tts)
    mel_frames = []
    n_tokens = []
    tts.generate_tokens = clocked(stage, "llm", tts.generate_tokens, lambda a, k, out: n_tokens.append(len(out)))
    tts.token2mel = clocked(stage, "flow", tts.token2mel)
    tts.vocode = clocked(stage, "vocoder", tts.vocode, lambda a, k, out: mel_frames.append(a[0].shape[0]))

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

    for name, req in requests:
        stage.clear()
        steps[0] = 0
        da.launches = fa.launches = 0
        with kernel_shapes(results, f"request '{name}'"):
            t = time.perf_counter()
            wav = next(tts.tts(**req))["tts_speech"]
            wall = time.perf_counter() - t
        n_dec, n_flash = da.launches, fa.launches
        _count(results, {"decode_attention": n_dec, "chunk_flash_attention": n_flash})
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
    return tts, fixed


def batched_requests(results: dict, card: str) -> dict:
    """The dataset-generation path: 16 utterances a request through
    CosyVoice3TTS.batch_synthesize at full width, random bf16 weights.
    (a) bench.py's bs16 workload in the runner's default int8 LLM mode: 16
    texts of 30 tokens, no prompt, exactly 150 tokens a row. (b) the int8
    LLM with an int4 MLP and an int8 DiT: 16 texts of 12-40 tokens sharing
    a voice prompt. Each request runs twice (the first run pays the card's
    first-use costs at these shapes); launches are counted on each run."""
    import torch

    from fangyan_tts_torch.config import CosyVoiceConfig
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS, suppress_silent_runs
    from fangyan_tts_torch.ops import decode_attention as da
    from fangyan_tts_torch.ops import flash_attention as fa
    from fangyan_tts_torch.ops import int4_matmul as i4

    cfg = CosyVoiceConfig()
    nl, depth, nt = cfg.llm.qwen.num_hidden_layers, cfg.flow.dit.depth, cfg.flow.n_timesteps
    req_a, req_b = batch_requests_spec()
    out = {}
    for key, name, req, mode in (("a_bf16", "(a) in bf16, the unquantized reference", req_a, None),
                                 ("a", "(a) bs16 x 150 tokens, int8 LLM", req_a, "int8"),
                                 ("b", "(b) bs16 prompted, int8 LLM + int4 MLP, int8 DiT", req_b, "int4")):
        int4 = mode == "int4"
        t0 = time.perf_counter()
        tts = CosyVoice3TTS.random_init(cfg, dtype=torch.bfloat16)
        if mode is not None:
            tts.quantize_llm(int4_mlp=int4)
        if int4:
            tts.quantize_flow()
        torch.cuda.synchronize()
        log(f"request {name}: random_init and quantization at full width: {time.perf_counter() - t0:.2f} s")
        stage = {}
        steps = counted_steps(tts)
        made = []
        tts._batch_tokens = clocked(stage, "llm", tts._batch_tokens, lambda a, k, o: made.append(o))
        tts._batch_token2mel = clocked(stage, "flow", tts._batch_token2mel)
        tts.vocode_batch = clocked(stage, "vocoder", tts.vocode_batch)
        for run in (1, 2):
            stage.clear()
            steps[0] = 0
            da.launches = fa.launches = i4.launches = 0
            with kernel_shapes(results, f"request {name}, run {run}"):
                t = time.perf_counter()
                wavs = tts.batch_synthesize(**req)
                wall = time.perf_counter() - t
            counts = {"decode_attention": da.launches, "chunk_flash_attention": fa.launches,
                      "int4_matmul": i4.launches}
            _count(results, counts)
            toks, n = made[-1]
            n_tok = [len(suppress_silent_runs(toks[i, : n[i]])) for i in range(len(n))]
            want = {"decode_attention": nl * steps[0], "chunk_flash_attention": depth * nt,
                    "int4_matmul": 2 * nl * (1 + steps[0]) if int4 else 0}
            audio_s = sum(len(w) for w in wavs) / cfg.sample_rate
            ok = (len(wavs) == 16 and steps[0] > 0 and counts == want
                  and all(np.isfinite(w).all() and np.abs(w).max() <= 0.99 and len(w) == k * 2 * 480
                          for w, k in zip(wavs, n_tok)))
            log(f"request {name}, run {run}: {sum(n_tok)} tokens ({min(n_tok)}-{max(n_tok)} a row) in {steps[0]} "
                f"decode steps, {audio_s:.2f} s audio; LLM {stage['llm']:.3f} s "
                f"({stage['llm'] / steps[0] * 1e3:.2f} ms/step, {sum(n_tok) / stage['llm']:.1f} tok/s), "
                f"flow {stage['flow']:.3f} s, vocoder {stage['vocoder']:.3f} s, wall {wall:.3f} s, "
                f"batch RTF {wall / audio_s:.5f}; launches {counts} (derived {want}) [{card}] "
                f"{'OK' if ok else 'FAIL'}")
            results.setdefault("batch_requests", []).append(dict(
                name=name, run=run, tokens=sum(n_tok), steps=steps[0], audio_s=audio_s, llm_s=stage["llm"],
                flow_s=stage["flow"], vocoder_s=stage["vocoder"], wall_s=wall, rtf=wall / audio_s, launches=counts))
            if not ok:
                raise AssertionError(f"request {name} failed its checks")
        out[key] = (tts, req)
    return out


def _profile(stages: dict, card: str, label: str) -> dict:
    """Each stage under torch.profiler: wall time, device kernel time (sum
    of CUDA events), idle share, kernel count, the largest kernels, and the
    port's own kernels (their time, launches and time a launch in place,
    whether or not they are among the largest). The profiler's own host cost
    is in the wall time. Only device activity is recorded: reading back the
    host events of a 150-step decode took over a minute per stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for name, fn in stages.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        by_name: dict = {}
        calls: dict = {}
        n = 0
        for e in prof.events():
            if e.device_type == cuda:
                n += 1
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
                calls[e.name] = calls.get(e.name, 0) + 1
        busy = sum(by_name.values()) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        ours = {k: (v, calls[k]) for k, v in by_name.items() if any(p in k for p in PORT_KERNELS)}
        out[name] = dict(wall_s=wall, device_s=busy, idle_share=1 - busy / wall, device_ops=n,
                         top=[[k[:60], v / 1e3] for k, v in top],
                         port_kernels=[[k[:60], v / 1e3, c] for k, (v, c) in sorted(ours.items())])
        log(f"profile {label} {name}: wall {wall:.3f} s, device busy {busy:.4f} s, idle share "
            f"{1 - busy / wall:.3f}, {n} device ops [{card}]")
        for k, v in top:
            log(f"    {v / 1e3:9.3f} ms  {k[:90]}")
        for k, (v, c) in sorted(ours.items()):
            log(f"    port kernel {k[:60]}: {v / 1e3:.3f} ms over {c} launches, {v / c:.2f} us a launch in place")
    return out


def profile_stages(tts, req: dict, results: dict, card: str) -> None:
    """The stages of the single 150-token request, bf16."""
    text = req["text"]
    tokens = tts.generate_tokens(text, min_token_text_ratio=5, max_token_text_ratio=5)
    no_prompt = (np.zeros(0, np.int32), np.zeros((0, 80), np.float32))
    mel = tts.token2mel(tokens, *no_prompt, req["flow_embedding"])
    results["profile"] = _profile({
        "llm": lambda: tts.generate_tokens(text, min_token_text_ratio=5, max_token_text_ratio=5),
        "flow": lambda: tts.token2mel(tokens, *no_prompt, req["flow_embedding"]),
        "vocoder": lambda: tts.vocode(mel),
    }, card, "150 tokens, bf16")


def profile_batch(tts, req: dict, card: str, label: str, llm_only: bool = False) -> dict:
    """The stages of one batch_synthesize request."""
    args = (req["texts"], req.get("prompt_text", np.zeros(0, np.int32)),
            req.get("llm_prompt_speech_token", np.zeros(0, np.int32)),
            req["min_token_text_ratio"], req["max_token_text_ratio"])
    stages = {"llm": lambda: tts._batch_tokens(*args)}
    if not llm_only:
        toks, n = tts._batch_tokens(*args)
        fp = np.asarray(req.get("flow_prompt_speech_token", np.zeros(0, np.int32)), np.int32)
        pf = np.asarray(req.get("prompt_speech_feat", np.zeros((0, 80), np.float32)), np.float32)
        mel, _ = tts._batch_token2mel(toks, n, fp, pf, req["flow_embedding"])
        stages["flow"] = lambda: tts._batch_token2mel(toks, n, fp, pf, req["flow_embedding"])
        stages["vocoder"] = lambda: tts.vocode_batch(mel)
    return _profile(stages, card, label)


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
                if any(w in line.lower() for w in ("registers", "spill", "error", "warning")):
                    log(f"  nvcc {name}: {line.strip()}")
    if 3 in phases:
        batches = [batch_shapes(r) for r in batch_requests_spec()]
        log(f"batched requests' shapes (a), (b): {batches}")
        check_decode(results, batches)
        check_flash(results, batches)
        check_int4(results, batches[1])
    if 4 in phases:
        small_reference_check()
        tts, req = full_path(results, card)
        batched = batched_requests(results, card)
        if 5 in phases:
            profile_stages(tts, req, results, card)
            (tts_a, req_a), (tts_b, req_b) = batched["a"], batched["b"]
            results["profile_batch"] = {
                "a_int8": profile_batch(tts_a, req_a, card, "(a) int8 LLM"),
                "a_bf16": profile_batch(batched["a_bf16"][0], req_a, card, "(a) in bf16", llm_only=True),
                "b_int4": profile_batch(tts_b, req_b, card, "(b) int8 LLM + int4 MLP, int8 DiT"),
            }
    if 6 in phases and 3 in phases and 4 in phases:
        # the zero-shot request's shapes: its 600-token decode holds most of the
        # main path's decode launches, and its flow the longest attention
        dt = next(r for r in results["decode_timing"] if r["s"] == 768)
        ft = next(r for r in results["flash_timing"]
                  if r["l"] == 1344 and r["chunk"] == 0 and r["layout"] == "strided")  # the DiT's own views
        # gate_up_proj at decode M = 16: every decode step of request (b) makes
        # one such launch a layer (and one of down_proj), the prefill only two
        it = next(r for r in results["int4_timing"] if r["proj"] == "gate_up_proj" and r["m"] == 16)
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
            dict(name="int4_matmul", route="cuda", source="fangyan_tts_torch/csrc/int4_matmul.cu",
                 replaces="fangyan_tts_tpu/ops/int4_matmul.py:39",
                 launches=results["launches"]["int4_matmul"], max_abs_err=results["int4_err"],
                 ms=it["ms"], plain_ms=it["plain_ms"], bound_ms=it["bound_ms"], bound_by=it["bound_by"],
                 library_ms=it["library_ms"]),
        ]
        log("detail: " + json.dumps({k: results[k] for k in ("decode_timing", "flash_timing", "int4_timing", "requests",
                                                             "batch_requests", "profile", "profile_batch")
                                     if k in results}))
        log(json.dumps({"kernels": kernels}), stamp=False)
    log(card, stamp=False)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": CARDS_USED}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failure is a failed run: report it and exit non-zero
        traceback.print_exc()
        sys.exit(1)
