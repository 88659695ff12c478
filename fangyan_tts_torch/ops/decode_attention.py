"""Decode-step GQA attention on the stacked KV cache, with the row write.

Kernel: csrc/decode_attention.cu, which replaces the Pallas kernel
fangyan_tts_tpu/ops/decode_attention.py `fused_decode_attention`
(body `_kernel`, pallas_call at :167). It is bound by bytes on the H100
(one layer's K and V per call), and at B=1 by latency in practice: the
first pass spreads S over blocks of 64 slots per (row, KV head), each
reading a slot once for the group's query heads and keeping its softmax in
float32; the second pass combines the splits. The new row is written by
the block whose split holds it. See the source for the design.

`decode_attention` launches the kernel for CUDA tensors and runs
`decode_attention_plain` for CPU tensors; there is no fallback from one to
the other. The caches are updated IN PLACE on purpose: the stacked
(L, B, S, KV, hd) cache is the decode loop's state, and only the new row
moves, as in the JAX package's carry-threaded form.
"""

from __future__ import annotations

import math

import torch

from . import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)
SPLIT = 64  # slots per block of the kernel's first pass (kSplit in the source)


def decode_attention_plain(q, k_new, v_new, cache_k, cache_v, idx, bias, layer: int) -> torch.Tensor:
    """Plain PyTorch version, op for op the JAX package's
    `carry_decode_attention` (bf16 score product, float32 softmax).

    q (B, QH, hd); k_new, v_new (B, KV, hd); cache_k, cache_v
    (L, B, S, KV, hd), updated in place; idx (B,) int32 write slots
    (clamped to S-1); bias (B, S) float32; layer int. Returns (B, QH, hd).
    """
    _, b, s, kv, hd = cache_k.shape
    qh = q.shape[1]
    rows = torch.arange(b, device=q.device)
    idx_c = torch.clamp(idx.to(torch.int64).reshape(-1).expand(b), 0, s - 1)
    cache_k[layer, rows, idx_c] = k_new.to(cache_k.dtype)
    cache_v[layer, rows, idx_c] = v_new.to(cache_v.dtype)
    k = cache_k[layer].to(q.dtype)
    v = cache_v[layer].to(q.dtype)
    qg = q.reshape(b, kv, qh // kv, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k) / math.sqrt(hd)
    scores = scores.float() + bias.float()[:, None, None, :]
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bskh->bkgh", p, v).reshape(b, qh, hd)


def _check(q, k_new, v_new, cache_k, cache_v, idx, bias, layer):
    ts = {"q": q, "k_new": k_new, "v_new": v_new, "cache_k": cache_k, "cache_v": cache_v, "idx": idx, "bias": bias}
    dev = q.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"decode_attention: q is on {dev}, the current CUDA device is {torch.cuda.current_device()}")
    for name, t in ts.items():
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte aligned")
    for name in ("q", "k_new", "v_new", "cache_k", "cache_v"):
        if ts[name].dtype != torch.bfloat16:
            raise ValueError(f"decode_attention: {name} must be bfloat16, got {ts[name].dtype}")
    if idx.dtype != torch.int32 or bias.dtype != torch.float32:
        raise ValueError("decode_attention: idx must be int32 and bias float32")
    if cache_k.dim() != 5 or cache_v.shape != cache_k.shape:
        raise ValueError("decode_attention: caches must be (L, B, S, KV, hd) and equal")
    nl, b, s, kv, hd = cache_k.shape
    qh = q.shape[1]
    if hd != 64 or q.shape != (b, qh, hd) or qh % kv or not 1 <= qh // kv <= 8:
        raise ValueError(f"decode_attention: unsupported q {tuple(q.shape)} for cache {tuple(cache_k.shape)}")
    if k_new.shape != (b, kv, hd) or v_new.shape != (b, kv, hd):
        raise ValueError("decode_attention: k_new / v_new must be (B, KV, hd)")
    if idx.shape != (b,) or bias.shape != (b, s):
        raise ValueError("decode_attention: idx must be (B,) and bias (B, S)")
    if not 0 <= int(layer) < nl:
        raise ValueError(f"decode_attention: layer {layer} outside [0, {nl})")


def decode_attention(q, k_new, v_new, cache_k, cache_v, idx, bias, layer: int) -> torch.Tensor:
    """One decode step: writes the new rows into the caches in place and
    returns the attention output (B, QH, hd). CPU tensors take the plain
    version; CUDA tensors launch csrc/decode_attention.cu or raise."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, cache_k, cache_v, idx, bias, layer)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check(q, k_new, v_new, cache_k, cache_v, idx, bias, layer)
    nl, b, s, kv, hd = cache_k.shape
    g = q.shape[1] // kv
    out = torch.empty_like(q)
    # float32 partials of the split-S pass: per (row, KV head, split of
    # SPLIT slots) G*hd outputs and G maxima and sums
    ws = torch.empty(b * kv * -(-s // SPLIT) * g * (hd + 2), dtype=torch.float32, device=q.device)
    fn = _build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        idx.data_ptr(), bias.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(),
        b, s, kv, g, hd, int(layer), stream,
    )
    _build.check("decode_attention", code)
    global launches
    launches += 1
    return out
