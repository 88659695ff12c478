"""Decode-step GQA attention on the stacked KV cache, with the row write.

Kernel: csrc/decode_attention.cu, which replaces the Pallas kernel
fangyan_tts_tpu/ops/decode_attention.py `fused_decode_attention`
(body `_kernel`, pallas_call at :167). It is bound by bytes on the H100
(one layer's K and V per call), and at the decode loop's sizes by latency
in practice, so each call is one launch: a thread-block cluster of up to
MAX_CLUSTER blocks per (row, KV head) splits S (`plan`), every block starts
its K/V tiles by TMA before it waits, its warps keep an online float32
softmax on mma.sync, and the blocks' partials meet in the rank-0 block's
shared memory, which writes the output. The new row is written by the
block that holds its slot. See the source for the design, and
tools/decode_attention_sweep.py for where its time goes.

`decode_attention` launches the kernel for CUDA tensors and runs
`decode_attention_plain` for CPU tensors; there is no fallback from one to
the other. The caches are updated IN PLACE on purpose: the stacked
(L, B, S, KV, hd) cache is the decode loop's state, and only the new row
moves, as in the JAX package's carry-threaded form. q, k_new and v_new may
be views with a batch stride (as the fused qkv buffer gives them), provided
their last two dims are contiguous.
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build
from .device import refuse_grad

launches = 0  # kernel launches since the last reset (CPU calls do not count)
MAX_CLUSTER = 8  # the largest portable thread-block cluster
GROUP = 16  # slots of one mma step: a block's slots are a multiple of this
MIN_RUN = 64  # slots a block takes at least, where S allows (tools/decode_attention_sweep.py)
CHUNK = 256  # slots of one shared-memory buffer (kChunk in the source)
MAX_WARPS = 8
# blocks past which a cluster takes fewer, longer slot runs (about what 132 SMs
# hold at once; binds only from B * KV = 132 up, not measured there)
FULL_GRID = 4 * 132
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on the H100
_ROW = 128  # bytes of one KV head's slot row (hd bf16)


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


@functools.lru_cache(maxsize=256)
def plan(b: int, s: int, kv: int = 2) -> tuple[int, int]:
    """(blocks a cluster n, slots a block per) for B rows, S slots and KV
    heads: n <= MAX_CLUSTER blocks split each (row, KV head)'s slots in runs
    of `per`, a multiple of GROUP, with (n - 1) * per < S <= n * per. Runs
    of at least MIN_RUN slots (shorter ones cost more in partials than they
    save), as many blocks as that allows, unless the B * KV clusters would
    then pass FULL_GRID blocks."""
    n = max(1, min(MAX_CLUSTER, -(-s // MIN_RUN), FULL_GRID // (b * kv)))
    per = -(-(-(-s // n)) // GROUP) * GROUP
    return -(-s // per), per


def smem_bytes(n: int, per: int, g: int) -> int:
    """Dynamic shared memory of one block (the source's `layout`): K and V
    tiles, bias rows, the warps' partials and the partials rank 0 receives,
    the mbarriers, and the 1024 bytes that align the tiles."""
    warps, chunk = min(MAX_WARPS, per // GROUP), min(per, CHUNK)
    nbuf = min(2, -(-per // chunk))
    part = (64 + 2) * 4 * g  # one block of partials: G x 64 outputs, G maxima, G sums (float32)
    recv = -(-(nbuf * chunk * (2 * _ROW + 4) + warps * part) // 16) * 16
    return -(-(recv + n * part) // 8) * 8 + (nbuf + 1) * 8 + 1024


def _check(q, k_new, v_new, cache_k, cache_v, idx, bias, layer):
    dev = q.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"decode_attention: q is on {dev}, the current CUDA device is {torch.cuda.current_device()}")
    if any(t.device != dev for t in (k_new, v_new, cache_k, cache_v, idx, bias)):
        raise ValueError("decode_attention: every tensor must be on q's device")
    bf = torch.bfloat16
    if not (q.dtype == k_new.dtype == v_new.dtype == cache_k.dtype == cache_v.dtype == bf
            and idx.dtype == torch.int32 and bias.dtype == torch.float32):
        raise ValueError("decode_attention: q, k_new, v_new and the caches must be bfloat16, idx int32, bias float32")
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
    for t in (q, k_new, v_new):  # a batch stride is allowed; the kernel checks it and the pointers for 16 bytes
        if t.stride(2) != 1 or t.stride(1) != hd:
            raise ValueError("decode_attention: q, k_new and v_new need contiguous (heads, hd) rows")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous() and idx.is_contiguous() and bias.is_contiguous()):
        raise ValueError("decode_attention: caches, idx and bias must be contiguous")
    if not 0 <= layer < nl:
        raise ValueError(f"decode_attention: layer {layer} outside [0, {nl})")


def decode_attention(q, k_new, v_new, cache_k, cache_v, idx, bias, layer: int) -> torch.Tensor:
    """One decode step: writes the new rows into the caches in place and
    returns the attention output (B, QH, hd). CPU tensors take the plain
    version; CUDA tensors launch csrc/decode_attention.cu (one launch) or
    raise (also when an input requires grad: the kernel has no backward)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, cache_k, cache_v, idx, bias, layer)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    refuse_grad("decode_attention", "the cache-free forward (Qwen2Model with cache=None)", q, k_new, v_new)
    layer = int(layer)
    _check(q, k_new, v_new, cache_k, cache_v, idx, bias, layer)
    nl, b, s, kv, hd = cache_k.shape
    n, per = plan(b, s, kv)
    out = torch.empty((b, q.shape[1], hd), dtype=q.dtype, device=q.device)
    fn = _build.load("decode_attention")
    code = fn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        idx.data_ptr(), bias.data_ptr(), out.data_ptr(), q.stride(0), k_new.stride(0), v_new.stride(0),
        nl, b, s, kv, q.shape[1] // kv, hd, layer, n, per, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("decode_attention", code)
    global launches
    launches += 1
    return out
