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

Float32 inputs (q, k_new, v_new and the caches) take the kernel's float32
route, `fangyan_decode_attention_f32`: a separate SIMT kernel with float32
scores, softmax and sums in FMAs and no tensor cores (so no TF32 rounding),
of the bf16 route's shape. A cluster of up to MAX_CLUSTER_F32 blocks per
(row, KV head) splits S (`plan_f32`, runs of a multiple of 32 slots: a
float32 slot row is twice a bf16 one), every block starts its K/V tiles by
TMA before it waits, all its warps work on its slots (scores from K in
shared memory, P.V with each thread owning a float4 of the outputs), and
rank 0 merges the partials. At phase 4's float32 batch (B = 4, S = 128)
the bound is latency, which the runs of 32 slots spread over 32 blocks; at
B = 32, S = 384 it is the bytes and each SM's issue rate, which one block
an SM with every byte asked for at entry answers. The Pallas kernel is
dtype-generic in the same way. The wrapper picks the route by the inputs'
dtype and counts a launch in ops/device.launches under the route's name,
`decode_attention` or `decode_attention_f32`.

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
from .device import launched, refuse_grad

# dtype -> C entry, also the route's name in ops/device.launches
ROUTES = {torch.bfloat16: "decode_attention", torch.float32: "decode_attention_f32"}
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
# the float32 route (kF32* in the source)
MAX_CLUSTER_F32 = 16  # blocks a cluster: past 8 a non-portable cluster, which the H100 places (the sweep at S = 4096)
GROUP_F32 = 32  # a block's slots are a multiple of this
MIN_RUN_F32 = 32  # slots a block takes at least, where S allows (tools/decode_attention_sweep.py --f32)
FULL_GRID_F32 = 132  # blocks past which a cluster takes fewer, longer runs: one a SM (the sweep at B = 32)
CHUNK_F32 = 128  # slots of one shared-memory buffer at most
MAX_BUF_F32 = 3


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


@functools.lru_cache(maxsize=256)
def plan_f32(b: int, s: int, kv: int = 2) -> tuple[int, int]:
    """`plan` for the float32 route: n <= MAX_CLUSTER_F32 blocks a cluster,
    runs of a multiple of GROUP_F32 slots, at least MIN_RUN_F32 where S
    allows, as many blocks as that allows unless the B * KV clusters would
    then pass FULL_GRID_F32 blocks (a float32 block's work is bound by its
    SM's issue rate, so past one block an SM shorter runs only add waves
    and partials)."""
    n = max(1, min(MAX_CLUSTER_F32, -(-s // MIN_RUN_F32), FULL_GRID_F32 // (b * kv)))
    per = -(-(-(-s // n)) // GROUP_F32) * GROUP_F32
    return -(-s // per), per


def chunk_f32(per: int) -> int:
    """Slots of one shared-memory chunk of a float32 block of `per` slots:
    the run in as few chunks of at most CHUNK_F32 as it needs, each a
    multiple of GROUP_F32 (the source's `chunk_f32`)."""
    k = -(-per // CHUNK_F32)
    return -(-(-(-per // k)) // GROUP_F32) * GROUP_F32


def smem_bytes_f32(n: int, per: int, g: int) -> int:
    """Dynamic shared memory of one float32 block (the source's
    `layout_f32`): nbuf buffers of K and V tiles (as many as fit, up to
    MAX_BUF_F32 and the block's chunks), bias rows, the chunk's
    probabilities, the warps' maxima, q, the partials rank 0 receives, the
    mbarriers, and the 1024 bytes that align the tiles."""
    chunk = chunk_f32(per)
    nbuf = min(MAX_BUF_F32, -(-per // chunk))
    while True:
        fixed = nbuf * chunk * (4 * _ROW + 4) + chunk * 8 * 4 + 8 * 8 * 4 + 8 * 64 * 4
        total = fixed + n * g * (64 + 2) * 4 + (nbuf + 1) * 8 + 1024
        if total <= SMEM_LIMIT or nbuf == 1:
            return total
        nbuf -= 1


def launch_args(q, k_new, v_new, cache_k, cache_v, idx, bias, out, layer: int) -> tuple:
    """The C entry's arguments for this call but the stream: pointers,
    batch strides, shapes, the layer and the route's launch plan."""
    nl, b, s, kv, hd = cache_k.shape
    plan_of = plan_f32 if q.dtype == torch.float32 else plan
    return (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            idx.data_ptr(), bias.data_ptr(), out.data_ptr(), q.stride(0), k_new.stride(0), v_new.stride(0),
            nl, b, s, kv, q.shape[1] // kv, hd, layer, *plan_of(b, s, kv))


def _check(q, k_new, v_new, cache_k, cache_v, idx, bias, layer):
    dev = q.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"decode_attention: q is on {dev}, the current CUDA device is {torch.cuda.current_device()}")
    if any(t.device != dev for t in (k_new, v_new, cache_k, cache_v, idx, bias)):
        raise ValueError("decode_attention: every tensor must be on q's device")
    if not (q.dtype == k_new.dtype == v_new.dtype == cache_k.dtype == cache_v.dtype and q.dtype in ROUTES
            and idx.dtype == torch.int32 and bias.dtype == torch.float32):
        raise ValueError("decode_attention: q, k_new, v_new and the caches must be all bfloat16 or all float32, "
                         "idx int32, bias float32")
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
    for t in (q, k_new, v_new):  # a batch stride is allowed; the kernels check it and the pointers for 16 bytes
        if t.stride(2) != 1 or t.stride(1) != hd:
            raise ValueError("decode_attention: q, k_new and v_new need contiguous (heads, hd) rows")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous() and idx.is_contiguous() and bias.is_contiguous()):
        raise ValueError("decode_attention: caches, idx and bias must be contiguous")
    if not 0 <= layer < nl:
        raise ValueError(f"decode_attention: layer {layer} outside [0, {nl})")


def decode_attention(q, k_new, v_new, cache_k, cache_v, idx, bias, layer: int) -> torch.Tensor:
    """One decode step: writes the new rows into the caches in place and
    returns the attention output (B, QH, hd). CPU tensors take the plain
    version; CUDA tensors launch csrc/decode_attention.cu (one launch: the
    bf16 route for bfloat16 inputs, the float32 route for float32 ones) or
    raise (also when an input requires grad: the kernel has no backward)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, cache_k, cache_v, idx, bias, layer)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    refuse_grad("decode_attention", "the cache-free forward (Qwen2Model with cache=None)", q, k_new, v_new)
    layer = int(layer)
    _check(q, k_new, v_new, cache_k, cache_v, idx, bias, layer)
    return _launch(q, k_new, v_new, cache_k, cache_v, idx, bias, layer)


def _launch(q, k_new, v_new, cache_k, cache_v, idx, bias, layer: int) -> torch.Tensor:
    """One launch of the C entry for q's dtype (ROUTES) on checked inputs,
    counted as that route."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    entry = ROUTES[q.dtype]
    args = launch_args(q, k_new, v_new, cache_k, cache_v, idx, bias, out, layer)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(entry, _build.load(entry)(*args, stream))
    launched(entry)
    return out
