"""Length-masked, chunk-causal flash attention for the DiT.

Kernel: csrc/flash_attention.cu, which replaces the Pallas kernel
fangyan_tts_tpu/ops/flash_attention.py `chunk_flash_attention`
(body `_kernel`, pallas_call at :102). On the H100 it is bound by bytes
for L below about 590 (L/2 FLOPs a byte against a ridge of about 295) and
by operations above; it runs FlashAttention-3's shape at head dim 64
(TMA into an mbarrier ring, both products on wgmma, float32 running max /
sum / accumulator), builds the masks from `mel_len` and `chunk` in the
kernel, and skips key tiles that are wholly masked. It reads q, k and v
through strided (B, H, L, D) views, so the DiT hands it its projections
without copies, and writes its output in (B, L, H, D) memory, returned as
a (B, H, L, D) view. See the source for the design.

Float32 q, k and v take the kernel's float32 route,
`fangyan_chunk_flash_attention_f32`: a SIMT kernel with float32 scores,
softmax and sums and no tensor cores (so no TF32 rounding), with the same
masks, strided views and output layout. A block of 128 query rows runs two
groups of threads over alternate key tiles (8 x 8 register tiles, float4
operands from shared memory, a cp.async ring) and merges them at the end.
The Pallas kernel computes in float32 and writes q's dtype. The wrapper
picks the route by the inputs' dtype and counts a launch in
ops/device.launches under the route's name, `chunk_flash_attention` or
`chunk_flash_attention_f32` (ROUTES).

The kernel is the custom op `fangyan::chunk_flash_attention`
(torch.library, registered in Python on the ctypes binding), so that
torch.export traces it as one node and a loaded program launches it: its
CPU kernel is `chunk_flash_attention_plain` (in the CUDA kernel's output
layout), its CUDA kernel the launch (with the checks that read pointers
and the current device, and the launch count), and its fake gives the
CUDA kernel's output layout. There is no fallback from one device to the
other. The op registers no autograd: the
kernel has no backward. On a CUDA input that requires grad (with grad
enabled) `chunk_flash_attention` raises, and training takes the DiT's dense
route (models/dit.DiTAttention with dense=True), as the JAX DiT trains on
dense attention.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .device import launched, refuse_grad
from .masks import chunk_attn_mask, mask_to_bias

# dtype -> (C entry, the route's name in ops/device.launches)
ROUTES = {torch.bfloat16: ("flash_attention", "chunk_flash_attention"),
          torch.float32: ("flash_attention_f32", "chunk_flash_attention_f32")}


def chunk_flash_attention_plain(q, k, v, mel_len, chunk: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the JAX DiT's dense attention
    (models/dit.py DiTAttention with mask_to_bias(chunk_attn_mask(...))).
    q, k, v (B, H, L, D); mel_len (B,) int; returns (B, H, L, D)."""
    b, h, l, d = q.shape
    bias = mask_to_bias(chunk_attn_mask(mel_len.to(q.device), l, chunk))  # (B, L, L)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    probs = torch.softmax(scores.float() + bias[:, None], dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _check(q, k, v, mel_len, chunk):
    """The CUDA kernel's checks: device, pointers, dtypes, shapes and strides."""
    dev = q.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"chunk_flash_attention: q is on {dev}, the current CUDA device is {torch.cuda.current_device()}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mel_len", mel_len)):
        if t.device != dev:
            raise ValueError(f"chunk_flash_attention: {name} is on {t.device}, q on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"chunk_flash_attention: {name} must be 16-byte aligned")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"chunk_flash_attention: q, k and v must be all bfloat16 or all float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or q.shape[-1] != 64:
        raise ValueError(f"chunk_flash_attention: q, k, v must be equal (B, H, L, 64), got {tuple(q.shape)}")
    align = 16 // q.element_size()  # strides in elements: 16 bytes, for TMA (bf16) or float4 loads (float32)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(st < 0 or st % align for st in t.stride()[:3]):
            raise ValueError(f"chunk_flash_attention: {name} needs a contiguous last dim and strides that are "
                             f"multiples of {align} elements, got {t.stride()}")
    if mel_len.dtype != torch.int32 or mel_len.shape != (q.shape[0],) or not mel_len.is_contiguous():
        raise ValueError("chunk_flash_attention: mel_len must be contiguous int32 (B,)")
    if chunk < 0:
        raise ValueError("chunk_flash_attention: chunk must be >= 0")


def _bl_view(b: int, h: int, l: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """A (B, H, L, D) view of fresh (B, L, H, D) memory: the kernel's output layout."""
    return like.new_empty((b, l, h, d)).transpose(1, 2)


@torch.library.custom_op("fangyan::chunk_flash_attention", mutates_args=(), device_types="cpu")
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mel_len: torch.Tensor, chunk: int) -> torch.Tensor:
    """The CPU kernel: the plain version, in the CUDA kernel's output layout."""
    b, h, l, d = q.shape
    return _bl_view(b, h, l, d, q).copy_(chunk_flash_attention_plain(q, k, v, mel_len, chunk))


@_op.register_kernel("cuda")
def _cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mel_len: torch.Tensor, chunk: int) -> torch.Tensor:
    """The CUDA kernel: one launch of csrc/flash_attention.cu, by ROUTES."""
    _check(q, k, v, mel_len, chunk)
    b, h, l, d = q.shape
    out = _bl_view(b, h, l, d, q)
    entry, route = ROUTES[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _build.load(entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), mel_len.data_ptr(), out.data_ptr(), b, h, l,
                              d, int(chunk), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    _build.check(entry, code)
    launched(route)
    return out


@_op.register_fake
def _fake(q, k, v, mel_len, chunk):
    b, h, l, d = q.shape
    return _bl_view(b, h, l, d, q)


def chunk_flash_attention(q, k, v, mel_len, chunk: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + mask) v on (B, H, L, D), where key j is
    valid iff j < mel_len[b] and, with chunk > 0, j // chunk <= i // chunk.
    q, k and v may be strided views. CPU tensors take the plain version;
    CUDA tensors launch csrc/flash_attention.cu (the bf16 route for
    bfloat16 inputs, the float32 route for float32 ones) and get back a
    (B, H, L, D) view of (B, L, H, D) memory, or raise (also when an input
    requires grad: the kernel has no backward). Under torch.export the call
    is the op `fangyan::chunk_flash_attention`; eager calls run the op's
    kernel for their device directly, since the dispatcher's detour costs
    about 50 us of host time a call on an H100's host (chip_smoke.py's
    eager-call timing; PERF.md)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chunk_flash_attention: unsupported device {q.device}")
    if q.device.type == "cuda":
        refuse_grad("chunk_flash_attention", "the DiT's dense route (DiT.forward(..., dense=True))", q, k, v)
    if torch.compiler.is_exporting():
        return _op(q, k, v, mel_len, int(chunk))
    if q.device.type == "cpu":
        return chunk_flash_attention_plain(q, k, v, mel_len, chunk)
    return _cuda(q, k, v, mel_len, int(chunk))
