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

`chunk_flash_attention` launches the kernel for CUDA tensors and runs
`chunk_flash_attention_plain` for CPU tensors; there is no fallback from
one to the other. The kernel has no backward: on a CUDA input that requires
grad (with grad enabled) the wrapper raises, and training takes the DiT's
dense route (models/dit.DiTAttention with dense=True), as the JAX DiT trains
on dense attention.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .device import refuse_grad
from .masks import chunk_attn_mask, mask_to_bias

launches = 0  # kernel launches since the last reset (CPU calls do not count)


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
    dev = q.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"chunk_flash_attention: q is on {dev}, the current CUDA device is {torch.cuda.current_device()}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mel_len", mel_len)):
        if t.device != dev:
            raise ValueError(f"chunk_flash_attention: {name} is on {t.device}, q on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"chunk_flash_attention: {name} must be 16-byte aligned")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"chunk_flash_attention: {name} must be bfloat16, got {t.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or q.shape[-1] != 64:
        raise ValueError(f"chunk_flash_attention: q, k, v must be equal (B, H, L, 64), got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(st < 0 or st % 8 for st in t.stride()[:3]):
            raise ValueError(f"chunk_flash_attention: {name} needs a contiguous last dim and strides that are "
                             f"multiples of 8 elements, got {t.stride()}")
    if mel_len.dtype != torch.int32 or mel_len.shape != (q.shape[0],) or not mel_len.is_contiguous():
        raise ValueError("chunk_flash_attention: mel_len must be contiguous int32 (B,)")
    if chunk < 0:
        raise ValueError("chunk_flash_attention: chunk must be >= 0")


def chunk_flash_attention(q, k, v, mel_len, chunk: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + mask) v on (B, H, L, D), where key j is
    valid iff j < mel_len[b] and, with chunk > 0, j // chunk <= i // chunk.
    q, k and v may be strided views. CPU tensors take the plain version;
    CUDA tensors launch csrc/flash_attention.cu or raise (also when an
    input requires grad: the kernel has no backward), and get back a
    (B, H, L, D) view of (B, L, H, D) memory."""
    if q.device.type == "cpu":
        return chunk_flash_attention_plain(q, k, v, mel_len, chunk)
    if q.device.type != "cuda":
        raise ValueError(f"chunk_flash_attention: unsupported device {q.device}")
    refuse_grad("chunk_flash_attention", "the DiT's dense route (DiT.forward(..., dense=True))", q, k, v)
    _check(q, k, v, mel_len, chunk)
    b, h, l, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    fn = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mel_len.data_ptr(), out.data_ptr(), b, h, l, d, int(chunk),
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    _build.check("flash_attention", code)
    global launches
    launches += 1
    return out.transpose(1, 2)
