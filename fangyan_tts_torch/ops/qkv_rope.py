"""The Qwen2 attention's qkv epilogue in one pass: the projection's bias,
then NeoX rotary embedding of the query and key heads.

Kernel: csrc/qkv_rope_triton.py (Triton), which replaces no TPU kernel:
the JAX package leaves the epilogue to XLA, which fuses it. In plain
PyTorch it is a dozen element-wise launches a layer (the bias cast and
add; for q and for k the negation, the concatenation of the halves, two
products and a sum), each over a (rows, heads, 64) slice. At the decode's
16 rows that is some 300 launches a step of about 2 us each for a few
KB; at the prefill's rows it is bound by bytes. The kernel reads the
qkv GEMM's output once and writes q, k and v once, with the float32 bias
added and the rotation taken in float32 registers, one rounding an output.

- One program takes one row: every head of it as a (heads, head_dim)
  block, the head count and head_dim being build constants. A head's
  rotation partner (the other half) is a second read of the same row,
  which the cache serves.
- The output is one (B, T, W) buffer laid out as the qkv's: q, k and v
  are views of it with a batch stride, the layout decode attention and
  the prefill's cache write take.
- The bias is optional: a tensor-parallel layer (qwen2.TPDense) adds its
  own inside `tp_dense`, and the kernel then only rotates.

`qkv_rope` picks the route as ops/rms_norm does (ops/device.kernel_route):
where autograd records the call, or under torch.compile / torch.export,
`qkv_rope_plain`, the attention's former expressions exactly; eager CUDA
tensors launch the kernel; every other tensor takes `qkv_rope_plain`. Every call counts
`llm.qkv` in the tracer, each one the kernel ran `llm.fused_qkv` as well;
each launch counts as `qkv_rope` in ops/device.launches, replays included.
The MLA-MoE backbone's rotation (de-interleaved 64-wide slices, no bias)
keeps `apply_rope`.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count
from . import _build
from .device import KERNEL_DTYPES, kernel_route, launched, refuse_grad



def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, hd); cos/sin (B, T, hd)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


def qkv_rope_plain(qkv, bias, cos, sin, heads: int, kv_heads: int):
    """Plain PyTorch version, the attention's expressions: qkv (B, T, W)
    plus the bias in qkv's dtype, split into q (heads) and k, v (kv_heads)
    of head_dim = cos.shape[-1], q and k rotated by apply_rope. Returns q
    (B, T, heads, hd), k, v (B, T, kv_heads, hd)."""
    b, t, _ = qkv.shape
    hd = cos.shape[-1]
    if bias is not None:
        qkv = qkv + bias.to(qkv.dtype)
    q, k, v = torch.split(qkv, [heads * hd, kv_heads * hd, kv_heads * hd], dim=-1)
    return (apply_rope(q.reshape(b, t, heads, hd), cos, sin), apply_rope(k.reshape(b, t, kv_heads, hd), cos, sin),
            v.reshape(b, t, kv_heads, hd))


def _check(qkv, bias, cos, sin, heads, kv_heads):
    if qkv.dim() != 3 or qkv.dtype not in KERNEL_DTYPES or qkv.stride(-1) != 1:
        raise ValueError(f"qkv_rope: qkv must be (B, T, W) bfloat16 or float32 with a unit column stride, got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    b, t, w = qkv.shape
    hd = cos.shape[-1]
    if hd < 2 or hd & (hd - 1) or w != (heads + 2 * kv_heads) * hd:
        raise ValueError(f"qkv_rope: W = {w} must be (heads {heads} + 2 x kv_heads {kv_heads}) x head_dim {hd}, "
                         f"head_dim a power of two")
    if any(c.shape != (b, t, hd) or c.dtype not in KERNEL_DTYPES or not c.is_contiguous() for c in (cos, sin)):
        raise ValueError(f"qkv_rope: cos and sin must be contiguous ({b}, {t}, {hd})")
    if bias is not None and (bias.shape != (w,) or bias.dtype not in KERNEL_DTYPES or bias.stride(0) != 1):
        raise ValueError(f"qkv_rope: bias must be a contiguous ({w},) vector, got {tuple(bias.shape)}")
    if any(c.device != qkv.device for c in (cos, sin, *(() if bias is None else (bias,)))):
        raise ValueError("qkv_rope: every tensor must be on qkv's device")
    if qkv.device.type == "cuda" and qkv.device.index != torch.cuda.current_device():
        raise ValueError(f"qkv_rope: qkv is on {qkv.device}, the current CUDA device is "
                         f"{torch.cuda.current_device()}")


def qkv_rope_fused(qkv, bias, cos, sin, heads: int, kv_heads: int):
    """The kernel's route of qkv_rope (CUDA tensors only): q, k and v as
    views of one contiguous buffer of qkv's shape and dtype."""
    refuse_grad("qkv_rope", "qkv_rope_plain", *(x for x in (qkv, bias, cos, sin) if x is not None))
    _check(qkv, bias, cos, sin, heads, kv_heads)
    b, t, w = qkv.shape
    hd = cos.shape[-1]
    rows = qkv.reshape(-1, w)  # a view wherever the leading dims collapse
    out = torch.empty((b, t, w), dtype=qkv.dtype, device=qkv.device)
    if rows.shape[0]:
        n = heads + 2 * kv_heads
        _build.triton("qkv_rope").fangyan_qkv_rope[(rows.shape[0],)](
            rows, rows if bias is None else bias, cos, sin, out, rows.stride(0), QH=heads, KV=kv_heads, HD=hd,
            BLOCK_H=1 << (n - 1).bit_length(), BIAS=bias is not None, num_warps=4)
        launched("qkv_rope")
    q, k, v = torch.split(out, [heads * hd, kv_heads * hd, kv_heads * hd], dim=-1)
    return q.view(b, t, heads, hd), k.view(b, t, kv_heads, hd), v.view(b, t, kv_heads, hd)


def qkv_rope(qkv, bias, cos, sin, heads: int, kv_heads: int):
    """q, k, v from the qkv projection's output without its bias: qkv (B,
    T, W), bias (W,) or None, cos/sin (B, T, head_dim). Where autograd
    records the call or a compiler traces it, qkv_rope_plain; else the
    kernel for CUDA tensors and qkv_rope_plain for the rest."""
    count("llm.qkv")
    if not kernel_route(qkv, bias, cos, sin):
        return qkv_rope_plain(qkv, bias, cos, sin, heads, kv_heads)
    count("llm.fused_qkv")
    return qkv_rope_fused(qkv, bias, cos, sin, heads, kv_heads)
