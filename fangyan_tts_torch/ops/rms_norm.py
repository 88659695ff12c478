"""RMSNorm with the residual add before it, in one pass: the LM backbones'
norms (models/qwen2.py, models/mla_moe.py).

Kernel: csrc/rms_norm_triton.py (Triton), which replaces no TPU kernel:
the JAX package leaves the norm to XLA, which fuses it. In plain PyTorch a
norm is eight element-wise launches (the float32 cast, the square, the
mean, + eps, rsqrt, two products, the cast back) and the residual add one
more, each a pass over (rows, D). A decode step of the 24-layer Qwen2 LM
at B = 16 runs 49 norms on (16, 896) rows: some 400 launches of about 2 us
each for a few hundred KB of data. The kernel reads x (and the branch
output y) once and writes x' = x + y (with the residual) and the norm
once, with all arithmetic in float32 registers and one rounding per
output. At decode it is bound by its launch; at the prefill's rows by
bytes (8 bytes an element in bf16 with the residual, 4 without).

- One program takes one row; D (896 for Qwen2, 2,048 and 512 for the
  MLA-MoE backbone) is a build constant, so a row lives in registers and
  its mean square takes one read.
- The sum is rounded to x's dtype before the statistics, as the plain
  chain rounds it, so x' is the plain x + y bit for bit.
- x and y are read through their row strides: the MLA's kv_a_layernorm
  takes the latent part of kv_a_proj's output, a strided split, as it is.
  The norm, and x' with the residual, are contiguous.

`rms_norm` picks the route from what it can observe
(ops/device.kernel_route): where autograd records the call, or under
torch.compile / torch.export, `rms_norm_plain`, the backbones' former
expressions exactly; eager CUDA tensors launch the kernel (a decode graph
captures it after its eager warm-up step); every other tensor takes
`rms_norm_plain`. So the CPU path runs the plain chain
bit for bit as before. Every call counts `llm.norms` in the tracer
(utils/profiling.count), and each one the kernel ran `llm.fused_norms` as
well; a replayed graph counts nothing there. Each launch counts as
`rms_norm` in ops/device.launches, replays included.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count
from . import _build
from .device import KERNEL_DTYPES, kernel_route, launched, refuse_grad



def rms_norm_plain(x, weight, eps: float, y=None):
    """Plain PyTorch version, the backbones' expressions: x' = x + y (x' =
    x without y), rounded to x's dtype, then x' * rsqrt(mean(x'^2) + eps) *
    weight in float32, cast to x's dtype. Returns (x', norm)."""
    if y is not None:
        x = x + y
    dtype = x.dtype
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return x, (h * weight).to(dtype)


def _check(x, weight, y):
    d = x.shape[-1]
    if x.dtype not in KERNEL_DTYPES or x.dim() < 2:
        raise ValueError(f"rms_norm: x must be (..., D) bfloat16 or float32, got {tuple(x.shape)} {x.dtype}")
    if weight.shape != (d,) or weight.dtype not in KERNEL_DTYPES or weight.stride(0) != 1:
        raise ValueError(f"rms_norm: weight must be a contiguous ({d},) vector, got {tuple(weight.shape)}")
    if y is not None and (y.shape != x.shape or y.dtype != x.dtype):
        raise ValueError(f"rms_norm: y must be of x's shape and dtype, got {tuple(y.shape)} {y.dtype}")
    if any(t.device != x.device for t in (weight, *(() if y is None else (y,)))):
        raise ValueError("rms_norm: every tensor must be on x's device")
    if x.device.type == "cuda" and x.device.index != torch.cuda.current_device():
        raise ValueError(f"rms_norm: x is on {x.device}, the current CUDA device is {torch.cuda.current_device()}")
    if any(t.stride(-1) != 1 for t in (x, *(() if y is None else (y,)))):
        raise ValueError("rms_norm: x and y need a unit column stride")


def rms_norm_fused(x, weight, eps: float, y=None):
    """The kernel's route of rms_norm (CUDA tensors only). x and y may be
    row-strided views; the norm, and x' with y, come back contiguous in x's
    shape (without y, x' is x itself)."""
    refuse_grad("rms_norm", "rms_norm_plain", *(t for t in (x, weight, y) if t is not None))
    _check(x, weight, y)
    d = x.shape[-1]
    rows_x = x.reshape(-1, d)  # a view wherever the leading dims collapse (the strided kv_a split does)
    rows_y = rows_x if y is None else y.reshape(-1, d)
    norm = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    x_out = x if y is None else torch.empty_like(norm)
    rows = rows_x.shape[0]
    if rows == 0:
        return x_out, norm
    block = 1 << (d - 1).bit_length()
    _build.triton("rms_norm").fangyan_rms_norm[(rows,)](
        rows_x, rows_y, weight, x_out, norm, rows_x.stride(0), rows_y.stride(0), eps, D=d, BLOCK_D=block,
        RESIDUAL=y is not None, num_warps=max(1, min(8, block // 256)))
    launched("rms_norm")
    return x_out, norm


def rms_norm(x, weight, eps: float, y=None):
    """(x', norm) with x' = x + y (x itself without y) and norm =
    RMSNorm(x') * weight. x, y (..., D); weight (D,). Where autograd
    records the call or a compiler traces it, rms_norm_plain; else the
    kernel for CUDA tensors and rms_norm_plain for the rest."""
    count("llm.norms")
    if not kernel_route(x, weight, y):
        return rms_norm_plain(x, weight, eps, y)
    count("llm.fused_norms")
    return rms_norm_fused(x, weight, eps, y)
