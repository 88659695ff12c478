"""The AdaLN chain of a DiT block in one pass: the gated residual, a
LayerNorm without affine weights and the AdaLN-Zero modulation.

Kernel: csrc/adaln_triton.py (Triton), which replaces no TPU kernel: the
JAX package leaves this chain to XLA, which fuses it. In plain PyTorch the
chain is about a dozen element-wise launches a norm, each a full pass over
the (B, L, D) hidden state (the float32 cast, two means, the centring, the
scaling, the modulation's product and sum, the residual's product and sum),
and the modulation's (B, D) rows are broadcast views of a strided
`mod.chunk(6)`, which PyTorch's element-wise kernels read through their
slowest path. A DiT block runs the chain twice, so at the flow's sizes
(2B = 32 rows of 384-1,024 frames, D = 1,024) it moved several times the
bytes of the block's GEMMs. The kernel reads x (and the branch output y)
once and writes x' (with the residual) and the norm once, with all
arithmetic in float32 registers and one rounding per output: 8 bytes an
element with the residual, 4 without, so it is bound by bytes.

- One program takes ROWS rows; a row of D = 1,024 fits in registers, so
  the statistics take one read (the mean, then the centred sum of squares
  from the same registers: no E[x^2] - E[x]^2 cancellation).
- Row r reads the modulation rows of batch row r // L, each through its
  own row stride: the `mod.chunk(6)` views (and the final norm's
  `chunk(2)` beside the last block's gate) are taken as they are, no copy.
- D is a build constant; the row count, L and the strides are runtime
  arguments that Triton does not specialize on, so every bucket of a width
  shares one build (two: with and without the residual).

`adaln` picks the route from what it can observe: where autograd records
the call, `adaln_plain`, the DiT's old expressions exactly (the training
route, the dense DiT with grad); under a tracer (torch.export,
torch.compile), the custom op `fangyan::adaln`, so that an exported
flow_solve holds one node a norm and a loaded program launches the kernel
on the card (its CPU kernel is the plain version, so an exported program
on the CPU gives the eager chain's bits); eager CUDA tensors launch the kernel
directly (the dispatcher's detour would cost host time a call, as
ops/flash_attention notes), and every other tensor takes `adaln_plain`.
So the CPU path runs the plain chain bit for bit as before, and float32
(`fp16=False`) takes the kernel as bf16 does. Every call counts
`dit.norms` in the tracer (utils/profiling.count), and each eager one the
kernel ran `dit.fused_norms` as well. Each launch counts as `adaln` in
ops/device.launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import count
from . import _build
from .device import KERNEL_DEVICES, launched, refuse_grad
from .device import KERNEL_DTYPES as DTYPES

ROWS, NUM_WARPS = 2, 4  # rows a program, and its warps: 16 elements a thread at D = 1,024


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """flax LayerNorm without scale or bias: float32 statistics
    (E[x^2] - E[x]^2, clamped at 0), result in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def adaln_plain(x, scale, shift, y=None, gate=None, eps: float = 1e-6):
    """Plain PyTorch version, the DiT's expressions: x' = x + gate * y (x'
    = x without y), then layer_norm(x') * (1 + scale) + shift, each step
    rounded to x's dtype. x, y (B, L, D); scale, shift, gate (B, D).
    Returns (x', norm)."""
    if y is not None:
        x = x + gate[:, None] * y
    return x, layer_norm(x, eps) * (1 + scale[:, None]) + shift[:, None]


def _check(x, scale, shift, y, gate):
    if x.dim() != 3 or x.dtype not in DTYPES:
        raise ValueError(f"adaln: x must be (B, L, D) bfloat16 or float32, got {tuple(x.shape)} {x.dtype}")
    b, _, d = x.shape
    if (y is None) != (gate is None):
        raise ValueError("adaln: y and gate come together")
    if y is not None and (y.shape != x.shape or y.dtype != x.dtype):
        raise ValueError(f"adaln: y must be of x's shape and dtype, got {tuple(y.shape)} {y.dtype}")
    mods = (scale, shift) if gate is None else (scale, shift, gate)
    if any(t.device != x.device for t in (*mods, *(() if y is None else (y,)))):
        raise ValueError("adaln: every tensor must be on x's device")
    if x.device.type == "cuda" and x.device.index != torch.cuda.current_device():
        raise ValueError(f"adaln: x is on {x.device}, the current CUDA device is {torch.cuda.current_device()}")
    if any(t.shape != (b, d) or t.dtype not in DTYPES or t.stride(1) != 1 for t in mods):
        raise ValueError("adaln: scale, shift and gate must be (B, D) rows with a unit column stride")


def adaln_fused(x, scale, shift, y=None, gate=None, eps: float = 1e-6):
    """The kernel's route of adaln (CUDA tensors only). x and y may be
    strided: they are made contiguous first (the DiT's first norm reads the
    position convolutions' sum, which is laid out (B, D, L)), and x' is
    then contiguous, also without the residual."""
    refuse_grad("adaln", "adaln_plain", *(t for t in (x, scale, shift, y, gate) if t is not None))
    _check(x, scale, shift, y, gate)
    x, y = x.contiguous(), None if y is None else y.contiguous()
    b, l, d = x.shape
    norm = torch.empty_like(x)
    x_out = x if y is None else torch.empty_like(x)
    rows = b * l
    if rows == 0:
        return x_out, norm
    _build.triton("adaln").fangyan_adaln[(-(-rows // ROWS),)](
        x, x if y is None else y, scale if gate is None else gate, scale, shift, x_out, norm, rows, l,
        0 if gate is None else gate.stride(0), scale.stride(0), shift.stride(0), eps, D=d,
        BLOCK_D=1 << (d - 1).bit_length(), ROWS=ROWS, RESIDUAL=y is not None, num_warps=NUM_WARPS)
    launched("adaln")
    return x_out, norm


@torch.library.custom_op("fangyan::adaln", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, y: Optional[torch.Tensor],
        gate: Optional[torch.Tensor], eps: float) -> list[torch.Tensor]:
    """The CPU kernel: the plain version, in x's layout as the eager chain
    leaves it; [norm] without y, [x', norm] with it (x' without y would
    alias x, which an op's output may not)."""
    x_out, norm = adaln_plain(x, scale, shift, y, gate, eps)
    return [norm] if y is None else [x_out, norm]


@_op.register_kernel("cuda")
def _cuda(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, y: Optional[torch.Tensor],
          gate: Optional[torch.Tensor], eps: float) -> list[torch.Tensor]:
    """The CUDA kernel: one launch of the Triton kernel."""
    x_out, norm = adaln_fused(x, scale, shift, y, gate, eps)
    return [norm] if y is None else [x_out, norm]


@_op.register_fake
def _fake(x, scale, shift, y, gate, eps):
    """The CPU kernel's outputs take x's layout, the CUDA kernel's are contiguous."""
    like = torch.empty_like(x) if x.device.type == "cpu" else torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return [like] if y is None else [torch.empty_like(like), torch.empty_like(like)]


def adaln(x, scale, shift, y=None, gate=None, eps: float = 1e-6):
    """(x', norm) with x' = x + gate * y (x itself without y) and norm =
    LayerNorm(x') * (1 + scale) + shift. x, y (B, L, D); scale, shift, gate
    (B, D) rows, e.g. views of a DiT block's `mod.chunk(6)`. Where autograd
    records the call, adaln_plain; under a tracer (export, compile), the op
    fangyan::adaln; else the kernel for CUDA tensors and adaln_plain for
    the rest."""
    count("dit.norms")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, scale, shift, y, gate)):
        return adaln_plain(x, scale, shift, y, gate, eps)
    if torch.compiler.is_compiling():
        out = _op(x, scale, shift, y, gate, eps)
        return (x, out[0]) if y is None else (out[0], out[1])
    if x.device.type not in KERNEL_DEVICES:
        return adaln_plain(x, scale, shift, y, gate, eps)
    count("dit.fused_norms")
    return adaln_fused(x, scale, shift, y, gate, eps)
