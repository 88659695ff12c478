"""1-D convolution helpers with the JAX package's (B, L, C) layout.

Counterpart of fangyan_tts_tpu/ops/convs.py. The public functions take and
return channels-last (B, L, C) tensors, as the JAX ones do, and run
`torch.nn.functional.conv1d` in its (B, C, L) layout inside. Kernels are in
torch's layout: (Cout, Cin/groups, K) for a convolution and (Cin, Cout, K)
for a transposed one (models/from_jax.py maps the JAX layouts onto these).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    padding: int | tuple[int, int] = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """x: (B, L, Cin); kernel: (Cout, Cin/groups, K) -> (B, L', Cout).
    `padding` is symmetric (int) or (left, right) zeros; the bias is added
    after the convolution, as the JAX helper adds it."""
    if isinstance(padding, int):
        padding = (padding, padding)
    xc = x.transpose(1, 2)
    if padding != (0, 0):
        xc = F.pad(xc, padding)
    out = F.conv1d(xc, kernel, None, stride=stride, dilation=dilation, groups=groups).transpose(1, 2)
    if bias is not None:
        out = out + bias
    return out


def causal_padding(k: int, dilation: int = 1) -> int:
    """CausalConv1d's pad: (k*d - d)//2*2 + (k+1)%2 (length-preserving)."""
    return (k * dilation - dilation) // 2 * 2 + (k + 1) % 2


def causal_conv1d_left(x, kernel, bias=None, dilation: int = 1, groups: int = 1):
    """Left-padded causal convolution (output length == input length)."""
    pad = causal_padding(kernel.shape[-1], dilation)
    return conv1d(x, kernel, bias, padding=(pad, 0), dilation=dilation, groups=groups)


def causal_conv1d_right(x, kernel, bias=None, dilation: int = 1, groups: int = 1, context=None):
    """Right (lookahead) causal convolution: zeros padded on the right. With
    `context` (B, n, C), the future frames of a streaming step, those frames
    come before the zeros and the output covers only x's frames."""
    pad = causal_padding(kernel.shape[-1], dilation)
    if context is not None:
        x = torch.cat([x, context], dim=1)
        return conv1d(x, kernel, bias, padding=(0, pad - context.shape[1]), dilation=dilation, groups=groups)
    return conv1d(x, kernel, bias, padding=(0, pad), dilation=dilation, groups=groups)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, L, C) -> (B, L*scale, C), each step repeated `scale` times."""
    b, l, c = x.shape
    return x[:, :, None, :].expand(b, l, scale, c).reshape(b, l * scale, c)


def upsample_linear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, L, C) -> (B, L*scale, C) as F.interpolate(mode='linear',
    align_corners=False) for an integer scale factor."""
    l = x.shape[1]
    coords = (torch.arange(l * scale, dtype=torch.float32, device=x.device) + 0.5) / scale - 0.5
    coords = coords.clamp(0.0, l - 1)
    lo = torch.floor(coords).to(torch.int64)
    hi = torch.clamp(lo + 1, max=l - 1)
    w = (coords - lo.to(torch.float32))[None, :, None]
    return x[:, lo, :] * (1.0 - w) + x[:, hi, :] * w


def downsample_linear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, L, C) -> (B, L//scale, C) as F.interpolate(mode='linear',
    scale_factor=1/scale, align_corners=False)."""
    l = x.shape[1]
    coords = (torch.arange(l // scale, dtype=torch.float32, device=x.device) + 0.5) * scale - 0.5
    coords = coords.clamp(0.0, l - 1)
    lo = torch.floor(coords).to(torch.int64)
    hi = torch.clamp(lo + 1, max=l - 1)
    w = (coords - lo.to(torch.float32))[None, :, None]
    return x[:, lo, :] * (1.0 - w) + x[:, hi, :] * w


def conv_transpose1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """ConvTranspose1d on (B, L, Cin); kernel (Cin, Cout, K).
    Output length (L-1)*stride - 2*padding + K. The JAX helper computes the
    same function as a dilated convolution with the flipped kernel."""
    out = F.conv_transpose1d(x.transpose(1, 2), kernel, None, stride=stride, padding=padding).transpose(1, 2)
    if bias is not None:
        out = out + bias
    return out
