"""CAM++ speaker encoder, the x-vector extractor
(fangyan_tts_tpu/models/campplus.py).

80-bin kaldi fbank, mean-subtracted over time -> 192-d speaker embedding:
- FCM 2-D front end: conv3x3 + BN + ReLU, two stages of two BasicResBlocks
  (the first of each with stride 2 on frequency and a conv1x1 + BN
  shortcut), conv3x3 with stride 2 on frequency + BN + ReLU; frequency /8,
  then (B, T, C * F/8);
- TDNN: conv k5 s2 (no bias) + BN + ReLU;
- three dense blocks (12 / 24 / 16 layers, growth 32, bottleneck 128,
  dilations 1 / 2 / 2), each layer BN-ReLU-conv1x1, BN-ReLU, then a CAM
  conv: a local conv gated by a sigmoid of the global mean plus the
  100-frame segment mean; a transit BN-ReLU-conv1x1 (channels / 2) after
  each block;
- BN-ReLU, stats pooling (mean ++ unbiased std over time), linear (no
  bias) and a non-affine BatchNorm.

Sequences are channels-last (B, T, C) as in the JAX module; the 2-D front
end runs torch's (B, C, F, T), the JAX module's (B, F, T, C) transposed.
Parameter names follow the JAX tree through models/from_jax.py: BatchNorm
holds `mean`, `var`, `scale` and `bias` (the running statistics are
parameters, as the converted checkpoint has them), dense layers are
nn.Linear, convolutions `weight` in torch's layout. Every product runs in
the input's dtype, with the weights cast to it, as flax's `dtype=x.dtype`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convs import conv1d
from .qwen2 import flax_dense


class BatchNorm(nn.Module):
    """Inference BatchNorm; the non-affine one holds only mean and var."""

    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))
        if affine:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.scale = self.bias = None

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Normalise the channels on axis `dim` of x."""
        rs = torch.rsqrt(self.var.float() + self.eps)
        scale = self.scale.float() if self.scale is not None else torch.ones_like(rs)
        bias = self.bias.float() if self.bias is not None else torch.zeros_like(rs)
        inv = (scale * rs).to(x.dtype)
        shift = (bias - self.mean.float() * scale * rs).to(x.dtype)
        shape = [1] * x.dim()
        shape[dim] = -1
        return x * inv.view(shape) + shift.view(shape)


class TDNNLayer(nn.Module):
    """conv1d(k, stride, dilation, no bias) -> BN -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel))
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        pad = (self.weight.shape[-1] - 1) // 2 * self.dilation
        x = conv1d(x, self.weight.to(x.dtype), None, stride=self.stride, padding=pad, dilation=self.dilation)
        return F.relu(self.bn(x))


def _seg_pool_mean(x: torch.Tensor, seg_len: int) -> torch.Tensor:
    """avg_pool1d(seg_len, stride seg_len, ceil_mode=True) expanded back to
    T frames; the last partial segment averages over its true length."""
    b, t, c = x.shape
    n_seg = (t + seg_len - 1) // seg_len
    xp = F.pad(x, (0, 0, 0, n_seg * seg_len - t))
    seg_sum = xp.reshape(b, n_seg, seg_len, c).sum(dim=2)
    counts = torch.full((n_seg,), seg_len, dtype=x.dtype, device=x.device)
    counts[-1] = t - (n_seg - 1) * seg_len
    seg_mean = seg_sum / counts[None, :, None]
    up = seg_mean[:, :, None, :].expand(b, n_seg, seg_len, c).reshape(b, n_seg * seg_len, c)
    return up[:, :t]


class CAMLayer(nn.Module):
    """Context-aware masking: a local conv gated by a sigmoid of the global
    mean plus the segment mean."""

    def __init__(self, in_ch: int, bn_channels: int, out_ch: int, kernel: int, dilation: int,
                 reduction: int = 2, seg_len: int = 100):
        super().__init__()
        self.dilation, self.seg_len = dilation, seg_len
        self.linear_local = nn.Module()
        self.linear_local.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel))
        self.linear1 = nn.Linear(in_ch, bn_channels // reduction)
        self.linear2 = nn.Linear(bn_channels // reduction, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        w = self.linear_local.weight
        pad = (w.shape[-1] - 1) // 2 * self.dilation
        y = conv1d(x, w.to(x.dtype), None, padding=pad, dilation=self.dilation)
        ctx = x.mean(dim=1, keepdim=True) + _seg_pool_mean(x, self.seg_len)
        h = F.relu(flax_dense(ctx, self.linear1, x.dtype))
        return y * torch.sigmoid(flax_dense(h, self.linear2, x.dtype))


class CAMDenseTDNNLayer(nn.Module):
    """BN-ReLU-conv1x1 bottleneck, then BN-ReLU-CAM conv."""

    def __init__(self, in_ch: int, bn_channels: int, out_ch: int, kernel: int, dilation: int):
        super().__init__()
        self.bn1 = BatchNorm(in_ch)
        self.linear1 = nn.Linear(in_ch, bn_channels, bias=False)
        self.bn2 = BatchNorm(bn_channels)
        self.cam_layer = CAMLayer(bn_channels, bn_channels, out_ch, kernel, dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(x))
        h = F.relu(self.bn2(flax_dense(h, self.linear1, h.dtype)))
        return self.cam_layer(h)


class CAMDenseTDNNBlock(nn.Module):
    def __init__(self, num_layers: int, in_ch: int, bn_channels: int, growth: int, kernel: int, dilation: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer_{i}", CAMDenseTDNNLayer(in_ch + i * growth, bn_channels, growth, kernel, dilation))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = torch.cat([x, getattr(self, f"layer_{i}")(x)], dim=-1)
        return x


class TransitLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.bn = BatchNorm(in_ch)
        self.linear = nn.Linear(in_ch, out_ch, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_dense(F.relu(self.bn(x)), self.linear, x.dtype)


class Conv2d(nn.Module):
    """A 2-D convolution's weight (Cout, Cin, kh, kw), no bias, on (B, C, F, T)."""

    def __init__(self, cin: int, cout: int, k: int, stride: tuple[int, int] = (1, 1), padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, stride=self.stride, padding=self.padding)


class BasicResBlock(nn.Module):
    """conv3x3 (stride on frequency) + BN + ReLU, conv3x3 + BN, a conv1x1 +
    BN shortcut where the shape changes, ReLU. x: (B, C, F, T)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, (stride, 1))
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.has_shortcut = stride != 1 or in_planes != planes
        if self.has_shortcut:
            self.shortcut_conv = Conv2d(in_planes, planes, 1, (stride, 1), padding=0)
            self.shortcut_bn = BatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), dim=1))
        h = self.bn2(self.conv2(h), dim=1)
        sc = self.shortcut_bn(self.shortcut_conv(x), dim=1) if self.has_shortcut else x
        return F.relu(h + sc)


class FCM(nn.Module):
    """2-D front end: frequency /8. (B, T, F) -> (B, T, C * F/8)."""

    def __init__(self, m_channels: int = 32, num_blocks: Sequence[int] = (2, 2)):
        super().__init__()
        m = m_channels
        self.num_blocks = tuple(num_blocks)
        self.conv1 = Conv2d(1, m, 3)
        self.bn1 = BatchNorm(m)
        for li, nb in enumerate(self.num_blocks):
            for bi in range(nb):
                setattr(self, f"layer{li + 1}_{bi}", BasicResBlock(m, m, stride=2 if bi == 0 else 1))
        self.conv2 = Conv2d(m, m, 3, (2, 1))
        self.bn2 = BatchNorm(m)

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        x = fbank.transpose(1, 2)[:, None]  # (B, 1, F, T)
        x = F.relu(self.bn1(self.conv1(x), dim=1))
        for li, nb in enumerate(self.num_blocks):
            for bi in range(nb):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
        x = F.relu(self.bn2(self.conv2(x), dim=1))
        b, c, f, t = x.shape
        # torch's reshape(B, C*F', T) puts C outer: feature = c*F' + f
        return x.permute(0, 3, 1, 2).reshape(b, t, c * f)


class CAMPPlus(nn.Module):
    """FCM -> TDNN -> 3 dense blocks with transits -> BN-ReLU -> stats
    pooling -> linear + non-affine BN. (B, T, feat_dim) -> (B, embedding_size)."""

    def __init__(
        self,
        embedding_size: int = 192,
        init_channels: int = 128,
        growth: int = 32,
        bn_size: int = 4,
        block_layers: Sequence[int] = (12, 24, 16),
        block_kernels: Sequence[int] = (3, 3, 3),
        block_dilations: Sequence[int] = (1, 2, 2),
        feat_dim: int = 80,
        m_channels: int = 32,
    ):
        super().__init__()
        self.head = FCM(m_channels)
        f = feat_dim
        for _ in range(3):  # the three stride-2 convolutions on frequency
            f = (f - 1) // 2 + 1
        ch = m_channels * f
        self.tdnn = TDNNLayer(ch, init_channels, 5, stride=2)
        bn_ch = bn_size * growth
        ch = init_channels
        self.n_blocks = len(block_layers)
        for bi, (nl, ks, dil) in enumerate(zip(block_layers, block_kernels, block_dilations)):
            setattr(self, f"block_{bi}", CAMDenseTDNNBlock(nl, ch, bn_ch, growth, ks, dil))
            out = (ch + nl * growth) // 2
            setattr(self, f"transit_{bi}", TransitLayer(ch + nl * growth, out))
            ch = out
        self.out_bn = BatchNorm(ch)
        self.embedding = nn.Linear(2 * ch, embedding_size, bias=False)
        self.emb_bn = BatchNorm(embedding_size, affine=False)

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        x = self.tdnn(self.head(fbank))
        for bi in range(self.n_blocks):
            x = getattr(self, f"transit_{bi}")(getattr(self, f"block_{bi}")(x))
        x = F.relu(self.out_bn(x))
        t = x.shape[1]
        mean = x.mean(dim=1)
        var = ((x - mean[:, None, :]) ** 2).sum(dim=1) / max(t - 1, 1)  # unbiased, as torch.std
        stats = torch.cat([mean, torch.sqrt(var)], dim=-1)
        return self.emb_bn(flax_dense(stats, self.embedding, x.dtype))
