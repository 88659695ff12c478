"""GAN discriminators of the vocoder's training
(fangyan_tts_tpu/models/discriminators.py): `DiscriminatorP` (the
multi-period discriminator's (k, 1) convolutions over a (T/p, p) fold),
`SpecDiscriminator` (2-D convolutions over an STFT magnitude) and
`MultipleDiscriminator` (periods 2, 3, 5, 7, 11 and STFT sizes 1024 / 2048
/ 512, hops 120 / 240 / 50, windows 600 / 1200 / 240).

Tensors are NCHW here where flax is NHWC: the fold is (B, 1, T/p, p) and the
spectrogram (B, 1, frames, bins). A feature map is the flax one with its
channel axis moved to position 1; the logits (B, H*W) are equal as they
stand.

Every convolution carries flax's `nn.WeightNorm` (`WNConv2d`), which is not
torch's weight_norm: one `scale` per output channel, initialised to ones,
multiplies the kernel normalised over all its other axes as
v * rsqrt(sum(v^2) + 1e-12); the bias is not normalised. The module names
follow the flax tree (`Conv_i`, whose `WeightNorm_i` holds its scale), so
that models/from_jax maps the checkpoints both ways.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.stft import hann_window, stft

LRELU_SLOPE = 0.1
WN_EPS = 1e-12  # flax WeightNorm's epsilon


class WNConv2d(nn.Module):
    """A 2-D convolution under flax's WeightNorm. `padding` is explicit per
    side, ((top, bottom), (left, right)) over (H, W), or "SAME" (flax's:
    ceil(in / stride) outputs, the total padding split with the smaller
    half first, which torch's padding="same" cannot do at a stride over 1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int], stride: tuple[int, int] = (1, 1),
                 padding="SAME"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.scale = nn.Parameter(torch.ones(out_ch))
        self.stride, self.padding = stride, padding

    def normalized_weight(self) -> torch.Tensor:
        v = self.weight
        return v * torch.rsqrt((v * v).sum(dim=(1, 2, 3), keepdim=True) + WN_EPS) * self.scale[:, None, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W)
        if self.padding == "SAME":
            pads = []
            for size, k, s in zip(x.shape[2:], self.weight.shape[2:], self.stride):
                total = max((-(-size // s) - 1) * s + k - size, 0)
                pads.append((total // 2, total - total // 2))
        else:
            pads = self.padding
        (top, bottom), (left, right) = pads
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.normalized_weight(), self.bias, stride=self.stride)


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad_k = (kernel_size - 1) // 2
        chans = (1, 32, 128, 512, 1024)
        for i in range(4):
            setattr(self, f"Conv_{i}", WNConv2d(chans[i], chans[i + 1], (kernel_size, 1), (stride, 1),
                                                ((pad_k, pad_k), (0, 0))))
        self.Conv_4 = WNConv2d(1024, 1024, (kernel_size, 1), (1, 1), ((2, 2), (0, 0)))
        self.Conv_5 = WNConv2d(1024, 1, (3, 1), (1, 1), ((1, 1), (0, 0)))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """x (B, T) -> (logits (B, H*W), six feature maps (B, C, H, p))."""
        b, t = x.shape
        p = self.period
        if t % p:
            pad = p - t % p
            x = torch.cat([x, x[:, -pad:].flip(1)], dim=1)  # the last `pad` samples reversed, the last one included
            t += pad
        h = x.reshape(b, 1, t // p, p)
        fmap = []
        for i in range(6):
            h = getattr(self, f"Conv_{i}")(h)
            if i < 5:
                h = F.leaky_relu(h, LRELU_SLOPE)
            fmap.append(h)
        return h.reshape(b, -1), fmap


class SpecDiscriminator(nn.Module):
    def __init__(self, fft_size: int = 1024, shift_size: int = 120, win_length: int = 600):
        super().__init__()
        self.fft_size, self.shift_size, self.win_length = fft_size, shift_size, win_length
        specs = [((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 3), (1, 1))]
        for i, (k, s) in enumerate(specs):
            setattr(self, f"Conv_{i}", WNConv2d(1 if i == 0 else 32, 32, k, s))
        self.Conv_5 = WNConv2d(32, 1, (3, 3))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """x (B, T) -> (logits (B, frames*bins'), six feature maps)."""
        side = (self.fft_size - self.win_length) // 2
        win = torch.from_numpy(np.pad(hann_window(self.win_length), (side, side))).to(x.device)
        real, imag = stft(x, self.fft_size, self.shift_size, win, center=True)
        h = torch.sqrt(real * real + imag * imag + 1e-9).transpose(1, 2)[:, None]  # (B, 1, frames, bins)
        fmap = []
        for i in range(6):
            h = getattr(self, f"Conv_{i}")(h)
            if i < 5:
                h = F.leaky_relu(h, LRELU_SLOPE)
            fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


class MultipleDiscriminator(nn.Module):
    """The multi-period discriminators (`mpd_i`) and the multi-resolution
    spectrogram discriminators (`mrd_i`)."""

    def __init__(self, periods: tuple[int, ...] = (2, 3, 5, 7, 11), fft_sizes: tuple[int, ...] = (1024, 2048, 512),
                 hop_sizes: tuple[int, ...] = (120, 240, 50), win_lengths: tuple[int, ...] = (600, 1200, 240)):
        super().__init__()
        self.n_mpd, self.n_mrd = len(periods), len(fft_sizes)
        for i, p in enumerate(periods):
            setattr(self, f"mpd_{i}", DiscriminatorP(p))
        for i, spec in enumerate(zip(fft_sizes, hop_sizes, win_lengths)):
            setattr(self, f"mrd_{i}", SpecDiscriminator(*spec))

    def discriminators(self) -> list[nn.Module]:
        return ([getattr(self, f"mpd_{i}") for i in range(self.n_mpd)]
                + [getattr(self, f"mrd_{i}") for i in range(self.n_mrd)])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat (B, T). Returns (y_d_rs, y_d_gs, fmap_rs, fmap_gs), one
        entry a discriminator."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators():
            out_r, fm_r = d(y)
            out_g, fm_g = d(y_hat)
            y_d_rs.append(out_r)
            y_d_gs.append(out_g)
            fmap_rs.append(fm_r)
            fmap_gs.append(fm_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
