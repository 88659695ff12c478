"""CosyVoice3's causal HiFT vocoder, float32, one utterance at a time.

An f0 predictor (a right-causal k=4 convolution, four left-causal k=3 ones
with ELU, a linear head, abs), the neural source filter of the causal
SineGen2 (per-frame phase increments of 9 harmonics, cumulative phase at
the frame rate, nearest upsampling to samples, the fixed uniform noise of
numpy's PCG64(0)), and the generator: a right-causal conv_pre, three
upsampling stages (nearest upsampling and a left-causal convolution,
source fusion through strided convolutions and Snake residual blocks, the
average of three residual blocks), a left-causal conv_post, and an iSTFT
(n_fft 16, hop 4) of exp-magnitude and sin-phase. Every convolution is
causal, so the audio of a frame never depends on frames more than a few
past it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def causal_pad(k: int, d: int = 1) -> int:
    return (k * d - d) // 2 * 2 + (k + 1) % 2


class Conv(nn.Module):
    """Channels-last (B, L, C) convolution with explicit zero padding."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1, stride: int = 1):
        super().__init__()
        self.dilation, self.stride = dilation, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, left: int = 0, right: int = 0):
        y = F.conv1d(F.pad(x.transpose(1, 2), (left, right)), self.weight, self.bias,
                     stride=self.stride, dilation=self.dilation)
        return y.transpose(1, 2)

    def left_causal(self, x):
        return self(x, left=causal_pad(self.weight.shape[-1], self.dilation))


def snake(x, alpha):
    s = torch.sin(x * alpha)
    return x + s * s / (alpha + 1e-9)


class ResBlock(nn.Module):
    def __init__(self, ch: int, k: int, dilations):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            setattr(self, f"alpha1_{i}", nn.Parameter(torch.ones(ch)))
            setattr(self, f"alpha2_{i}", nn.Parameter(torch.ones(ch)))
            setattr(self, f"convs1_{i}", Conv(ch, ch, k, dilation=d))
            setattr(self, f"convs2_{i}", Conv(ch, ch, k))

    def forward(self, x):
        for i in range(self.n):
            xt = getattr(self, f"convs1_{i}").left_causal(snake(x, getattr(self, f"alpha1_{i}")))
            xt = getattr(self, f"convs2_{i}").left_causal(snake(xt, getattr(self, f"alpha2_{i}")))
            x = x + xt
        return x


class F0Predictor(nn.Module):
    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.conv0 = Conv(cin, ch, 4)
        for i in range(1, 5):
            setattr(self, f"conv{i}", Conv(ch, ch, 3))
        self.classifier = nn.Linear(ch, 1)

    def forward(self, mel):
        h = F.elu(self.conv0(mel, right=causal_pad(4)))
        for i in range(1, 5):
            h = F.elu(getattr(self, f"conv{i}").left_causal(h))
        return self.classifier(h)[..., 0].abs()


class Source(nn.Module):
    def __init__(self, h: dict):
        super().__init__()
        self.h = h
        self.l_linear = nn.Linear(h["nb_harmonics"] + 1, 1)

    def forward(self, f0):
        """f0 (B, L) -> source (B, L * upsample, 1)."""
        h = self.h
        hp = h["nb_harmonics"] + 1
        up = total_upsample(h)
        b, l = f0.shape
        n = l * up
        rng = np.random.default_rng(0)
        rand_ini = rng.random((1, hp), dtype=np.float32)
        rand_ini[:, 0] = 0.0
        uniform = torch.from_numpy(rng.random((1, n, hp), dtype=np.float32)).to(f0.device)
        mult = torch.arange(1, hp + 1, dtype=torch.float32, device=f0.device)
        rad = torch.remainder(f0[..., None] * mult / h["sampling_rate"], 1.0)
        rad_up = rad.repeat_interleave(up, dim=1)
        rad_up[:, 0] += torch.from_numpy(rand_ini[0]).to(f0.device)
        # linear interpolation back to the frame rate (align_corners=False)
        coords = ((torch.arange(l, dtype=torch.float32, device=f0.device) + 0.5) * up - 0.5).clamp(0, n - 1)
        lo = coords.floor().long()
        hi = (lo + 1).clamp(max=n - 1)
        w = (coords - lo.float())[None, :, None]
        rad_f = rad_up[:, lo] * (1 - w) + rad_up[:, hi] * w
        phase = torch.cumsum(rad_f, dim=1)
        sines = torch.sin((phase * (2.0 * np.pi) * up).repeat_interleave(up, dim=1))
        f0_up = f0.repeat_interleave(up, dim=1)[..., None]
        uv = (f0_up > h["nsf_voiced_threshold"]).float()
        noise = (uv * h["nsf_sigma"] + (1.0 - uv) * h["nsf_alpha"] / 3.0) * uniform
        return torch.tanh(self.l_linear(sines * h["nsf_alpha"] * uv + noise))


def total_upsample(h: dict) -> int:
    return int(np.prod(h["upsample_rates"])) * h["istft_hop_len"]


def _hann(n: int, device) -> torch.Tensor:
    k = np.arange(n)
    return torch.from_numpy((0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)).to(device)


def stft(x, n_fft: int, hop: int):
    """(B, T) -> (real, imag) (B, F, n_fft//2+1), centered with reflect padding."""
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop) * _hann(n_fft, x.device)
    spec = torch.fft.rfft(frames.double(), dim=-1)
    return spec.real.float(), spec.imag.float()


def istft(real, imag, n_fft: int, hop: int):
    """(B, F, bins) -> (B, (F-1) * hop): windowed overlap-add over the squared-window envelope."""
    win = _hann(n_fft, real.device)
    frames = torch.fft.irfft(torch.complex(real.double(), imag.double()), n=n_fft, dim=-1).float() * win
    b, f, _ = frames.shape
    total = (f - 1) * hop + n_fft
    idx = (torch.arange(f, device=real.device)[:, None] * hop + torch.arange(n_fft, device=real.device)[None]).reshape(-1)
    y = torch.zeros(b, total, device=real.device).index_add_(1, idx, frames.reshape(b, -1))
    env = torch.zeros(total, device=real.device).index_add_(0, idx, (win * win).repeat(f))
    y = y / env.clamp_min(1e-11)
    return y[:, n_fft // 2: total - n_fft // 2]


class CausalHiFT(nn.Module):
    def __init__(self, h: dict):
        super().__init__()
        self.h = h
        self.f0_predictor = F0Predictor(h["in_channels"], h["f0_cond_channels"])
        self.m_source = Source(h)
        self.conv_pre = Conv(h["in_channels"], h["base_channels"], h["conv_pre_look_right"] + 1)
        rates = list(h["upsample_rates"])
        down = list(np.cumprod([1] + rates[::-1][:-1]))[::-1]
        nfft2 = h["istft_n_fft"] + 2
        self.n_res = len(h["resblock_kernel_sizes"])
        for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
            ch_in, ch_out = h["base_channels"] // 2**i, h["base_channels"] // 2 ** (i + 1)
            setattr(self, f"ups_{i}", Conv(ch_in, ch_out, k))
            du = int(down[i])
            setattr(self, f"source_downs_{i}", Conv(nfft2, ch_out, 1) if du == 1 else Conv(nfft2, ch_out, 2 * du, stride=du))
            setattr(self, f"source_resblocks_{i}", ResBlock(ch_out, h["source_resblock_kernel_sizes"][i],
                                                            h["source_resblock_dilation_sizes"][i]))
            for j, (rk, rd) in enumerate(zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])):
                setattr(self, f"resblocks_{i}_{j}", ResBlock(ch_out, rk, rd))
        self.conv_post = Conv(h["base_channels"] // 2 ** len(rates), nfft2, 7)

    @torch.no_grad()
    def audio(self, mel) -> torch.Tensor:
        """mel (L, 80) -> audio (L * 480,), clamped to the audio limit."""
        h = self.h
        mel = torch.as_tensor(mel, dtype=torch.float32)[None].to(self.conv_pre.weight.device)
        src = self.m_source(self.f0_predictor(mel))
        s_re, s_im = stft(src[..., 0], h["istft_n_fft"], h["istft_hop_len"])
        s = torch.cat([s_re, s_im], dim=-1)  # (1, F, n_fft + 2)
        x = self.conv_pre(mel, right=h["conv_pre_look_right"])
        rates = list(h["upsample_rates"])
        for i, u in enumerate(rates):
            x = F.leaky_relu(x, h["lrelu_slope"])
            up = getattr(self, f"ups_{i}")
            x = up(x.repeat_interleave(u, dim=1), left=up.weight.shape[-1] - 1)
            if i == len(rates) - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)  # reflection pad of one frame on the left
            sd = getattr(self, f"source_downs_{i}")
            si = sd(s, left=sd.stride - 1) if sd.stride > 1 else sd(s)
            x = x + getattr(self, f"source_resblocks_{i}")(si)
            x = sum(getattr(self, f"resblocks_{i}_{j}")(x) for j in range(self.n_res)) / self.n_res
        x = self.conv_post.left_causal(F.leaky_relu(x, 0.01))
        nb = h["istft_n_fft"] // 2 + 1
        mag = torch.exp(x[..., :nb]).clamp(max=1e2)
        ph = torch.sin(x[..., nb:])
        y = istft(mag * torch.cos(ph), mag * torch.sin(ph), h["istft_n_fft"], h["istft_hop_len"])
        return y[0].clamp(-h["audio_limit"], h["audio_limit"])


class HiFT(nn.Module):
    """CosyVoice2's non-causal HiFT vocoder: a symmetric-convolution f0
    predictor, the SineGen2 source with linear phase upsampling and additive
    Gaussian noise (numpy's default_rng(1), read at the chunk's absolute
    sample offset), a k7 conv_pre, transposed-convolution upsampling, the
    source fusion, symmetric Snake residual blocks, conv_post and the iSTFT.
    `audio` takes the source samples a stream carries over from its last
    chunk in place of the first ones."""

    def __init__(self, h: dict):
        super().__init__()
        self.h = h
        self.f0_predictor = nn.Module()
        for i in range(5):
            setattr(self.f0_predictor, f"conv{i}", Conv(h["in_channels"] if i == 0 else h["f0_cond_channels"],
                                                        h["f0_cond_channels"], 3))
        self.f0_predictor.classifier = nn.Linear(h["f0_cond_channels"], 1)
        self.m_source = nn.Module()
        self.m_source.l_linear = nn.Linear(h["nb_harmonics"] + 1, 1)
        self.conv_pre = Conv(h["in_channels"], h["base_channels"], 7)
        rates = list(h["upsample_rates"])
        down = list(np.cumprod([1] + rates[::-1][:-1]))[::-1]
        nfft2 = h["istft_n_fft"] + 2
        self.n_res = len(h["resblock_kernel_sizes"])
        for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
            ch_in, ch_out = h["base_channels"] // 2**i, h["base_channels"] // 2 ** (i + 1)
            up = nn.Module()
            up.weight = nn.Parameter(torch.empty(ch_in, ch_out, k))
            up.bias = nn.Parameter(torch.zeros(ch_out))
            setattr(self, f"ups_{i}", up)
            du = int(down[i])
            setattr(self, f"source_downs_{i}", Conv(nfft2, ch_out, 1) if du == 1 else Conv(nfft2, ch_out, 2 * du, stride=du))
            setattr(self, f"source_resblocks_{i}", ResBlock(ch_out, h["source_resblock_kernel_sizes"][i],
                                                            h["source_resblock_dilation_sizes"][i]))
            for j, (rk, rd) in enumerate(zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])):
                setattr(self, f"resblocks_{i}_{j}", ResBlock(ch_out, rk, rd))
        self.conv_post = Conv(h["base_channels"] // 2 ** len(rates), nfft2, 7)

    @staticmethod
    def _same(conv: Conv, x):
        k, d = conv.weight.shape[-1], conv.dilation
        return conv(x, left=(k * d - d) // 2, right=(k * d - d) // 2)

    def _res(self, block: ResBlock, x):
        for i in range(block.n):
            xt = self._same(getattr(block, f"convs1_{i}"), snake(x, getattr(block, f"alpha1_{i}")))
            xt = self._same(getattr(block, f"convs2_{i}"), snake(xt, getattr(block, f"alpha2_{i}")))
            x = x + xt
        return x

    def source(self, f0, noise_offset: int):
        h = self.h
        hp = h["nb_harmonics"] + 1
        up = total_upsample(h)
        l = f0.shape[1]
        n = l * up
        rng = np.random.default_rng(0)
        rand_ini = rng.random((1, hp), dtype=np.float32)
        rand_ini[:, 0] = 0.0
        mult = torch.arange(1, hp + 1, dtype=torch.float32, device=f0.device)
        rad_up = torch.remainder(f0[..., None] * mult / h["sampling_rate"], 1.0).repeat_interleave(up, dim=1)
        rad_up[:, 0] += torch.from_numpy(rand_ini[0]).to(f0.device)

        def lin(x, m, size):  # F.interpolate(mode='linear', align_corners=False) to `size` samples
            coords = ((torch.arange(size, dtype=torch.float32, device=x.device) + 0.5) * (m / size) - 0.5).clamp(0, m - 1)
            lo = coords.floor().long()
            hi = (lo + 1).clamp(max=m - 1)
            w = (coords - lo.float())[None, :, None]
            return x[:, lo] * (1 - w) + x[:, hi] * w

        phase = torch.cumsum(lin(rad_up, n, l), dim=1)
        sines = torch.sin(lin(phase * (2.0 * np.pi) * up, l, n))
        uv = (f0.repeat_interleave(up, dim=1)[..., None] > h["nsf_voiced_threshold"]).float()
        total = h["stream_noise_seconds"] * h["sampling_rate"]
        off = int(noise_offset) % max(total - n, 1)
        gauss = np.random.default_rng(1).standard_normal((1, off + n, hp))[:, off:].astype(np.float32)
        noise = (uv * h["nsf_sigma"] + (1.0 - uv) * h["nsf_alpha"] / 3.0) * torch.from_numpy(gauss).to(f0.device)
        return torch.tanh(self.m_source.l_linear(sines * h["nsf_alpha"] * uv + noise))

    @torch.no_grad()
    def audio(self, mel, cache_source=None, noise_offset: int = 0):
        """mel (L, 80) -> (audio (L * 480,), source (L * 480, 1))."""
        h = self.h
        mel = torch.as_tensor(mel, dtype=torch.float32)[None].to(self.conv_pre.weight.device)
        x = mel
        for i in range(5):
            x = F.elu(self._same(getattr(self.f0_predictor, f"conv{i}"), x))
        f0 = self.f0_predictor.classifier(x)[..., 0].abs()
        s = self.source(f0, noise_offset)
        if cache_source is not None and len(cache_source):
            cs = torch.as_tensor(np.asarray(cache_source, np.float32), device=s.device)[None]
            s = torch.cat([cs, s[:, cs.shape[1]:]], dim=1)
        s_re, s_im = stft(s[..., 0], h["istft_n_fft"], h["istft_hop_len"])
        st = torch.cat([s_re, s_im], dim=-1)
        x = self._same(self.conv_pre, mel)
        rates = list(h["upsample_rates"])
        for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
            x = F.leaky_relu(x, h["lrelu_slope"])
            up = getattr(self, f"ups_{i}")
            x = F.conv_transpose1d(x.transpose(1, 2), up.weight, up.bias, stride=u, padding=(k - u) // 2).transpose(1, 2)
            if i == len(rates) - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)
            sd = getattr(self, f"source_downs_{i}")
            si = sd(st, left=sd.stride // 2, right=sd.stride // 2) if sd.stride > 1 else sd(st)
            si = self._res(getattr(self, f"source_resblocks_{i}"), si)
            m = min(x.shape[1], si.shape[1])
            x = x[:, :m] + si[:, :m]
            x = sum(self._res(getattr(self, f"resblocks_{i}_{j}"), x) for j in range(self.n_res)) / self.n_res
        x = self._same(self.conv_post, F.leaky_relu(x, 0.01))
        nb = h["istft_n_fft"] // 2 + 1
        mag = torch.exp(x[..., :nb]).clamp(max=1e2)
        ph = torch.sin(x[..., nb:])
        y = istft(mag * torch.cos(ph), mag * torch.sin(ph), h["istft_n_fft"], h["istft_hop_len"])
        y = y[0].clamp(-h["audio_limit"], h["audio_limit"])
        return y, s[0]
