"""HiFT vocoders: NSF harmonic source plus iSTFT synthesis
(fangyan_tts_tpu/models/hift.py).

- `CausalHiFT` (CosyVoice3, the sinegen2_causal source): offline
  (finalize) inference, the streaming step (`finalize=False`, the lookahead
  frames as context), the windows of constant-cost streaming
  (`stream_window`, `finalize_window`, `rad_delta`) and the GAN-training
  forward (`forward_train`, train/gan.py).
- `HiFT` (CosyVoice1/2, non-causal): symmetric-padded convolutions, a
  transposed-convolution upsampler, the `F0Predictor` and the sinegen1
  (22.05 kHz, v1) or non-causal sinegen2 (24 kHz, v2) source, with the
  caller's source cache and Gaussian noise taken from `nsf_gauss_buffer` at
  the chunk's absolute sample offset.

Tensors are channels-last (B, L, C). Every convolution casts its weights to
the activation's dtype, as the JAX modules do, and mixed-dtype adds promote
the same way: the float32 source STFT lifts the upsampling path to float32
from the first stage on. The f0 predictor runs in float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import HiFTConfig
from ..ops.convs import (
    causal_conv1d_left,
    causal_conv1d_right,
    conv1d,
    conv_transpose1d,
    downsample_linear,
    upsample_linear,
    upsample_nearest,
)
from ..ops.stft import hann_window, istft, stft
from .dit import ConvParams, tconv_params
from .qwen2 import flax_dense


@functools.lru_cache(maxsize=1)
def nsf_buffers(harmonics_plus_one: int = 9, max_samples: int = 300 * 24000):
    """Fixed NSF noise: (rand_ini (1, H), uniform_noise (1, max_samples, H)),
    uniform [0, 1) float32 from numpy PCG64(0) in the JAX package's fill
    order (its third buffer, drawn last, is not used here). Built once on
    the host (about 259 MB at the defaults); callers upload only the slice
    they use."""
    rng = np.random.default_rng(0)
    rand_ini = rng.random((1, harmonics_plus_one), dtype=np.float32)
    rand_ini[:, 0] = 0.0
    uniform_noise = rng.random((1, max_samples, harmonics_plus_one), dtype=np.float32)
    return rand_ini, uniform_noise


def nsf_gauss_noise(n_samples: int, harmonics_plus_one: int = 9) -> np.ndarray:
    """Fixed standard-normal noise (1, n, H) from numpy rng(1): the additive
    noise of the non-causal source when no buffer is given."""
    rng = np.random.default_rng(1)
    return rng.standard_normal((1, n_samples, harmonics_plus_one)).astype(np.float32)


@functools.lru_cache(maxsize=2)
def nsf_gauss_buffer(harmonics_plus_one: int = 9, max_samples: int = 120 * 24000) -> np.ndarray:
    """The long Gaussian buffer of the v1/v2 vocoders (1, max_samples, H),
    rng(1) in nsf_gauss_noise's fill order, so its head equals
    nsf_gauss_noise(n): chunks indexed at their absolute sample offsets draw
    the noise one whole-utterance call would."""
    rng = np.random.default_rng(1)
    return rng.standard_normal((1, max_samples, harmonics_plus_one)).astype(np.float32)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + sin^2(a x) / (a + 1e-9), alpha per channel."""
    a = alpha[None, None, :]
    s = torch.sin(x * a)
    return x + s * s / (a + 1e-9)


class CausalConv(ConvParams):
    """CausalConv1d: side 'left' pads the past, 'right' the lookahead."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, dilation: int = 1, side: str = "left"):
        super().__init__(in_ch, out_ch, kernel)
        self.dilation, self.side = dilation, side

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        """context: the future frames of a streaming step (side 'right')."""
        k, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if self.side == "left":
            return causal_conv1d_left(x, k, b, dilation=self.dilation)
        return causal_conv1d_right(x, k, b, dilation=self.dilation, context=context)

    @staticmethod
    def causal_padding(kernel: int, dilation: int = 1) -> int:
        return (kernel * dilation - dilation) // 2 * 2 + (kernel + 1) % 2


class CausalConvDown(ConvParams):
    """Stride-s convolution with stride-1 zeros padded on the left."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int):
        super().__init__(in_ch, out_ch, kernel)
        self.stride = stride

    def forward(self, x):
        return conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=self.stride,
                      padding=(self.stride - 1, 0))


class CausalConvUp(ConvParams):
    """Nearest upsampling by the stride, then a left-padded convolution."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int):
        super().__init__(in_ch, out_ch, kernel)
        self.stride = stride

    def forward(self, x):
        x = upsample_nearest(x, self.stride)
        return conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=(self.weight.shape[-1] - 1, 0))


class PlainConv(ConvParams):
    """Symmetric-padding convolution (the non-causal HiFT's Conv1d with
    get_padding); `pad` overrides the derived padding (the strided source
    downsamplers pad stride // 2)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, dilation: int = 1, stride: int = 1,
                 pad: int | None = None):
        super().__init__(in_ch, out_ch, kernel)
        self.dilation, self.stride = dilation, stride
        self.pad = (kernel * dilation - dilation) // 2 if pad is None else pad

    def forward(self, x):
        return conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=self.stride, padding=self.pad,
                      dilation=self.dilation)


class ResBlock(nn.Module):
    """Snake residual block: left-padded causal convolutions, or symmetric
    ones with causal=False (the non-causal HiFT)."""

    def __init__(self, channels: int, kernel: int, dilations: tuple[int, ...], causal: bool = True):
        super().__init__()
        self.n = len(dilations)
        conv = CausalConv if causal else PlainConv
        for i, d in enumerate(dilations):
            setattr(self, f"alpha1_{i}", nn.Parameter(torch.ones(channels)))
            setattr(self, f"alpha2_{i}", nn.Parameter(torch.ones(channels)))
            setattr(self, f"convs1_{i}", conv(channels, channels, kernel, dilation=d))
            setattr(self, f"convs2_{i}", conv(channels, channels, kernel, dilation=1))

    def forward(self, x):
        for i in range(self.n):
            xt = snake(x, getattr(self, f"alpha1_{i}").to(x.dtype))
            xt = getattr(self, f"convs1_{i}")(xt)
            xt = snake(xt, getattr(self, f"alpha2_{i}").to(x.dtype))
            xt = getattr(self, f"convs2_{i}")(xt)
            x = xt + x
        return x


class CausalF0Predictor(nn.Module):
    """Right-causal k=4 conv, then four left-causal k=3 convs, ELU after
    each, a linear head and abs. Returns (B, L)."""

    def __init__(self, in_channels: int = 80, cond_channels: int = 512):
        super().__init__()
        self.conv0 = CausalConv(in_channels, cond_channels, 4, side="right")
        for i in range(1, 5):
            setattr(self, f"conv{i}", CausalConv(cond_channels, cond_channels, 3, side="left"))
        self.classifier = nn.Linear(cond_channels, 1)

    def forward(self, x, context: torch.Tensor | None = None):
        """x (B, L, 80) mel; context: the future mel of a streaming step."""
        h = F.elu(self.conv0(x, context))
        for i in range(1, 5):
            h = F.elu(getattr(self, f"conv{i}")(h))
        return torch.abs(flax_dense(h, self.classifier, h.dtype)[..., 0])


class SourceModule(nn.Module):
    """NSF source: per-frame phase increments, cumulative phase at frame
    rate, upsampling to the sample rate, additive noise, and a linear merge
    of the harmonics. `variant` picks the reference's SineGen:

    - "sinegen2_causal" (CausalHiFT): nearest phase upsampling, the fixed
      uniform noise;
    - "sinegen2" (the v2 HiFT): linear phase upsampling, Gaussian noise;
    - "sinegen1" (the v1 HiFT at 22.05 kHz): the phase is the cumulative sum
      at the sample rate, wrapped mod 1, plus a random initial phase per
      harmonic in [-pi, pi) (0 for the fundamental); Gaussian noise.

    Streaming: `carry` (B, H) is the cumulative phase (cycles, mod 1) over
    every frame before the window, and the noise is taken from `noise_buf`
    (1, N, H) at the window's absolute sample offset, so that a window
    reproduces the whole signal's source (phase continuity and the same
    noise draws)."""

    def __init__(self, cfg: HiFTConfig, variant: str = "sinegen2_causal"):
        super().__init__()
        self.cfg = cfg
        self.variant = variant
        self.l_linear = nn.Linear(cfg.nb_harmonics + 1, 1)

    def rad_frames(self, f0_frame: torch.Tensor, first: bool = True) -> torch.Tensor:
        """(B, L) f0 -> (B, L, H) phase increments in cycles per sample.
        Frame-local (each output frame samples only inside its own frame),
        so over any window they equal the whole signal's frames there; the
        random initial phase goes on the first sample only when `first`
        (the window starts the signal)."""
        c = self.cfg
        hplus = c.nb_harmonics + 1
        harmonic_mult = torch.arange(1, hplus + 1, dtype=torch.float32, device=f0_frame.device)
        rad = torch.remainder(f0_frame[..., None] * harmonic_mult / c.sampling_rate, 1.0)
        rad_up = upsample_nearest(rad, c.total_upsample)
        if first:
            rad_up = rad_up.clone()
            rad_up[:, 0, :] += torch.from_numpy(nsf_buffers(hplus)[0][0]).to(rad_up.device)
        return downsample_linear(rad_up, c.total_upsample)

    def forward(self, f0_frame: torch.Tensor, carry: torch.Tensor | None = None,
                noise_offset: int | torch.Tensor | None = None, noise_buf: torch.Tensor | None = None) -> torch.Tensor:
        """f0_frame (B, L) -> source (B, L*upsample, 1). carry (B, H);
        noise_offset (samples: an int, or a (B,) tensor of each row's) and
        noise_buf (1, N, H) on f0's device."""
        c = self.cfg
        hplus = c.nb_harmonics + 1
        up = c.total_upsample
        n_samp = f0_frame.shape[1] * up

        f0_up = upsample_nearest(f0_frame[..., None], up)
        if self.variant == "sinegen1":
            harmonic_mult = torch.arange(1, hplus + 1, dtype=torch.float32, device=f0_frame.device)
            theta = 2.0 * np.pi * torch.remainder(torch.cumsum(f0_up * harmonic_mult / c.sampling_rate, dim=1), 1.0)
            phase_vec = (nsf_buffers(hplus)[0][0] * 2.0 - 1.0) * np.pi
            phase_vec[0] = 0.0
            sines = torch.sin(theta + torch.from_numpy(phase_vec.astype(np.float32)).to(theta.device))
        else:
            phase = torch.cumsum(self.rad_frames(f0_frame, first=carry is None), dim=1)
            if carry is not None:
                phase = phase + carry[:, None, :].to(phase.dtype)
            upsample = upsample_nearest if self.variant == "sinegen2_causal" else upsample_linear
            sines = torch.sin(upsample(phase * (2.0 * np.pi) * up, up))
        uv = (f0_up > c.nsf_voiced_threshold).to(sines.dtype)
        noise_amp = uv * c.nsf_sigma + (1.0 - uv) * c.nsf_alpha / 3.0
        if noise_buf is not None and isinstance(noise_offset, torch.Tensor) and noise_offset.dim() == 1:
            # per-row offsets (the batched streams): gather (B, n_samp, H)
            off = torch.remainder(noise_offset.long(), max(noise_buf.shape[1] - n_samp, 1))
            idx = off[:, None] + torch.arange(n_samp, device=off.device)[None, :]
            noise = noise_amp * noise_buf[0][idx].to(sines.dtype)
        elif noise_offset is not None and noise_buf is not None:
            off = int(noise_offset) % max(noise_buf.shape[1] - n_samp, 1)
            noise = noise_amp * noise_buf[:, off : off + n_samp].to(sines.dtype)
        elif self.variant == "sinegen2_causal":
            noise = noise_amp * torch.from_numpy(nsf_buffers(hplus)[1][:, :n_samp]).to(sines.device, sines.dtype)
        else:
            noise = noise_amp * torch.from_numpy(nsf_gauss_noise(n_samp, hplus)).to(sines.device, sines.dtype)
        sine_waves = sines * c.nsf_alpha * uv + noise
        return torch.tanh(flax_dense(sine_waves, self.l_linear, sines.dtype))


class CausalHiFT(nn.Module):
    def __init__(self, cfg: HiFTConfig):
        super().__init__()
        self.cfg = cfg
        self.f0_predictor = CausalF0Predictor(cfg.in_channels, cfg.f0_cond_channels)
        self.m_source = SourceModule(cfg)
        self.conv_pre = CausalConv(cfg.in_channels, cfg.base_channels, cfg.conv_pre_look_right + 1, side="right")
        down_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
        down_cum = list(np.cumprod(down_rates))[::-1]
        nfft2 = cfg.istft_n_fft + 2
        self.n_res = len(cfg.resblock_kernel_sizes)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch_in = cfg.base_channels // (2**i)
            ch_out = cfg.base_channels // (2 ** (i + 1))
            setattr(self, f"ups_{i}", CausalConvUp(ch_in, ch_out, k, u))
            du = int(down_cum[i])
            if du == 1:
                setattr(self, f"source_downs_{i}", CausalConv(nfft2, ch_out, 1, side="left"))
            else:
                setattr(self, f"source_downs_{i}", CausalConvDown(nfft2, ch_out, du * 2, du))
            setattr(self, f"source_resblocks_{i}", ResBlock(
                ch_out, cfg.source_resblock_kernel_sizes[i], cfg.source_resblock_dilation_sizes[i]))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
                setattr(self, f"resblocks_{i}_{j}", ResBlock(ch_out, rk, rd))
        self.conv_post = CausalConv(cfg.base_channels // (2 ** len(cfg.upsample_rates)), nfft2, 7, side="left")

    def decode(self, mel: torch.Tensor, source: torch.Tensor, finalize: bool = True) -> torch.Tensor:
        """mel (B, L, 80); source (B, L*480, 1) -> audio (B, L*480). A
        streaming step (finalize=False) takes the conv_pre lookahead frames
        at the end of `mel` as context and drops their audio."""
        c = self.cfg
        win = torch.from_numpy(hann_window(c.istft_n_fft)).to(mel.device)
        s_real, s_imag = stft(source[..., 0], c.istft_n_fft, c.istft_hop_len, win, center=True)
        if finalize:
            x = self.conv_pre(mel)
        else:
            trim = int(np.prod(c.upsample_rates)) * c.conv_pre_look_right
            s_real, s_imag = s_real[:, :, :-trim], s_imag[:, :, :-trim]
            x = self.conv_pre(mel[:, : -c.conv_pre_look_right], mel[:, -c.conv_pre_look_right :])
        s_stft = torch.cat([s_real, s_imag], dim=1).transpose(1, 2)  # (B, F, n_fft + 2)

        for i in range(len(c.upsample_rates)):
            x = F.leaky_relu(x, negative_slope=c.lrelu_slope)
            x = getattr(self, f"ups_{i}")(x)
            if i == len(c.upsample_rates) - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)  # ReflectionPad1d((1, 0))
            si = getattr(self, f"source_resblocks_{i}")(getattr(self, f"source_downs_{i}")(s_stft))
            x = x + si
            xs = None
            for j in range(self.n_res):
                r = getattr(self, f"resblocks_{i}_{j}")(x)
                xs = r if xs is None else xs + r
            x = xs / self.n_res

        x = self.conv_post(F.leaky_relu(x, negative_slope=0.01))
        nbins = c.istft_n_fft // 2 + 1
        magnitude = torch.clamp(torch.exp(x[..., :nbins].transpose(1, 2)), max=1e2)
        phase = torch.sin(x[..., nbins:]).transpose(1, 2)
        audio = istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase), c.istft_n_fft, c.istft_hop_len, win)
        if not finalize:
            audio = audio[:, : -int(np.prod(c.upsample_rates)) * c.istft_hop_len]
        return torch.clamp(audio, -c.audio_limit, c.audio_limit)

    def forward(self, mel: torch.Tensor, finalize: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """mel (B, L, 80) -> (audio (B, ~L*480), source). The f0 predictor
        runs on a float32 copy of the mel; the source is cast back to the
        mel's dtype. A streaming step (finalize=False) takes the last 3 mel
        frames as the f0 predictor's lookahead and decodes the rest."""
        mel32 = mel.float()
        if finalize:
            s = self.m_source(self.f0_predictor(mel32)).to(mel.dtype)
            return self.decode(mel, s), s
        pad = CausalConv.causal_padding(4)  # 3
        s = self.m_source(self.f0_predictor(mel32[:, :-pad], context=mel32[:, -pad:])).to(mel.dtype)
        return self.decode(mel[:, :-pad], s, finalize=False), s

    def forward_train(self, mel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The GAN-training forward: mel (B, L, 80) -> (audio (B, L*480), f0
        (B, L)). The f0 predictor runs in float32; the source is built on
        its f0 with nothing detached between them, so the generator's
        gradient also flows through the sine phases (as in the JAX package;
        the reference's SineGen runs under no_grad)."""
        f0 = self.f0_predictor(mel.float())
        s = self.m_source(f0).to(mel.dtype)
        return self.decode(mel, s, finalize=True), f0

    # ---- constant-cost windowed streaming -----------------------------------
    # Each convolution here is causal with a small receptive field, so a
    # window ending at the stream head, with its source phase carried in and
    # its noise taken at its absolute sample offset, gives the same samples
    # as vocoding the whole mel (infer/stream.py VocStream).

    def stream_window(self, mel: torch.Tensor, carry: torch.Tensor, noise_offset: int | torch.Tensor,
                      noise_buf: torch.Tensor) -> torch.Tensor:
        """Streaming step on a window mel (B, W, 80) ending at the stream
        head: audio for its frames [0, W-8). carry (B, H): cumulative phase
        over [0, window start); noise_offset = window start * 480 (an int,
        or (B,) for rows at different offsets)."""
        pad = CausalConv.causal_padding(4)  # 3
        mel32 = mel.float()
        f0 = self.f0_predictor(mel32[:, :-pad], context=mel32[:, -pad:])
        s = self.m_source(f0, carry=carry, noise_offset=noise_offset, noise_buf=noise_buf).to(mel.dtype)
        return self.decode(mel[:, :-pad], s, finalize=False)

    def finalize_window(self, mel: torch.Tensor, n_valid: int | torch.Tensor, carry: torch.Tensor,
                        noise_offset: int | torch.Tensor, noise_buf: torch.Tensor) -> torch.Tensor:
        """Last window: mel (B, W, 80), zeroed past n_valid frames, with
        finalize semantics (no lookahead). n_valid and noise_offset are ints,
        or (B,) tensors of each row's. Returns audio (B, W*480); the caller
        keeps [.., n_valid*480)."""
        w = mel.shape[1]
        if isinstance(n_valid, torch.Tensor):
            n_valid = n_valid.reshape(-1, 1, 1)
        mel = mel * (torch.arange(w, device=mel.device)[None, :, None] < n_valid).to(mel.dtype)
        f0 = self.f0_predictor(mel.float())
        s = self.m_source(f0, carry=carry, noise_offset=noise_offset, noise_buf=noise_buf).to(mel.dtype)
        return self.decode(mel, s)

    def rad_delta(self, mel_ctx: torch.Tensor, n_left: int) -> torch.Tensor:
        """The source phase advance (B, H) over the frames
        mel_ctx[:, n_left:-3]: n_left frames of left context for the f0
        predictor (8, its receptive field; 0 at the start of the signal) and
        3 of right context. Advances the streaming carry."""
        pad = CausalConv.causal_padding(4)  # 3
        mel32 = mel_ctx.float()
        f0 = self.f0_predictor(mel32[:, :-pad], context=mel32[:, -pad:])
        return self.m_source.rad_frames(f0[:, n_left:], first=n_left == 0).sum(dim=1)



class F0Predictor(nn.Module):
    """Non-causal ConvRNNF0Predictor: five k=3 symmetric convs with ELU, a
    linear head and abs. Returns (B, L)."""

    def __init__(self, in_channels: int = 80, cond_channels: int = 512):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i}", PlainConv(in_channels if i == 0 else cond_channels, cond_channels, 3))
        self.classifier = nn.Linear(cond_channels, 1)

    def forward(self, x):
        h = x
        for i in range(5):
            h = F.elu(getattr(self, f"conv{i}")(h))
        return torch.abs(flax_dense(h, self.classifier, h.dtype)[..., 0])


class HiFT(nn.Module):
    """Non-causal HiFTGenerator, the CosyVoice1/2 vocoder: conv_pre k7,
    transposed-convolution upsampling, reflection pad at the last stage,
    symmetric ResBlocks, the sinegen1 (22.05 kHz) or sinegen2 source and
    the iSTFT. forward(mel, cache_source, noise_offset, noise_buf): the
    caller's source cache replaces the first source samples (phase
    continuity across streaming chunks) and the noise comes from noise_buf
    at the chunk's absolute sample offset."""

    def __init__(self, cfg: HiFTConfig):
        super().__init__()
        self.cfg = cfg
        self.f0_predictor = F0Predictor(cfg.in_channels, cfg.f0_cond_channels)
        self.m_source = SourceModule(cfg, variant="sinegen1" if cfg.sampling_rate == 22050 else "sinegen2")
        self.conv_pre = PlainConv(cfg.in_channels, cfg.base_channels, 7)
        down_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
        down_cum = list(np.cumprod(down_rates))[::-1]
        nfft2 = cfg.istft_n_fft + 2
        self.n_res = len(cfg.resblock_kernel_sizes)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch_in = cfg.base_channels // (2**i)
            ch_out = cfg.base_channels // (2 ** (i + 1))
            setattr(self, f"ups_{i}", tconv_params(ch_in, ch_out, k))
            du = int(down_cum[i])
            setattr(self, f"source_downs_{i}", PlainConv(nfft2, ch_out, 1) if du == 1 else
                    PlainConv(nfft2, ch_out, du * 2, stride=du, pad=du // 2))
            setattr(self, f"source_resblocks_{i}", ResBlock(
                ch_out, cfg.source_resblock_kernel_sizes[i], cfg.source_resblock_dilation_sizes[i], causal=False))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
                setattr(self, f"resblocks_{i}_{j}", ResBlock(ch_out, rk, rd, causal=False))
        self.conv_post = PlainConv(cfg.base_channels // (2 ** len(cfg.upsample_rates)), nfft2, 7)

    def forward(self, mel: torch.Tensor, cache_source: torch.Tensor | None = None,
                noise_offset: int | torch.Tensor | None = None,
                noise_buf: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """mel (B, L, 80) -> (audio (B, L*hop), source (B, L*hop, 1)). The f0
        predictor runs on a float32 copy of the mel; cache_source (B, Lc, 1)
        replaces the first Lc source samples."""
        f0 = self.f0_predictor(mel.float())
        s = self.m_source(f0, noise_offset=noise_offset, noise_buf=noise_buf).to(mel.dtype)
        if cache_source is not None and cache_source.shape[1] > 0:
            lc = cache_source.shape[1]
            s = torch.cat([cache_source.to(s.dtype), s[:, lc:]], dim=1)
        return self.decode(mel, s), s

    def decode(self, mel: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """mel + NSF source -> waveform (B, L*hop)."""
        c = self.cfg
        win = torch.from_numpy(hann_window(c.istft_n_fft)).to(mel.device)
        s_real, s_imag = stft(s[..., 0], c.istft_n_fft, c.istft_hop_len, win, center=True)
        s_stft = torch.cat([s_real, s_imag], dim=1).transpose(1, 2)

        x = self.conv_pre(mel)
        n_up = len(c.upsample_rates)
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            x = F.leaky_relu(x, negative_slope=c.lrelu_slope)
            up = getattr(self, f"ups_{i}")
            x = conv_transpose1d(x, up.weight.to(x.dtype), up.bias.to(x.dtype), stride=u, padding=(k - u) // 2)
            if i == n_up - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)  # ReflectionPad1d((1, 0))
            si = getattr(self, f"source_resblocks_{i}")(getattr(self, f"source_downs_{i}")(s_stft))
            n = min(x.shape[1], si.shape[1])
            x = x[:, :n] + si[:, :n]
            xs = None
            for j in range(self.n_res):
                r = getattr(self, f"resblocks_{i}_{j}")(x)
                xs = r if xs is None else xs + r
            x = xs / self.n_res

        x = self.conv_post(F.leaky_relu(x, negative_slope=0.01))
        nbins = c.istft_n_fft // 2 + 1
        magnitude = torch.clamp(torch.exp(x[..., :nbins].transpose(1, 2)), max=1e2)
        phase = torch.sin(x[..., nbins:]).transpose(1, 2)
        audio = istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase), c.istft_n_fft, c.istft_hop_len, win)
        return torch.clamp(audio, -c.audio_limit, c.audio_limit)
