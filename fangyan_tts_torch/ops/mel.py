"""Mel-spectrogram frontends (fangyan_tts_tpu/ops/mel.py).

Three feature extractors, each with the filterbank convention of the model
it feeds:

1. `matcha_mel`: the 24 kHz 80-mel acoustic feature (slaney filters, reflect
   pre-pad of (n_fft - hop)/2, center=False, log(clamp 1e-5)).
2. `whisper_logmel`: the 16 kHz 128-mel input of the S3 speech tokenizer
   (power spectrum, last frame dropped, log10 with a per-row max - 8 floor,
   (x + 4) / 4).
3. `kaldi_fbank`: the 16 kHz 80-mel input of CAM++ (povey window, HTK mel
   scale, snip_edges, dither 0).

All take (B, T) float32 waveforms and run on the device of their input, on
the DFT bases of ops/stft.py. The products are float32; on the card the
caller turns TF32 off (ops/device.exact_fp32), as the JAX package pins
Precision.HIGHEST.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .stft import _basis, _dft_bases, frame_signal, hann_window, povey_window, stft


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    log_region = f >= 1000.0
    mel = np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), mel)
    return mel


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
    return f


@functools.lru_cache(maxsize=None)
def mel_filterbank_slaney(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """librosa.filters.mel (htk=False, norm='slaney'): (n_mels, n_fft//2 + 1)
    float32."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank_kaldi(
    sr: int,
    padded_window_size: int,
    n_mels: int,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi mel banks (torchaudio.compliance.kaldi.get_mel_banks):
    (n_mels, padded_window_size//2) float32, without the Nyquist bin."""
    if high_freq <= 0.0:
        high_freq = sr / 2.0 + high_freq
    num_fft_bins = padded_window_size // 2
    fft_bin_width = sr / padded_window_size
    mel_low = _hz_to_mel_htk(low_freq)
    mel_high = _hz_to_mel_htk(high_freq)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)
    bins = np.arange(n_mels)[:, None]
    left_mel = mel_low + bins * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta
    mel = _hz_to_mel_htk(fft_bin_width * np.arange(num_fft_bins))[None, :]
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    weights = np.maximum(0.0, np.minimum(up_slope, down_slope))
    return weights.astype(np.float32)


def matcha_mel(
    y: torch.Tensor,
    n_fft: int = 1920,
    num_mels: int = 80,
    sampling_rate: int = 24000,
    hop_size: int = 480,
    win_size: int = 1920,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> torch.Tensor:
    """24 kHz training mel. y: (B, T) -> (B, num_mels, T//hop_size)."""
    pad = (n_fft - hop_size) // 2
    y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    real, imag = stft(y, n_fft, hop_size, _basis(hann_window(win_size), y), center=False)
    spec = torch.sqrt(real * real + imag * imag + 1e-9)
    fb = _basis(mel_filterbank_slaney(sampling_rate, n_fft, num_mels, fmin, fmax), spec)
    mel = torch.einsum("mk,bkf->bmf", fb, spec)
    return torch.log(mel.clamp(min=1e-5))


def whisper_logmel(
    y: torch.Tensor,
    n_mels: int = 128,
    n_fft: int = 400,
    hop: int = 160,
    sampling_rate: int = 16000,
) -> torch.Tensor:
    """Whisper log-mel for the S3 tokenizer. y: (B, T) -> (B, n_mels, T//hop).
    The max - 8 floor is per batch row, taken over the whole (padded) row."""
    real, imag = stft(y, n_fft, hop, _basis(hann_window(n_fft), y), center=True)
    power = (real * real + imag * imag)[..., :-1]  # drop the last frame, as whisper does
    fb = _basis(mel_filterbank_slaney(sampling_rate, n_fft, n_mels), power)
    mel = torch.einsum("mk,bkf->bmf", fb, power)
    log_spec = torch.log10(mel.clamp(min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    return (log_spec + 4.0) / 4.0


def kaldi_fbank(
    y: torch.Tensor,
    num_mel_bins: int = 80,
    sampling_rate: int = 16000,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
    low_freq: float = 20.0,
    subtract_mean: bool = False,
) -> torch.Tensor:
    """Kaldi fbank (dither 0) for CAM++: snip_edges, DC offset removed,
    pre-emphasis with the first sample duplicated, povey window, zero-pad to
    the next power of two, power spectrum without the Nyquist bin, HTK mel,
    log(max(eps)). y: (B, T) -> (B, frames, num_mel_bins)."""
    win = int(sampling_rate * frame_length_ms / 1000.0)  # 400
    hop = int(sampling_rate * frame_shift_ms / 1000.0)  # 160
    padded = 1 << (win - 1).bit_length()  # 512

    # the framing and the DFT in float64, the power float32 again: the low
    # mel bins of speech hold a millionth of a frame's energy after the
    # pre-emphasis, and the rounding of a float32 product (its order differs
    # between BLAS libraries) moves their log by more than 1e-4
    frames = frame_signal(y.double(), win, hop)  # (B, F, win)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - preemphasis * shifted
    frames = frames * _basis(povey_window(win), frames)[None, None, :]
    frames = F.pad(frames, (0, padded - win))

    cos_b, sin_b = _dft_bases(padded)
    real = torch.einsum("bfn,nk->bfk", frames, _basis(cos_b, frames).double())
    imag = torch.einsum("bfn,nk->bfk", frames, _basis(sin_b, frames).double())
    power = (real * real + imag * imag).float()  # (B, F, padded//2+1)

    fb = _basis(mel_filterbank_kaldi(sampling_rate, padded, num_mel_bins, low_freq), power)
    mel = torch.einsum("mk,bfk->bfm", fb, power[..., :-1])
    eps = float(np.finfo(np.float32).eps)
    out = torch.log(mel.clamp(min=eps))
    if subtract_mean:
        out = out - out.mean(dim=1, keepdim=True)
    return out
