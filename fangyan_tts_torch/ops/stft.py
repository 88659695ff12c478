"""STFT / iSTFT as framing plus DFT matmuls (fangyan_tts_tpu/ops/stft.py).

The matmul form, not `torch.stft`, so that the numbers follow the JAX
package's. The bases are float32 and the products run in full float32:
on the card the caller turns TF32 off (ops/device.exact_fp32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, -sin) real-DFT bases, each (n_fft, n_fft//2+1) float32."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _idft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse real-DFT bases (n_fft//2+1, n_fft) with the hermitian weights
    w_k = 1 at k in {0, N/2}, else 2, and the 1/N factor folded in."""
    nbins = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(nbins)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    w = np.full((nbins, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    return (w * np.cos(ang) / n_fft).astype(np.float32), (-w * np.sin(ang) / n_fft).astype(np.float32)


def _basis(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr).to(like.device)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, 1 + (T - frame_length)//hop, frame_length)."""
    return x.unfold(-1, frame_length, hop)


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop: int,
    window: torch.Tensor,
    center: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Real STFT of (B, T). Returns (real, imag), each (B, n_fft//2+1, frames).
    center=True reflect-pads n_fft//2 on both sides."""
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = frame_signal(x, n_fft, hop) * window[None, None, :]
    cos_b, sin_b = _dft_bases(n_fft)
    real = torch.einsum("bfn,nk->bkf", frames, _basis(cos_b, frames).to(frames.dtype))
    imag = torch.einsum("bfn,nk->bkf", frames, _basis(sin_b, frames).to(frames.dtype))
    return real, imag


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, F, n_fft) -> (B, (F-1)*hop + n_fft), adding hop-sized strips in
    the same order as the JAX helper."""
    b, f, n_fft = frames.shape
    assert n_fft % hop == 0, "overlap_add requires hop | n_fft"
    k_strips = n_fft // hop
    strips = frames.reshape(b, f, k_strips, hop)
    out = torch.zeros((b, f + k_strips - 1, hop), dtype=frames.dtype, device=frames.device)
    for k in range(k_strips):
        out[:, k : k + f, :] += strips[:, :, k, :]
    return out.reshape(b, (f + k_strips - 1) * hop)


def istft(
    real: torch.Tensor,
    imag: torch.Tensor,
    n_fft: int,
    hop: int,
    window: torch.Tensor,
) -> torch.Tensor:
    """Inverse STFT with torch.istft(center=True) semantics.
    real/imag: (B, n_fft//2+1, F). Returns (B, (F-1)*hop) samples."""
    cos_b, sin_b = _idft_bases(n_fft)
    frames = torch.einsum("bkf,kn->bfn", real, _basis(cos_b, real).to(real.dtype)) + torch.einsum(
        "bkf,kn->bfn", imag, _basis(sin_b, imag).to(imag.dtype)
    )
    frames = frames * window[None, None, :]
    y = overlap_add(frames, hop)
    f = frames.shape[1]
    env = overlap_add((window * window)[None, None, :].expand(1, f, n_fft), hop)
    y = y / env.clamp_min(1e-11)
    half = n_fft // 2
    return y[:, half : y.shape[1] - half]


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann (== torch.hann_window(N)), float32 numpy."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def povey_window(win_length: int) -> np.ndarray:
    """Kaldi's povey window, hann(periodic over N-1) ** 0.85, float32 numpy."""
    n = np.arange(win_length)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))
    return (hann**0.85).astype(np.float32)


def magnitude(real: torch.Tensor, imag: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return torch.sqrt(real * real + imag * imag + eps)
