"""Encoder input layers: subsampling and positional-encoding variants
(fangyan_tts_tpu/models/subsampling.py, after the reference's
cosyvoice/transformer/subsampling.py:35-383 and embedding.py:26-199).

The modules carry the reference's torch parameter names (`embed`, `conv.0`,
`conv.2`, `conv.4`, `out.0` for the x4 variant, `linear` for x6 / x8,
`pos_enc.pe` for the learnable encoding), so that a reference state dict
loads as it is and the converters below give the JAX package's trees.
Inputs and outputs are channels-last (B, T, F) as in both packages; the
convolutions run in torch's channels-first layout inside. Nothing in either
package calls these layers (the shipped CosyVoice configs use the linear
input layers of models/conformer.py); they complete the wenet encoder
surface for ASR-style frontends.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def sincos_pos_table(max_len: int, d_model: int) -> np.ndarray:
    """(1, max_len, d): interleaved sin/cos absolute table (embedding.py:49-56)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe[None].astype(np.float32)


@functools.lru_cache(maxsize=None)
def whisper_pos_table(max_len: int, d_model: int) -> np.ndarray:
    """(1, max_len, d): whisper layout, all sins then all coss
    (embedding.py:155-165)."""
    inc = np.log(10000.0) / (d_model // 2 - 1)
    inv = np.exp(-inc * np.arange(d_model // 2, dtype=np.float64))
    t = np.arange(max_len, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1)[None].astype(np.float32)


class PosEnc(nn.Module):
    """Positional encoding by kind: 'abs' (PositionalEncoding: scales x by
    sqrt(d), adds pe, returns pe), 'rel' (RelPositionalEncoding: scales x,
    returns the pe slice), 'whisper' (adds pe, no scale), 'learnable' (the
    whisper decoder's parameter `pe`), 'none' (zeros). Returns (x, pos)."""

    def __init__(self, d_model: int, kind: str = "abs", max_len: int = 5000):
        super().__init__()
        self.d_model, self.kind, self.max_len = d_model, kind, max_len
        if kind == "learnable":
            self.pe = nn.Parameter(torch.zeros(1, max_len, d_model))

    def forward(self, x: torch.Tensor, offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        t = x.shape[1]
        if self.kind == "none":
            return x, torch.zeros((1, t, self.d_model), dtype=x.dtype, device=x.device)
        if self.kind == "learnable":
            pos = self.pe[:, offset : offset + t].to(x.dtype)
            return x + pos, pos
        table = whisper_pos_table if self.kind == "whisper" else sincos_pos_table
        pos = torch.from_numpy(table(self.max_len, self.d_model)[:, offset : offset + t]).to(x.device, x.dtype)
        if self.kind == "whisper":
            return x + pos, pos
        x = x * math.sqrt(self.d_model)
        if self.kind == "abs":
            return x + pos, pos
        return x, pos  # 'rel': scale only, the slice goes to the attention


class EmbeddingNoSubsampling(nn.Module):
    """EmbedinigNoSubsampling (subsampling.py:35-66): token ids (B, T)."""

    def __init__(self, idim: int, odim: int, pos_kind: str = "abs"):
        super().__init__()
        self.embed = nn.Embedding(idim, odim)
        self.pos_enc = PosEnc(odim, pos_kind)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, offset: int = 0):
        h, pos = self.pos_enc(self.embed(x), offset)
        return h, pos, x_mask


class Conv1dSubsampling2(nn.Module):
    """Whisper-style 1D subsampler to 1/2 length (subsampling.py:116-170):
    conv k3 p1 + GELU, conv k3 s2 p1 + GELU."""

    subsampling_rate = 2
    right_context = 4

    def __init__(self, idim: int, odim: int, pos_kind: str = "abs"):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv1d(idim, odim, 3, padding=1), nn.GELU(),
                                  nn.Conv1d(odim, odim, 3, stride=2, padding=1), nn.GELU())
        self.pos_enc = PosEnc(odim, pos_kind)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, offset: int = 0):
        t = x.shape[1]
        h = self.conv(x.transpose(1, 2)).transpose(1, 2)
        h, pos = self.pos_enc(h, offset)
        return h, pos, x_mask[:, :, (t + 1) % 2 :: 2]


class _Conv2dSubsampling(nn.Module):
    """The conv2d pyramid of Conv2dSubsampling4/6/8: (kernel, stride) per
    layer over a (B, 1, T, F) input, no padding, ReLU; the output flattens
    (channels, freq) in that order, then a linear layer."""

    out_name = "linear"
    specs: tuple = ()
    mask_cuts: tuple = ()  # (start, step) of each layer's cut of the mask

    def __init__(self, idim: int, odim: int, pos_kind: str = "abs"):
        super().__init__()
        layers, cin, f = [], 1, idim
        for k, s in self.specs:
            layers += [nn.Conv2d(cin, odim, k, s), nn.ReLU()]
            cin, f = odim, (f - k) // s + 1
        self.conv = nn.Sequential(*layers)
        lin = nn.Linear(odim * f, odim)
        setattr(self, self.out_name, nn.Sequential(lin) if self.out_name == "out" else lin)
        self.pos_enc = PosEnc(odim, pos_kind)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, offset: int = 0):
        h = self.conv(x[:, None])  # (B, C, T', F')
        b, c, t, f = h.shape
        h = getattr(self, self.out_name)(h.transpose(1, 2).reshape(b, t, c * f))
        h, pos = self.pos_enc(h, offset)
        for start, step in self.mask_cuts:
            x_mask = x_mask[:, :, start::step]
        return h, pos, x_mask


class Conv2dSubsampling4(_Conv2dSubsampling):
    """2D conv subsampler to 1/4 length (subsampling.py:173-228)."""

    subsampling_rate, right_context, out_name = 4, 6, "out"
    specs, mask_cuts = ((3, 2), (3, 2)), ((2, 2), (2, 2))


class Conv2dSubsampling6(_Conv2dSubsampling):
    """2D conv subsampler to 1/6 length (subsampling.py:230-280): k3 s2, then k5 s3."""

    subsampling_rate, right_context = 6, 10
    specs, mask_cuts = ((3, 2), (5, 3)), ((2, 2), (4, 3))


class Conv2dSubsampling8(_Conv2dSubsampling):
    """2D conv subsampler to 1/8 length (subsampling.py:282-336)."""

    subsampling_rate, right_context = 8, 14
    specs, mask_cuts = ((3, 2), (3, 2), (3, 2)), ((2, 2), (2, 2), (2, 2))


# ---------------------------------------------------------------------------
# converters: a reference state dict -> the JAX package's parameter trees
# ---------------------------------------------------------------------------


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _conv2d_w(sd, base) -> dict:
    # torch (out, in, kh, kw) -> flax (kh, kw, in, out)
    return {"kernel": _t(sd[base + ".weight"]).transpose(2, 3, 1, 0), "bias": _t(sd[base + ".bias"])}


def _conv1d_w(sd, base) -> dict:
    # torch (out, in, k) -> flax (k, in, out)
    return {"kernel": _t(sd[base + ".weight"]).transpose(2, 1, 0), "bias": _t(sd[base + ".bias"])}


def _lin(sd, base) -> dict:
    return {"kernel": _t(sd[base + ".weight"]).T, "bias": _t(sd[base + ".bias"])}


def conv2d_subsampling_params_from_reference(sd, n_convs: int, out_name: str = "linear") -> dict:
    """Conv2dSubsampling4/6/8 state_dict -> the JAX package's params (n_convs
    = 2, 2, 3; out_name 'out' for the x4 variant, 'linear' for x6 / x8)."""
    p = {"conv": {f"conv{i}": _conv2d_w(sd, f"conv.{2 * i}") for i in range(n_convs)}}
    p[out_name] = _lin(sd, out_name + (".0" if out_name == "out" else ""))
    return p


def conv1d_subsampling2_params_from_reference(sd) -> dict:
    return {"conv0": _conv1d_w(sd, "conv.0"), "conv1": _conv1d_w(sd, "conv.2")}
