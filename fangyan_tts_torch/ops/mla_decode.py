"""Decode-step latent attention (MLA, absorbed form) on the stacked latent
cache, with the row write.

Kernel: csrc/mla_decode_triton.py (Triton), which replaces no TPU kernel:
the JAX package has no latent attention. It was added for the MLA-MoE
speech LM (models/mla_moe.py), where one 576-wide latent row a slot (the
normed latent c_t, 512, and the rotated shared rope key, 64) serves all
16 query heads, which csrc/decode_attention.cu (64-wide heads, query
groups of at most 8) cannot take. A call reads each open slot's row once
for the 16 heads, so it is bound by the cache's bytes (16 x 1,088
products a slot against 1,152 bytes); the design spreads the slots over
enough programs to keep the card's memory busy:

- `fangyan_mla_decode_split`: one program per (row, split of the slots),
  `plan` choosing splits of at least MIN_RUN slots. It loads the row's 16
  query heads once, walks its slots in tiles of BS, and keeps an online
  float32 softmax: scores from the latent and rope parts (tensor cores,
  float32 sums), the bias added after the 1/sqrt(192) scale, the
  probabilities in bf16 times the latent tile. A slot the bias masks is
  never read.
- `fangyan_mla_decode_merge`: one program per row rescales the splits'
  partial sums by their maxima and writes the (16, 512) latent output.

`mla_decode` writes the new row into the cache (in place, as
decode_attention does), then launches both kernels for CUDA tensors
(bfloat16 only; it raises on anything else) or runs `mla_decode_plain`
for CPU tensors; there is no fallback from one to the other. Each launch
counts as `mla_decode` in ops/device.launches.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .device import launched, refuse_grad

BS = 32  # slots of one tile
MIN_RUN = 64  # slots a split takes at least, where S allows
MAX_SPLITS = 16


def write_row(kv_new, cache, idx, layer: int) -> None:
    """The new slot rows (B, D) into cache[layer] at idx (clamped to S - 1)."""
    _, b, s, _ = cache.shape
    rows = torch.arange(b, device=cache.device)
    cache[layer, rows, torch.clamp(idx.to(torch.int64).reshape(-1).expand(b), 0, s - 1)] = kv_new.to(cache.dtype)


def mla_decode_plain(q, kv_new, cache, idx, bias, layer: int, scale: float, latent: int) -> torch.Tensor:
    """Plain PyTorch version. q (B, H, D) with D = latent + rope (the
    absorbed query); kv_new (B, D); cache (L, B, S, D), updated in place;
    idx (B,) int32 write slots; bias (B, S) float32. Scores in float32 (q . slot row) x scale + bias, softmax in
    float32, the probabilities in q's dtype times the slots' latents.
    Returns (B, H, latent)."""
    write_row(kv_new, cache, idx, layer)
    kv = cache[layer].to(q.dtype)
    scores = torch.einsum("bhd,bsd->bhs", q.float(), kv.float()) * scale + bias.float()[:, None, :]
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bsc->bhc", p, kv[..., :latent])


@functools.lru_cache(maxsize=256)
def plan(b: int, s: int) -> tuple[int, int]:
    """(splits n, a power of two, and slots a split per, a multiple of BS):
    runs of at least MIN_RUN slots where S allows, up to MAX_SPLITS."""
    n = 1
    while n < MAX_SPLITS and s // (2 * n) >= MIN_RUN:
        n *= 2
    per = -(-(-(-s // n)) // BS) * BS
    return n, per


def _check(q, kv_new, cache, idx, bias, layer, latent):
    dev = q.device
    if any(t.device != dev for t in (kv_new, cache, idx, bias)):
        raise ValueError("mla_decode: every tensor must be on q's device")
    if not (q.dtype == kv_new.dtype == cache.dtype == torch.bfloat16 and idx.dtype == torch.int32
            and bias.dtype == torch.float32):
        raise ValueError("mla_decode: q, kv_new and the cache must be bfloat16, idx int32, bias float32")
    if cache.dim() != 4:
        raise ValueError("mla_decode: the cache must be (L, B, S, D)")
    nl, b, s, d = cache.shape
    if d != 576 or latent != 512 or q.shape != (b, 16, d) or kv_new.shape != (b, d):
        raise ValueError(f"mla_decode: unsupported q {tuple(q.shape)} / kv_new {tuple(kv_new.shape)} for cache "
                         f"{tuple(cache.shape)} (the kernel takes 16 heads over slot rows of 512 + 64)")
    if idx.shape != (b,) or bias.shape != (b, s):
        raise ValueError("mla_decode: idx must be (B,) and bias (B, S)")
    if not all(t.is_contiguous() for t in (q, cache, bias, idx)):
        raise ValueError("mla_decode: q, the cache, idx and bias must be contiguous")
    if not 0 <= layer < nl:
        raise ValueError(f"mla_decode: layer {layer} outside [0, {nl})")


def mla_decode(q, kv_new, cache, idx, bias, layer: int, scale: float, latent: int) -> torch.Tensor:
    """One decode step of latent attention: writes kv_new into the cache in
    place and returns (B, H, latent). CPU tensors take the plain version;
    CUDA tensors launch the two Triton kernels or raise (also when an input
    requires grad: the kernels have no backward)."""
    if q.device.type == "cpu":
        return mla_decode_plain(q, kv_new, cache, idx, bias, layer, scale, latent)
    if q.device.type != "cuda":
        raise ValueError(f"mla_decode: unsupported device {q.device}")
    refuse_grad("mla_decode", "the cache-free forward (MLAMoEModel with cache=None)", q, kv_new)
    layer = int(layer)
    _check(q, kv_new, cache, idx, bias, layer, latent)
    nl, b, s, d = cache.shape
    h = q.shape[1]
    write_row(kv_new, cache, idx, layer)
    n, per = plan(b, s)
    part = torch.empty((b, n, h, latent), dtype=torch.float32, device=q.device)
    stats = torch.empty((b, n, 2, h), dtype=torch.float32, device=q.device)
    out = torch.empty((b, h, latent), dtype=q.dtype, device=q.device)
    ker = _build.triton("mla_decode")
    # the layer's (B, S, D) view: its offset is no argument, so no layer compiles a kernel of its own
    ker.fangyan_mla_decode_split[(b, n)](q, cache[layer], bias, part, stats, s, per, float(scale),
                                         H=h, DC=latent, DR=d - latent, BS=BS, num_warps=4, num_stages=2)
    launched("mla_decode")
    ker.fangyan_mla_decode_merge[(b,)](part, stats, out, H=h, DC=latent, NSPLIT=n, num_warps=4)
    launched("mla_decode")
    return out
